"""Roofline terms of a cell's step, and the model's own FLOP count.

Port of :mod:`repro.launch.roofline`.  Three terms per (arch x shape) on
the single-pod mesh, each over one card's peak (:mod:`.mesh`, one H100):

    compute    = FLOPs a device / PEAK_FLOPS_BF16
    memory     = bytes a device / HBM_BW
    collective = wire bytes a device / NVLINK_BW

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of the
compiled, partitioned program and its collectives from the HLO text
(``cost_from_compiled``).  PyTorch has no HLO, so that function has no
counterpart here: :mod:`repro_torch.launch.dryrun` runs the cell's step
on ``meta`` tensors and counts FLOPs with ``FlopCounterMode`` and bytes
with a dispatch mode over the aten operations (each kernel's plain version
counted as the kernel's inputs and outputs), and builds a
:class:`CellCost` from them.  Collectives are records
(:class:`Collective`: kind, dtype, local shape, group size, the fields the
reference's regex reads off each HLO line), priced by
:func:`collective_wire_bytes` with the reference's ring factors:
all-reduce 2 (n - 1) / n b, all-gather (n - 1) / n b_full, reduce-scatter
(n - 1) b_shard, all-to-all (n - 1) / n b, collective-permute b.

:func:`model_flops` (the "useful" numerator) is the reference's
accounting, quirks included: 6 N_active T for training (2 for
inference) plus the attention and SSD terms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, NamedTuple, Tuple

import torch

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.config import SHAPE_SPECS, ModelConfig

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


class Collective(NamedTuple):
    """One collective of a step: ``kind`` (one of :data:`KINDS`), the
    ``dtype`` and the local (per-device) ``shape`` of its output, and the
    size of its device ``group``."""
    kind: str
    dtype: torch.dtype
    shape: Tuple[int, ...]
    group: int


def collective_wire_bytes(records: Iterable[Collective]) -> Dict[str, float]:
    """Per-device wire bytes by collective kind, ring-algorithm model."""
    out: Dict[str, float] = {k: 0.0 for k in KINDS}
    for kind, dtype, shape, group in records:
        b = dtype.itemsize
        for d in shape:
            b *= d  # local (per-device) output bytes
        n = max(group, 2)
        if kind == "all-reduce":
            wire = 2.0 * (n - 1) / n * b
        elif kind == "all-gather":
            wire = (n - 1) / n * b  # b is the gathered (full) output
        elif kind == "reduce-scatter":
            wire = (n - 1) * b  # b is the scattered (shard) output
        elif kind == "all-to-all":
            wire = (n - 1) / n * b
        elif kind == "collective-permute":
            wire = float(b)
        else:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] += wire
    return out


@dataclass
class CellCost:
    flops: float
    bytes_accessed: float
    coll_bytes: Dict[str, float]

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())

    def __sub__(self, o: "CellCost") -> "CellCost":
        return CellCost(
            self.flops - o.flops, self.bytes_accessed - o.bytes_accessed,
            {k: self.coll_bytes[k] - o.coll_bytes.get(k, 0.0)
             for k in self.coll_bytes})

    def scaled(self, f: float) -> "CellCost":
        return CellCost(self.flops * f, self.bytes_accessed * f,
                        {k: v * f for k, v in self.coll_bytes.items()})

    def __add__(self, o: "CellCost") -> "CellCost":
        keys = set(self.coll_bytes) | set(o.coll_bytes)
        return CellCost(
            self.flops + o.flops, self.bytes_accessed + o.bytes_accessed,
            {k: self.coll_bytes.get(k, 0.0) + o.coll_bytes.get(k, 0.0)
             for k in keys})


def extrapolate(cost_l2: CellCost, cost_l4: CellCost,
                num_layers: int) -> CellCost:
    """The cost at ``num_layers`` from the costs at 2 and 4 layers."""
    per_layer = (cost_l4 - cost_l2).scaled(0.5)
    base = cost_l2 - per_layer.scaled(2.0)
    return base + per_layer.scaled(float(num_layers))


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS
# ---------------------------------------------------------------------------
def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    seq, gbatch, kind = SHAPE_SPECS[shape_name]
    return model_flops_for(cfg, seq, gbatch, kind)


def model_flops_for(cfg: ModelConfig, seq: int, gbatch: int,
                    kind: str) -> float:
    """:func:`model_flops` of ``gbatch`` sequences of ``seq`` tokens in a
    ``kind`` ("train", "prefill" or "decode") step."""
    n_active = cfg.active_param_count()
    Lc, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    mult = 6.0 if kind == "train" else 2.0

    if kind == "decode":
        toks = float(gbatch)
        flops = mult * n_active * toks
        if cfg.uses_attention:
            for k in cfg.layer_kinds():
                w = cfg.window_for_kind(k)
                ctx = min(seq, w) if w else seq
                flops += 4.0 * H * hd * ctx * toks
        if cfg.uses_ssm:
            di = cfg.d_model if cfg.family == "hybrid" else cfg.ssm_d_inner
            nh = di // cfg.ssm_head_dim
            flops += Lc * toks * 6.0 * nh * cfg.ssm_head_dim * cfg.ssm_state
        return flops

    toks = float(gbatch) * seq
    flops = mult * n_active * toks
    if cfg.uses_attention:
        attn_mult = 12.0 if kind == "train" else 4.0  # fwd(+bwd), qk+pv
        for k in cfg.layer_kinds():
            w = cfg.window_for_kind(k)
            eff = min(seq, w) if w else seq
            # causal: average context length ~ eff/2 (full) or w (local)
            avg_ctx = (eff / 2.0) if not w else min(w, seq / 2.0)
            flops += attn_mult * H * hd * avg_ctx * toks / 2.0 * 2.0
    if cfg.uses_ssm:
        di = cfg.d_model if cfg.family == "hybrid" else cfg.ssm_d_inner
        nh = di // cfg.ssm_head_dim
        Q = min(cfg.ssm_chunk, seq)
        N, P = cfg.ssm_state, cfg.ssm_head_dim
        per_tok = nh * (2 * Q * N + 2 * Q * P + 6 * N * P)
        fb = 3.0 if kind == "train" else 1.0  # bwd ~ 2x fwd
        flops += fb * Lc * toks * per_tok
    return flops


def roofline_terms(cost: CellCost, chips: int) -> Dict[str, float]:
    """``cost`` carries PER-DEVICE numbers, so each term divides by one
    card's peaks; ``chips`` only converts back to global FLOPs for the
    useful-compute ratio."""
    compute = cost.flops / PEAK_FLOPS_BF16
    memory = cost.bytes_accessed / HBM_BW
    collective = cost.coll_total / NVLINK_BW
    dominant = max(
        (("compute", compute), ("memory", memory),
         ("collective", collective)), key=lambda kv: kv[1])[0]
    total = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": total,
        "hlo_flops_global": cost.flops * chips,
    }
