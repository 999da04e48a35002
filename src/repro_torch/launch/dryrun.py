"""Multi-pod dry-run: prove a cell's step is coherent on the production mesh
without hardware, and price it against one card's roofline.

Port of :mod:`repro.launch.dryrun`.  For every (architecture x input
shape) cell this runs the real step function (``train_step`` for the
train shape, ``prefill`` / the greedy ``decode_step`` for the serving
shapes) of :func:`repro_torch.launch.steps.build_cell` on its ``meta``
stand-ins, on the single-pod 16 x 16 (data, model) mesh (the roofline's
source) or the 2 x 16 x 16 (pod, data, model) mesh.  Nothing touches a
device: a ``meta`` tensor carries shapes and types only, and the kernel
wrappers hand it to their plain versions, as the reference's dry-run
lowers on host CPUs.

Where the reference lowers and compiles the SPMD-partitioned program and
reads XLA's analyses, the port runs the unpartitioned program (the whole
global batch on one process) and counts it:

* FLOPs with ``torch.utils.flop_counter.FlopCounterMode``;
* bytes accessed with a ``TorchDispatchMode`` that sums the operand and
  result bytes of every aten operation that is not a view, as the port's
  eager program moves them on the card: the nearest analogue of XLA's
  "bytes accessed".  A kernel wrapper's plain version (attention, the
  scan, their backwards, the decode attention, the int8 matmul) counts
  as its kernel does, :func:`repro_torch.kernels.ref.as_kernel`: its
  inputs read once and its outputs written once, none of the plain
  version's intermediates (the attention's S x T scores never reach
  memory on the card);
* collectives as :class:`~repro_torch.launch.roofline.Collective` records
  for :func:`~repro_torch.launch.roofline.collective_wire_bytes`: the
  port's step runs on one process and calls none (placement across
  devices is ROADMAP A13), so the records are empty and the wire bytes 0.

**Per-device cost** is each count divided by the mesh's chips: the step
the port runs is the whole program, and a partitioned step divides its
work evenly (the reference's per-device cost analysis of a data-parallel
cell is the same division).  :func:`~repro_torch.launch.roofline.roofline_terms`
then divides by one card's peaks, as the reference's does.

**Memory** per device comes from the spec trees, exactly: each argument
and output leaf's bytes divided by the product of the mesh axes its
partition names, the donated arguments aliased to the outputs that take
their buffers (the reference's ``alias_size``).  The temporaries of a
partitioned program are not known without partitioning it: ``temp_bytes``
is null with the reason, and ``peak_bytes`` and ``hbm_fraction`` (of the
H100's ``HBM_BYTES``) are bounds from below.

The L2/L4 probe stays: counts at 2 and 4 layers give ``per_layer_flops``
through :func:`~repro_torch.launch.roofline.extrapolate`.  The port's
Python loop over layers counts every layer (no scan body is counted
once), so the full-depth count is itself exact and is what the roofline
reads; the extrapolation equals it wherever every layer is the same kind.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-probe
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed.sharding import _divisor, spec_map
from repro_torch.kernels import ref
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.steps import build_cell, pure_dp
from repro_torch.models.config import SHAPE_SPECS, cell_is_runnable

# Namespaces of torch.distributed's collectives, as the dispatcher sees them.
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def pick_grad_accum(cfg, shape_name, mesh) -> int:
    """Choose microbatching so the remat residual stack (~6 bytes/act
    element x L layers) stays under ~5 GB/device.  Powers of two, <= 16."""
    seq, gbatch, kind = SHAPE_SPECS[shape_name]
    if kind != "train":
        return 1
    if pure_dp(cfg, shape_name, mesh):
        return 1  # pure-DP cells: one row per device already
    dp = 1
    for a in mesh.axis_names:
        if a in ("pod", "data"):
            dp *= mesh.shape[a]
    b_loc = max(gbatch // dp, 1)
    per_b = seq * cfg.d_model * 6 * cfg.num_layers  # bytes per batch row
    accum = 1
    while accum < min(b_loc, 16) and b_loc // accum * per_b > 5e9:
        accum *= 2
    return accum


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor operand and result of each aten
    operation that is not a view (a view moves nothing), outside a
    kernel's plain version, and those of each kernel's inputs and outputs
    (:data:`repro_torch.kernels.ref.KERNEL_IO`); notes any collective the
    step calls."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives = []

    def __enter__(self):
        self._kernel_bytes = ref.KERNEL_IO.bytes
        return super().__enter__()

    def __exit__(self, *exc):
        self.bytes += ref.KERNEL_IO.bytes - self._kernel_bytes
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self.collectives.append(str(func))
        if not func.is_view and not ref.KERNEL_IO.depth:
            tensors = [t for t in tree_leaves((args, kwargs, out))
                       if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in tensors)
        return out


def count(fn, args) -> tuple:
    """(the outputs, the :class:`~repro_torch.launch.roofline.CellCost`
    of the whole program) of ``fn(*args)``."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as nb:
        out = fn(*args)
    if nb.collectives:
        raise NotImplementedError(
            f"the step called collectives {sorted(set(nb.collectives))}; "
            "their records (group sizes across devices) come with "
            "placement across devices: ROADMAP A13")
    return out, RL.CellCost(float(flops.get_total_flops()), float(nb.bytes),
                            RL.collective_wire_bytes([]))


def _per_device_bytes(tree, spec_tree, mesh) -> float:
    total = [0.0]

    def add(spec, leaf):
        total[0] += _nbytes(leaf) / _divisor(spec, mesh)
        return spec

    spec_map(add, spec_tree, tree)
    return total[0]


def _mem_stats(args, in_specs, out, out_specs, donate, mesh) -> dict:
    arg = sum(_per_device_bytes(a, s, mesh) for a, s in zip(args, in_specs))
    alias = sum(_per_device_bytes(args[i], in_specs[i], mesh)
                for i in donate)
    outb = sum(_per_device_bytes(o, s, mesh)
               for o, s in zip(out, out_specs))
    peak = arg + outb - alias
    return {
        "argument_bytes": arg,
        "output_bytes": outb,
        "alias_bytes": alias,
        "temp_bytes": None,
        "temp_reason": "the partitioned program's temporaries: the port "
                       "runs the unpartitioned program and partitions "
                       "nothing (ROADMAP A13)",
        "peak_bytes": peak,
        "hbm_fraction": peak / HBM_BYTES,
        "exact": ["argument_bytes", "output_bytes", "alias_bytes"],
        "lower_bounds": ["peak_bytes", "hbm_fraction"],
    }


def _run(cfg, shape_name, mesh, *, moe_impl, grad_accum, qcache, dp_only):
    fn, args, in_sp, out_sp, donate = build_cell(
        cfg, shape_name, mesh, moe_impl=moe_impl, grad_accum=grad_accum,
        qcache=qcache, dp_only=dp_only)
    out, cost = count(fn, args)
    return cost, _mem_stats(args, in_sp, out, out_sp, donate, mesh)


def _cost_dict(cost: RL.CellCost, chips: int) -> dict:
    return {"flops_per_device": cost.flops / chips,
            "bytes_per_device": cost.bytes_accessed / chips,
            "coll_bytes_per_device": cost.coll_total}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             probe: bool = True, moe_impl: str = "dense",
             qcache: bool = False, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    result: dict = {"arch": arch, "shape": shape_name,
                    "multi_pod": multi_pod, "moe_impl": moe_impl,
                    "qcache": qcache}
    if not cell_is_runnable(arch, shape_name):
        result["status"] = "SKIP(full-attn)"
        return result
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    # dp_only is decided ONCE from the full config so the shallow L2/L4
    # probes run with the same parallelism mapping.
    dp_only = pure_dp(cfg, shape_name, mesh)
    result["dp_only"] = dp_only
    result["collectives"] = []  # none called: one process (ROADMAP A13)
    t0 = time.time()
    try:
        total, result["memory"] = _run(
            cfg, shape_name, mesh, moe_impl=moe_impl, qcache=qcache,
            grad_accum=pick_grad_accum(cfg, shape_name, mesh),
            dp_only=dp_only)
        result["run_s"] = time.time() - t0
        result["cost"] = _cost_dict(total, chips)
        if probe and not multi_pod:
            costs = {}
            for Lp in (2, 4):
                cfg_p = dataclasses.replace(cfg, num_layers=Lp)
                costs[Lp], _ = _run(cfg_p, shape_name, mesh,
                                    moe_impl=moe_impl, grad_accum=1,
                                    qcache=qcache, dp_only=dp_only)
            ext = RL.extrapolate(costs[2], costs[4], cfg.num_layers)
            result["cost"]["per_layer_flops"] = (
                (costs[4] - costs[2]).scaled(0.5 / chips).flops)
            result["cost"]["extrapolated"] = _cost_dict(ext, chips)
    except Exception as e:
        result["status"] = "FAIL"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            _print_cell(result)
        return result
    result["status"] = "OK"
    terms = RL.roofline_terms(total.scaled(1.0 / chips), chips)
    mf = RL.model_flops(cfg, shape_name)
    terms["model_flops"] = mf
    terms["useful_ratio"] = (mf / terms["hlo_flops_global"]
                             if terms["hlo_flops_global"] else 0.0)
    result["roofline"] = terms
    if verbose:
        _print_cell(result)
    return result


def _print_cell(r: dict) -> None:
    tag = f"{r['arch']} × {r['shape']}" + (" [multi-pod]" if r["multi_pod"]
                                           else "")
    if r["status"] != "OK":
        print(f"{tag}: {r['status']} {r.get('error', '')}")
        return
    mem = r["memory"]
    t = r["roofline"]
    print(f"{tag}: OK meta={r['run_s']:.1f}s "
          f"hbm>={mem['hbm_fraction'] * 100:.1f}% (H100) | "
          f"compute={t['compute_s'] * 1e3:.2f}ms "
          f"memory={t['memory_s'] * 1e3:.2f}ms "
          f"coll={t['collective_s'] * 1e3:.2f}ms "
          f"dominant={t['dominant']} useful={t['useful_ratio']:.2f}",
          flush=True)


def all_cells():
    for arch in ARCH_NAMES:
        for shape_name in SHAPE_SPECS:
            yield arch, shape_name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--moe-impl", default="dense",
                    choices=["dense", "ragged", "local"])
    ap.add_argument("--qcache", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    results = []
    for arch, shape_name in cells:
        meshes = ([False, True] if args.both_meshes
                  else [args.multi_pod])
        for mp in meshes:
            results.append(run_cell(
                arch, shape_name, multi_pod=mp, probe=not args.no_probe,
                moe_impl=args.moe_impl, qcache=args.qcache))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        keyed = {(r["arch"], r["shape"], r["multi_pod"]): r
                 for r in existing}
        for r in results:
            keyed[(r["arch"], r["shape"], r["multi_pod"])] = r
        with open(args.out, "w") as f:
            json.dump(list(keyed.values()), f, indent=1)
    ok = sum(r["status"] == "OK" for r in results)
    skip = sum(r["status"].startswith("SKIP") for r in results)
    fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n=== dry-run: {ok} OK, {skip} skipped, {fail} failed "
          f"of {len(results)} cells")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
