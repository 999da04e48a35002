"""Sharding rules for serving: logical meshes and per-device weight shares.

Port of the part of :mod:`repro.distributed.sharding` the serving stack
uses: :class:`LogicalMesh`, :func:`serving_mesh`,
:func:`weight_shard_fraction` and :func:`variant_shard_mb`.  The
reference reads its ``param_specs`` ``PartitionSpec`` trees; here the
same rules are a function of one leaf's path and shape
(:func:`leaf_spec`), evaluated over the port's own parameter template on
the ``meta`` device, so no weight is ever allocated (llama4-scout at full
width is 107.8 B parameters).  Bytes are summed in the reference's leaf
order (dict keys sorted), so a fraction equals the reference's bit for
bit: a last-bit difference would move a per-device budget, and with it a
sim trail.

Scheme (Megatron-style tensor parallelism on the ``model`` axis):
column-parallel in-projections, row-parallel out-projections, experts
sharded on their expert dimension; every rule checks divisibility and
replicates a leaf that does not divide.  The training-only spec
functions (batch, cache, ZeRO-1 and optimizer-state specs) wait for the
distributed remainder (ROADMAP A10).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig

# Weights whose *input* (K) dim is sharded: the row-parallel halves of each
# Megatron pair.  Everything else 2-D prefers column (output/N) sharding.
_ROW_PARALLEL = ("wo", "wd", "ws_d", "ssm_out")

Spec = Tuple[Optional[str], ...]


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def _spec_for(name: str, shape: Tuple[int, ...], in_layers: bool,
              m: int, model_axis: str) -> list:
    """The reference's ``param_specs`` rule for one (unquantized) leaf
    with ``fsdp=False``, the serving layout."""
    nd = len(shape)
    lead = 1 if in_layers else 0  # stacked L dim
    base: list = [None] * nd
    if in_layers and nd - lead <= 1:
        return base  # per-layer vectors: replicate
    if name == "embed":  # (Kcb, Vp, D)
        if _div(shape[1], m):
            base[1] = model_axis
        return base
    if name == "head":  # (Kcb, D, Vp)
        if _div(shape[2], m):
            base[2] = model_axis
        return base
    if name in ("meta", "final_norm"):
        return base
    if name.startswith("we_"):  # (L, E, D, F): shard experts
        if _div(shape[1], m):
            base[1] = model_axis
        elif _div(shape[-1], m):
            base[-1] = model_axis
        return base
    if nd - lead == 2:  # (L, K, N) linear weights
        k_dim, n_dim = nd - 2, nd - 1
        row_first = any(name.startswith(r) for r in _ROW_PARALLEL)
        for d in ((k_dim, n_dim) if row_first else (n_dim, k_dim)):
            if _div(shape[d], m):
                base[d] = model_axis
                break
        return base
    return base


def leaf_spec(path: str, shape: Tuple[int, ...], mesh, *,
              model_axis: str = "model") -> Spec:
    """The partition of one parameter leaf (``path`` joins dict keys with
    ``/``, as ``quant.quantize.tree_map`` does) under ``mesh``: for each
    dimension the mesh axis it is split over, or None.  A quantized
    leaf's ``q`` takes its weight's rule; its scales ``s`` (..., G, N)
    shard N like ``q`` and never the group axis."""
    m = mesh.shape[model_axis]
    parts = path.split("/")
    in_layers = parts[0] == "layers"
    shape = tuple(shape)
    if parts[-1] in ("q", "s"):
        sp = _spec_for(parts[-2], shape, in_layers, m, model_axis)
        if parts[-1] == "s":
            sp[len(shape) - 2] = None  # row-parallel q: scales replicate
        return tuple(sp)
    name = parts[1] if in_layers else parts[0]
    return tuple(_spec_for(name, shape, in_layers, m, model_axis))


def _divisor(spec: Spec, mesh) -> int:
    """How many ways a leaf with partition ``spec`` is split on ``mesh``."""
    div = 1
    for entry in spec:
        if entry is not None:
            div *= mesh.shape[entry]
    return div


def _sorted_leaves(tree, path: str = ""):
    """(path, tensor) of every leaf, dict keys sorted at every level: the
    order ``jax.tree.leaves`` walks the reference's pytrees in."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# Logical meshes and per-device weight footprints (serving-side accounting)
# ---------------------------------------------------------------------------
class LogicalMesh:
    """A shape mapping + axis names, nothing more.

    The spec rules above only read ``mesh.shape[name]``, so serving-side
    accounting (per-device memory ledgers, shard-size math) runs them
    without any device: a sharded sim run, or a sharded mesh served from
    one card, needs no second card."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axes must be >= 1: {self.shape}")

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape})"


def serving_mesh(mesh_shape: Tuple[int, ...]) -> LogicalMesh:
    """The serving stack's mesh convention: a 1-D shape is pure tensor
    parallelism (``("model",)``); a 2-D shape is ``("data", "model")``."""
    if len(mesh_shape) == 1:
        return LogicalMesh({"model": mesh_shape[0]})
    if len(mesh_shape) == 2:
        return LogicalMesh({"data": mesh_shape[0], "model": mesh_shape[1]})
    raise ValueError(
        f"serving mesh_shape must be 1-D or 2-D, got {mesh_shape}")


def weight_shard_fraction(cfg: ModelConfig, mesh, *,
                          model_axis: str = "model",
                          dtype=None) -> float:
    """Fraction of a tenant's weight bytes resident on ONE device of the
    mesh: sharded leaves contribute ``1/m`` of their bytes per
    model-slice, replicated leaves (norms, odd-width projections that
    don't divide the axis) a full copy.  Always ``>= 1/mesh.size`` — the
    excess is the replication overhead a per-device memory ledger must
    budget for.  Model slices are symmetric, so one fraction describes
    every device.  ``dtype`` (bf16 by default) is the weights'; the
    initializer keeps some vectors in f32, as the reference's does."""
    from repro_torch.models import transformer as T

    abstract = T.init_params(cfg, 0, dtype or torch.bfloat16, device="meta")
    total = 0
    per_device = 0.0
    for path, leaf in _sorted_leaves(abstract):
        nbytes = leaf.numel() * leaf.element_size()
        spec = leaf_spec(path, tuple(leaf.shape), mesh,
                         model_axis=model_axis)
        total += nbytes
        per_device += nbytes / _divisor(spec, mesh)
    return per_device / total if total else 1.0


def variant_shard_mb(size_mb: float, n_devices: int,
                     fraction: Optional[float] = None) -> Tuple[float, ...]:
    """Per-device resident MB for one zoo variant staged across
    ``n_devices``: each device holds ``fraction`` of the variant
    (``1/n`` for an ideal even split; :func:`weight_shard_fraction` for
    the real spec-derived figure including replication).  The serving
    loader stages one such shard per device stream."""
    f = (1.0 / n_devices) if fraction is None else fraction
    return tuple(size_mb * f for _ in range(n_devices))
