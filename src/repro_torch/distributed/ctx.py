"""Activation-sharding context.

Port of :mod:`repro.distributed.ctx`.  The reference's layers call
``hint`` to emit ``with_sharding_constraint`` on activations under a mesh
context that the launcher installs.  The port's layers call :func:`hint`
at the same places.  On a plain tensor it returns its input unchanged,
also when a context is enabled: PyTorch has no sharding constraint on a
plain tensor.  On a ``DTensor`` (a tenant placed across ranks, which
installs a context while it serves, :func:`installed`) it redistributes
the tensor to the layout the reference constrains it to.

Tensor-parallel training runs on plain local shards instead: its step
installs the model axis's process group (:func:`tensor_parallel`), which
the helpers of :mod:`repro_torch.distributed.tensor_parallel` read.  With
no group installed (one device, ZeRO, placed serving) every one of them is
the identity.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed import sharding as SH


@dataclass(frozen=True)
class ShardCtx:
    dp_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    model_size: int = 1
    dp_size: int = 1
    enabled: bool = False

    @property
    def dp_spec(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]


_CTX = ShardCtx()


def set_ctx(ctx: Optional[ShardCtx]) -> None:
    global _CTX
    _CTX = ctx if ctx is not None else ShardCtx()


def get_ctx() -> ShardCtx:
    return _CTX


@contextmanager
def installed(ctx: ShardCtx):
    """``ctx`` installed for the block, the previous context after it."""
    global _CTX
    prev, _CTX = _CTX, ctx
    try:
        yield ctx
    finally:
        _CTX = prev


def hint(x, *dims: Optional[str]):
    """Constrain ``x``: each entry of ``dims`` is "dp", "model" or None a
    dim.  A plain tensor, or any tensor without an enabled context, comes
    back as it is.  A ``DTensor`` is redistributed so that each "model"
    dim is split over the model axis and each "dp" dim over the data
    axes, where it divides them evenly, and every other mesh dim is
    replicated (a partial sum is reduced).  The reference lets XLA split a
    "model" dim unevenly (padding the last shards); ``DTensor`` would leave
    ranks empty instead, so a dim that does not divide stays replicated,
    and the layer that reads it takes its part locally (grouped-query
    attention with fewer KV heads than ranks,
    :func:`repro_torch.models.layers.kv_for_ranks`)."""
    ctx = _CTX
    if not ctx.enabled or not SH.is_placed(x):
        return x
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * mesh.ndim
    for d, (n, want) in enumerate(zip(x.shape, dims)):
        axes = ((ctx.model_axis,) if want == "model"
                else ctx.dp_axes if want == "dp" else ())
        axes = tuple(a for a in axes if a in names)
        size = 1
        for a in axes:
            size *= mesh.size(names.index(a))
        if size > 1 and n % size == 0:
            for a in axes:
                out[names.index(a)] = Shard(d)
    if tuple(out) == tuple(x.placements):
        return x
    return SH.redistribute(x, out)


@dataclass(frozen=True)
class TPGroup:
    """The model axis of a tensor-parallel step: its process group, this
    rank's index in it, and its size."""
    group: Any
    rank: int
    size: int


_TP: Optional[TPGroup] = None


def get_tp() -> Optional[TPGroup]:
    """The installed model axis, or None.  A module global, not a
    thread's: the backward (and remat's recomputation in it) may run on
    another thread than the forward."""
    return _TP


@contextmanager
def tensor_parallel(group, rank: int, size: int):
    """The model axis ``group`` (this rank ``rank`` of ``size``) installed
    for the block, the previous one after it; a group of one rank installs
    nothing."""
    global _TP
    prev, _TP = _TP, (TPGroup(group, rank, size) if size > 1 else None)
    try:
        yield _TP
    finally:
        _TP = prev
