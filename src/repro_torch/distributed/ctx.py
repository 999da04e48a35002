"""Activation-sharding context.

Port of :mod:`repro.distributed.ctx`.  The reference's layers call
``hint`` to emit ``with_sharding_constraint`` on activations under a mesh
context that the launcher installs.  PyTorch has no sharding constraint
on a plain tensor, and the port's layers call no hint, so :func:`hint`
returns its input unchanged, also when the context is enabled.  The
context (:class:`ShardCtx`, :func:`set_ctx`, :func:`get_ctx`) keeps the
reference's names, but nothing in the port reads its fields: a context
is a frozen value that a launcher may install and read back, and it
changes no computation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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


def hint(x, *dims: Optional[str]):
    """``x`` itself: each entry of ``dims`` ("dp", "model" or None a dim)
    names the layout the reference would constrain ``x`` to, which a
    plain PyTorch tensor cannot carry."""
    return x
