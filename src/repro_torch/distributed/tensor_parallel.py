"""Tensor parallelism on plain local shards: Megatron's f/g pair and the
gathers around it, as ``torch.autograd.Function``s over the model axis
that a training step installs (:func:`repro_torch.distributed.ctx.
tensor_parallel`).

Port-only.  The reference trains a model split on the model axis as one
SPMD program and XLA inserts the collectives; here each rank runs the
model on its own blocks (column-parallel in-projections, row-parallel
out-projections, its experts, its vocabulary rows) and these helpers put
the collectives where the program needs them, forward and backward:

* :func:`copy_in` (f): identity forward, all-reduce backward.  On a tensor
  every rank holds whole before a rank-local use (an in-projection's
  columns, the LM head's vocabulary columns, the rank's experts and their
  gates, a replicated norm weight on the rank's heads): each rank's
  gradient of it is a partial sum.
* :func:`reduce_out` (g): all-reduce forward, identity backward.  After a
  row-parallel product or the rank's experts: the partial sums added.
* :func:`gather_last`: all-gather of the last dim forward, the rank's own
  slice backward.  Where every rank then computes the same thing from the
  whole (the router's logits; k and v normed and rotated whole), so every
  rank's gradient of the whole is the same.  A gather whose whole is then
  used rank-locally (q for the rank's heads, k and v for its KV heads) is
  ``copy_in(gather_last(x))``: its backward sums the ranks' gradients
  first (a reduce-scatter's result).
* :func:`gather_blocks`: the same over blocks of unequal widths (the
  ranks' attention heads where the axis does not divide them,
  :func:`head_range`), each padded to the widest for the gather.
* :func:`all_max`, :func:`all_min`: all-reduces outside autograd (the
  vocabulary-parallel cross entropy's shift and its argmax).
* :func:`vocab_lookup`: the vocabulary-parallel embedding, the ids looked
  up in the rank's rows, zeros for the others, then :func:`reduce_out`.

Only ``all_reduce`` and ``all_gather_into_tensor`` run (the kinds the
launch dry-run prices).  Each rank must issue them in the same order,
remat's recomputation included: every rank runs the same program, so they
do.  With no model axis installed every helper returns its input.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.ctx import get_tp


def size() -> int:
    """Ranks of the installed model axis (1 without one)."""
    tp = get_tp()
    return 1 if tp is None else tp.size


def rank() -> int:
    """This rank's index on the installed model axis (0 without one)."""
    tp = get_tp()
    return 0 if tp is None else tp.rank


def is_split(local: int, whole: int) -> bool:
    """Whether a dim of ``whole`` entries that this rank holds ``local`` of
    is split over the installed model axis (evenly, or it raises)."""
    tp = get_tp()
    if tp is None or local == whole:
        return False
    if local * tp.size != whole:
        raise ValueError(f"{local} of {whole} is not a split over "
                         f"{tp.size} ranks")
    return True


def head_range(heads: int, r=None) -> tuple:
    """Rank ``r``'s heads ``[a, b)`` of ``heads`` over the installed model
    axis (this rank's where None): the first ``heads % m`` ranks take
    ``ceil(heads / m)`` and the rest ``floor(heads / m)`` (llama4-scout's
    40 over 16: 8 ranks of 3, 8 of 2), so rank 0 holds as many as the
    reference's device 0 under GSPMD's padded split.  All of them without
    an axis."""
    m, r = size(), rank() if r is None else r
    q, extra = divmod(heads, m)
    a = r * q + min(r, extra)
    return a, a + q + (r < extra)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, widths, r):
        import torch.distributed as dist

        n, w = len(widths), max(widths)
        ctx.lo, ctx.w = sum(widths[:r]), x.shape[-1]
        if x.shape[-1] < w:
            x = torch.nn.functional.pad(x, (0, w - x.shape[-1]))
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        blocks = out.view(n, *x.shape).unbind(0)
        return torch.cat([b[..., :k] for b, k in zip(blocks, widths)], -1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.w], None, None, None


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """``x`` (whole on every rank) for a rank-local use: its gradient
    all-reduced over the model axis."""
    tp = get_tp()
    return x if tp is None else _CopyIn.apply(x, tp.group)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """The ranks' partial sums ``x`` added over the model axis."""
    tp = get_tp()
    return x if tp is None else _ReduceOut.apply(x, tp.group)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks of the last dim of ``x`` gathered in rank order;
    the gradient of the whole is taken to be the same on every rank."""
    return gather_blocks(x, [x.shape[-1]] * size())


def gather_blocks(x: torch.Tensor, widths) -> torch.Tensor:
    """The ranks' blocks of the last dim of ``x``, rank r's ``widths[r]``
    wide, gathered in rank order (each padded to the widest for one
    ``all_gather_into_tensor``); the gradient of the whole is taken to be
    the same on every rank, as in :func:`gather_last`."""
    tp = get_tp()
    if tp is None:
        return x
    return _GatherBlocks.apply(x, tp.group, tuple(widths), tp.rank)


def _all_reduce_op(x: torch.Tensor, op: str) -> torch.Tensor:
    tp = get_tp()
    if tp is None:
        return x.detach()
    import torch.distributed as dist

    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=tp.group)
    return out


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model axis, no gradient."""
    return _all_reduce_op(x, "MAX")


def all_min(x: torch.Tensor) -> torch.Tensor:
    """The elementwise min of ``x`` over the model axis, no gradient."""
    return _all_reduce_op(x, "MIN")


def own_cols(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the last dim of ``x`` (whole on every rank),
    taken in (:func:`copy_in`)."""
    n = x.shape[-1] // size()
    return copy_in(x)[..., rank() * n:(rank() + 1) * n]


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``whole_table[ids]`` from this rank's rows ``table`` of a table
    split on its rows over the model axis: Megatron's vocabulary-parallel
    embedding (the table is never gathered)."""
    rows = table.shape[0]
    j = ids.long() - rank() * rows
    ok = (j >= 0) & (j < rows)
    out = table[j.clamp(0, rows - 1)]
    return reduce_out(torch.where(ok[..., None], out,
                                  torch.zeros_like(out)))
