"""Kernel calls on ``DTensor`` arguments: a tenant placed across ranks.

A kernel reads storage through raw pointers, and a ``DTensor`` has none of
its own.  Each wrapper of :mod:`repro_torch.kernels.ops` therefore hands a
``DTensor`` call to the function here of its name, which runs the wrapper
again on every rank's local block through ``local_map``, with the
placements the call's layout implies, and wraps the result.  The local call
dispatches on the local tensor's device as any other: a CUDA block goes to
the Hopper kernel, or the call raises; a CPU block to the plain version.

The layouts, on the model axis (every other mesh dim keeps the activation's
own placement, a batch split or none):

- ``quant_matmul``, and :func:`matmul` for a dense weight (the models'
  ``mm``): a column-parallel weight (``q`` and ``s`` split on N) takes a
  replicated ``x`` and gives a split output; a row-parallel one (``q``
  split on K, ``s`` replicated) takes ``x`` split on K, and each rank's
  float32 partial product is summed over the ranks before the one
  rounding to the output's type
  (:func:`repro_torch.distributed.sharding.summed`).  A rank's K rows may
  start inside a quantization group (tinyllama's
  ``d_ff`` 5632 over 8 ranks is 704 rows, 5.5 groups of 128): the rank's
  scales are regrouped at the largest group size that divides the group,
  the block's first row and its row count (:func:`shard_scales`), each
  finer group carrying the scale of the group it lies in.  The kernel then
  takes the block in one launch, unchanged, with the same products.
- ``flash_attention`` and ``decode_attention``: q split on its heads takes
  k and v (the cache) split on their KV heads, so that each rank's query
  heads read their own KV heads (the layers repeat KV heads up to the
  model axis first where there are fewer, :func:`repro_torch.models.layers.
  kv_for_ranks`); a batch split carries to every batched input.
- ``ssd_scan`` and ``ssd_step``: x split on its heads takes dt, A, D and
  the state split on the same heads; B and C are split on their groups
  where the groups divide the axis, and replicated where there is one
  group.

Every gather goes through :func:`repro_torch.distributed.sharding.
redistribute` (the process group's own collectives).
"""
from __future__ import annotations

import collections
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import as_dtensor, redistribute, summed
# The wrappers test their arguments with placed.is_placed.
from repro_torch.distributed.sharding import is_placed  # noqa: F401


# This process's placed kernel calls: (kernel, the local blocks' shapes)
# -> calls.  What a rank's kernels were given, for a check to read.
local_shapes: "collections.Counter[tuple]" = collections.Counter()


def _note(name: str, *ts) -> None:
    local_shapes[(name,) + tuple(
        None if t is None else tuple(t.shape) for t in ts)] += 1


def _no_partial(p):
    """A partial sum is reduced before a kernel reads it."""
    return Replicate() if p.is_partial() else p


def _run(fn, mesh, out, ins, *args):
    args = [a if not isinstance(a, DTensor) or tuple(a.placements)
            == tuple(p) else redistribute(a, p) for a, p in zip(args, ins)]
    return local_map(fn, out_placements=out, in_placements=ins,
                     device_mesh=mesh)(*args)


def shard_scales(scales: torch.Tensor, K: int, lo: int,
                 rows: int) -> torch.Tensor:
    """The scales of rows [lo, lo + rows) of a (K, N) weight quantized in
    groups of K / G (``scales`` (G, N)), regrouped so that the block's
    groups are whole: groups of g' = gcd(group, lo, rows) rows, each with
    the scale of the group it lies in.  g' is the group itself where the
    block starts and ends on group bounds."""
    group = K // scales.shape[0]
    g = math.gcd(group, lo, rows)
    if g == group:
        return scales[lo // group:(lo + rows) // group]
    idx = torch.div(lo + torch.arange(rows // g, device=scales.device) * g,
                    group, rounding_mode="floor")
    return scales.index_select(0, idx).contiguous()


def _product_layout(x, w):
    """Placements of a product x @ w on each mesh dim, from the weight's:
    (x's, the scales', the output's), and the mesh dim that splits the
    weight's rows (K), if one does.  Column-parallel (w split on N): x
    replicated, the output split on its last dim.  Row-parallel (w split
    on K): x split on its last dim, the output a partial sum.  Elsewhere x
    keeps its own placement (a batch split), but for a split of its last
    dim, which is gathered."""
    last = x.ndim - 1
    x_in, s_in, out = [], [], []
    row_dim = None
    for i, p in enumerate(w.placements):
        xp = _no_partial(x.placements[i])
        if p.is_shard(1):  # column-parallel: N split
            x_in.append(Replicate())
            s_in.append(Shard(1))
            out.append(Shard(last))
        elif p.is_shard(0):  # row-parallel: K split
            x_in.append(Shard(last))
            # The scales' own rule splits N where the groups do not divide
            # the axis (a reduced width): every rank needs all N.
            s_in.append(Replicate())
            out.append(Partial())
            row_dim = i
        else:
            keep = Replicate() if xp.is_shard(last) else xp
            x_in.append(keep)
            s_in.append(Replicate())
            out.append(keep)
    return x_in, s_in, out, row_dim


def quant_matmul(fn, x, w_q, scales, out_dtype):
    mesh = w_q.device_mesh
    x = as_dtensor(x, mesh)
    scales = as_dtensor(scales, mesh)
    x_in, s_in, out, row_dim = _product_layout(x, w_q)
    ins = (x_in, w_q.placements, s_in)
    if row_dim is None:
        def local(x_, q_, s_):
            _note("quant_matmul", x_, q_, s_)
            return fn(x_, q_, s_, out_dtype=out_dtype)

        return _run(local, mesh, out, ins, x, w_q, scales)
    K = w_q.shape[0]
    rows = K // mesh.size(row_dim)
    lo = mesh.get_coordinate()[row_dim] * rows

    def local_rows(x_, q_, s_):
        s_ = shard_scales(s_, K, lo, rows)
        _note("quant_matmul", x_, q_, s_)
        return fn(x_, q_, s_, out_dtype=torch.float32)

    return summed(_run(local_rows, mesh, out, ins, x, w_q, scales),
                  out_dtype or x.dtype)


def matmul(x, w):
    """``x @ w`` for a placed dense weight (no kernel: the library's
    product on each rank's block), laid out as :func:`quant_matmul`: a
    row-parallel product in float32 on each rank, summed over the ranks
    and rounded once to ``x``'s type, as one card's product rounds
    once."""
    mesh = w.device_mesh
    x = as_dtensor(x, mesh)
    x_in, _, out, row_dim = _product_layout(x, w)
    if row_dim is None:
        return _run(torch.matmul, mesh, out, (x_in, w.placements), x, w)
    return summed(_run(_f32_product, mesh, out, (x_in, w.placements), x, w),
                  x.dtype)


def _f32_product(x, w):
    """x @ w in float32: a bf16 block widened (exactly) and multiplied on
    the CUDA cores, so that the sum over the ranks rounds to the correctly
    rounded product.  A bf16 product with a float32 output
    (``torch.mm(..., out_dtype=torch.float32)``) saves the widened copy
    but sums on the tensor cores: on the H100 it moved a greedy token of
    tinyllama-1.1b's 16-bit variant at a near-tie against one card's
    product, where the widened product kept every token (PERF.md, the
    placed phase).
    The copy is a rank's block of one weight at a time."""
    return x.float() @ w.float()


def _heads(name, q, head_dim: int):
    """q's placement a mesh dim, checked to split only the batch or the
    heads."""
    for p in q.placements:
        if p.is_shard() and p.dim not in (0, head_dim):
            raise ValueError(f"{name}: a placed q may split its batch or "
                             f"its heads only, got {q.placements}")
    return [_no_partial(p) for p in q.placements]


def flash_attention(fn, q, k, v, kw: dict):
    mesh = q.device_mesh
    qp = _heads("flash_attention", q, 2)

    def local(q_, k_, v_):
        _note("flash_attention", q_, k_, v_)
        return fn(q_, k_, v_, **kw)

    return _run(local, mesh, qp, (qp, qp, qp), q, as_dtensor(k, mesh),
                as_dtensor(v, mesh))


def decode_attention(fn, q, k_cache, v_cache, lengths, kw: dict):
    mesh = q.device_mesh
    qp = _heads("decode_attention", q, 1)
    kp = [Shard(2) if p.is_shard(1) else p for p in qp]
    lp = [Replicate() if p.is_shard(1) else p for p in qp]

    def local(q_, k_, v_, l_):
        _note("decode_attention", q_, k_, v_)
        return fn(q_, k_, v_, l_, **kw)

    return _run(local, mesh, qp, (qp, kp, kp, lp), q,
                as_dtensor(k_cache, mesh),
                as_dtensor(v_cache, mesh), as_dtensor(lengths, mesh))


def _scan_layout(name, x, G: int, head_dim: int):
    """The placements of a scan's (or step's) inputs from x's: dt, A and
    D, B and C, the state."""
    mesh = x.device_mesh
    xp = _heads(name, x, head_dim)
    heads = [p.is_shard(head_dim) for p in xp]
    hp = [Shard(0) if h else Replicate() for h in heads]  # A, D
    bcp, sp = [], []
    for i, (p, h) in enumerate(zip(xp, heads)):
        if h:
            if G % mesh.size(i) == 0:
                bcp.append(Shard(head_dim))
            elif G == 1:
                bcp.append(Replicate())
            else:
                raise NotImplementedError(
                    f"{name}: {G} groups over {mesh.size(i)} ranks")
            sp.append(Shard(1))
        else:
            bcp.append(p)
            sp.append(p)
    return mesh, xp, hp, bcp, sp


def ssd_step(fn, x, dt, A, Bm, Cm, D, state):
    """The scan's decode step (plain PyTorch on every device, no kernel)
    on each rank's heads, as the cache's state is split."""
    mesh, xp, hp, bcp, sp = _scan_layout("ssd_step", x, Bm.shape[1], 1)
    return _run(fn, mesh, (xp, sp), (xp, xp, hp, bcp, bcp, hp, sp),
                *(as_dtensor(a, mesh) for a in (x, dt, A, Bm, Cm, D,
                                                 state)))


def ssd_scan(fn, x, dt, A, Bm, Cm, D, init_state, return_state: bool,
             chunk: int):
    mesh, xp, hp, bcp, sp = _scan_layout("ssd_scan", x, Bm.shape[2], 2)
    dtp = xp  # (B, S, H): the same dims as x's first three
    args = [x, dt, A, Bm, Cm, D]
    ins = [xp, dtp, hp, bcp, bcp, hp]
    if init_state is not None:
        args.append(init_state)
        ins.append(sp)

    def local(x_, dt_, A_, B_, C_, D_, s_=None):
        _note("ssd_scan", x_, B_, s_)
        return fn(x_, dt_, A_, B_, C_, D_, init_state=s_,
                  return_state=return_state, chunk=chunk)

    out = (xp, sp) if return_state else xp
    return _run(local, mesh, out, tuple(ins),
                *(as_dtensor(a, mesh) for a in args))
