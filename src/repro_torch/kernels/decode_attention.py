"""Decode attention: one query token per sequence against a dense KV cache,
or against a shared pool of KV pages, through Hopper kernels.

Ports of :func:`repro.kernels.decode_attention.decode_attention` and
:func:`~repro.kernels.decode_attention.paged_decode_attention` (the Pallas
kernels ``_decode_kernel`` and ``_paged_decode_kernel``), and of the
``paginate_kv`` helper that lays a dense cache out as pages.  The CUDA
source is ``repro_torch/csrc/decode_attention.cu``: one split-key body
serves both layouts, and a second kernel combines the splits; its header
comment gives the design and what bounds it on the H100 (the cache bytes
it reads).  :func:`split_plan` decides how a call cuts its keys, from the
shapes and types alone.

A tensor on the CPU or on ``meta`` is computed by the plain versions,
:func:`repro_torch.kernels.ref.decode_attention` and
:func:`~repro_torch.kernels.ref.paged_decode_attention`.  A CUDA tensor
goes to the kernel, or the call raises: there is no fallback.  ``q`` and
the cache (or pool) may each be float32 or bfloat16, independently.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import placed, ref
from repro_torch.kernels.build import (check_launch, launcher,
                                      refuse_grad, stream_ptr)

_TYPES = (torch.float32, torch.bfloat16)
_MAX_HEADS = 8  # query heads per block (kMaxHeads in the source)
_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
_COMBINE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                     + [ctypes.c_void_p])


class SplitPlan(NamedTuple):
    """How one call cuts its keys: ``splits`` splits of ``split`` logical
    rows, staged ``tile`` rows at a time, ``heads`` query heads a block,
    ``blocks`` blocks of the split kernel in all."""
    split: int
    splits: int
    tile: int
    heads: int
    blocks: int


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _pow2_ceil(x: int) -> int:
    return 1 << (max(1, x) - 1).bit_length()


def split_plan(B: int, H: int, KV: int, D: int, kv_dtype: torch.dtype,
               rows: int) -> SplitPlan:
    """The split plan of one decode call over ``rows`` logical cache rows
    (T for the dense cache, NP * page_size for the pool).

    A block holds the ``heads`` query heads of one KV head (G = H / KV, cut
    into chunks of at most 8).  The tile is the most rows (8 to 64, a power
    of two) whose k takes at most 8 KB of shared memory and whose scores
    take at most 16K multiply-adds.  The split length is 16 rows for each
    (sequence, KV head) pair over the heads a block holds, in powers of
    two, between 1 and 16 tiles: few pairs over a long cache still fill
    the card (gemma2's replay, 8 pairs of 2 heads at D=256, splits every
    64 rows, 528 blocks at 4204 rows), and the serving batch's 20 rows stay
    one split and one launch.  Neither depends on ``rows``, nor on the
    lengths: a dense cache and its page pool split at the same logical
    rows, and the pool's rows past T only add splits at the end."""
    esz = torch.finfo(kv_dtype).bits // 8
    G = H // KV
    chunks = -(-G // _MAX_HEADS)
    heads = -(-G // chunks)
    tile = min(64, max(8, _pow2_floor(min(8192 // (D * esz),
                                          16384 // (heads * D)))))
    split = 16 * _pow2_ceil(B * KV) // _pow2_ceil(heads)
    split = min(16 * tile, max(tile, split))
    splits = -(-rows // split)
    return SplitPlan(split, splits, tile, heads, B * KV * chunks * splits)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name: str, q, k, v, lengths, extra=()) -> None:
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (k, v, lengths, *extra)):
        raise ValueError(f"{name}: all inputs must share one CUDA device")
    if q.dtype not in _TYPES or k.dtype not in _TYPES or v.dtype != k.dtype:
        raise TypeError(f"{name}: q {q.dtype}, k {k.dtype}, v {v.dtype} not "
                        "float32/bfloat16 with k and v alike")


def _launch(name: str, q, k, v, table, lengths, n: int, P: int, ps: int,
            NP: int, *, window: int, softcap: float, scale: float,
            prefix: int) -> torch.Tensor:
    """Both layouts: the split kernel, then (with more than one split) the
    combine kernel, each launch checked.  The f32 partials and their
    (m, l) pairs are allocated here; the kernels allocate nothing."""
    B, H, D = q.shape
    KV = k.shape[1] if table is not None else k.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    plan = split_plan(B, H, KV, D, k.dtype, n)
    part = ml = None
    if plan.splits > 1:
        G = H // KV
        part = torch.empty((B, KV, plan.splits, G, D), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((B, KV, plan.splits, G, 2), dtype=torch.float32,
                         device=q.device)
    flags = (int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16))
    dims = (B, H, KV, n, D, P, ps, NP)
    stream = stream_ptr(q.device)
    err = launcher("decode_attention", _SPLIT_ARGTYPES, "decode_split_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(table),
        lengths.data_ptr(), out.data_ptr(), _ptr(part), _ptr(ml), *flags,
        *dims, plan.split, plan.splits, plan.tile, plan.heads,
        float(scale or D ** -0.5), int(window), float(softcap), int(prefix),
        stream)
    check_launch(name, err)
    if plan.splits > 1:
        err = launcher("decode_attention", _COMBINE_ARGTYPES,
                       "decode_combine_launch")(
            part.data_ptr(), ml.data_ptr(), v.data_ptr(), _ptr(table),
            out.data_ptr(), *flags, *dims, plan.splits, stream)
        check_launch(name, err)
    return out


_SERVES_ONLY = ("ROADMAP A9: training runs prefill attention; the decode "
                "kernels only serve")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: float = 0.0, prefix: int = 0) -> torch.Tensor:
    """q: (B, H, D); k/v cache: (B, T, KV, D); lengths: (B,) int32.  A
    ``DTensor`` q runs each rank's heads (:mod:`.placed`)."""
    if placed.is_placed(q):
        return placed.decode_attention(
            decode_attention, q, k_cache, v_cache, lengths,
            dict(window=window, softcap=softcap, scale=scale, prefix=prefix))
    if q.device.type in ref.PLAIN_DEVICES:
        return ref.as_kernel(ref.decode_attention, q, k_cache, v_cache,
                             lengths, window=window, softcap=softcap,
                             scale=scale, prefix=prefix)
    refuse_grad("decode_attention", _SERVES_ONLY, q, k_cache, v_cache)
    B, H, D = q.shape
    _, T, KV, _ = k_cache.shape
    _check("decode_attention", q, k_cache, v_cache, lengths)
    if lengths.dtype != torch.int32:
        raise TypeError("decode_attention: lengths must be int32")
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or KV == 0 or H % KV
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k_cache.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if D > 256 or D % 8 or T < 1:
        raise ValueError(f"decode_attention: needs D <= 256, a multiple of "
                         f"8, and T >= 1, got D={D}, T={T}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("decode_attention: inputs must be contiguous")
    out = _launch("decode_attention", q, k_cache, v_cache, None, lengths, T,
                  0, 1, 0, window=window, softcap=softcap, scale=scale,
                  prefix=prefix)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, window: int = 0,
                           softcap: float = 0.0, scale: float = 0.0,
                           prefix: int = 0) -> torch.Tensor:
    """q: (B, H, D); k/v pages: (P, KV, page_size, D); page_table: (B, NP)
    int32, logical block ``t`` of sequence ``b`` in page
    ``page_table[b, t]``; lengths: (B,) int32.  On the card an entry
    outside [0, P) that the kernel would read stops it (a device trap),
    rather than being clamped."""
    if q.device.type in ref.PLAIN_DEVICES:
        return ref.as_kernel(
            ref.paged_decode_attention, q, k_pages, v_pages, page_table,
            lengths, window=window, softcap=softcap, scale=scale,
            prefix=prefix)
    refuse_grad("paged_decode_attention", _SERVES_ONLY, q, k_pages, v_pages)
    B, H, D = q.shape
    P, KV, ps, _ = k_pages.shape
    _check("paged_decode_attention", q, k_pages, v_pages, lengths,
           (page_table,))
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table and lengths "
                        "must be int32")
    if (k_pages.shape != v_pages.shape or k_pages.shape[3] != D or KV == 0
            or H % KV or page_table.ndim != 2 or page_table.shape[0] != B
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"paged_decode_attention: shapes q "
                         f"{tuple(q.shape)}, k/v pages "
                         f"{tuple(k_pages.shape)}, table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    NP = page_table.shape[1]
    if D > 256 or D % 8 or min(P, ps, NP) < 1:
        raise ValueError(f"paged_decode_attention: needs D <= 256, a "
                         f"multiple of 8, and at least one page, row and "
                         f"table entry, got D={D}, P={P}, page_size={ps}, "
                         f"NP={NP}")
    if not all(t.is_contiguous()
               for t in (q, k_pages, v_pages, page_table, lengths)):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    out = _launch("paged_decode_attention", q, k_pages, v_pages, page_table,
                  lengths, NP * ps, P, ps, NP, window=window,
                  softcap=softcap, scale=scale, prefix=prefix)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paginate_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, lengths,
                page_size: int, *, permute: bool = True):
    """Scatter a dense (B, T, KV, D) cache into a shared page pool.

    Returns ``(k_pages, v_pages, page_table)``: pages laid out
    ``(P, KV, page_size, D)`` on the cache's device, the table (B, NP)
    int32.  With ``permute=True`` the physical page order is the
    reference's deterministic odd-stride walk, so the gather is really
    exercised; the tail of the last page is zeros.  Table entries past
    each sequence's last page point to page 0.  Equal to the reference's
    helper bit for bit."""
    B, T, KV, D = k_cache.shape
    NP = math.ceil(T / page_size)
    Tp = NP * page_size
    if Tp != T:
        pad = (0, 0, 0, 0, 0, Tp - T)
        k_cache, v_cache = F.pad(k_cache, pad), F.pad(v_cache, pad)
    # (B, NP, ps, KV, D) -> (B*NP, KV, ps, D): logical page (b, t) sits at
    # physical slot b*NP + t before the permutation.
    k_lin = k_cache.reshape(B, NP, page_size, KV, D).movedim(3, 2).reshape(
        B * NP, KV, page_size, D)
    v_lin = v_cache.reshape(B, NP, page_size, KV, D).movedim(3, 2).reshape(
        B * NP, KV, page_size, D)
    P = B * NP
    if permute and P > 1:
        stride = max(2, P // 3) | 1  # odd -> coprime walk when P is 2^k
        while math.gcd(stride, P) != 1:
            stride += 2
        perm = np.arange(P) * stride % P  # perm[logical] = physical
    else:
        perm = np.arange(P)
    inv = np.empty(P, np.int64)
    inv[perm] = np.arange(P)
    idx = torch.from_numpy(inv).to(k_lin.device)
    k_pages, v_pages = k_lin[idx].contiguous(), v_lin[idx].contiguous()
    lens = (lengths.detach().cpu().numpy() if isinstance(lengths, torch.Tensor)
            else np.asarray(lengths))
    used = np.ceil(np.maximum(lens, 1) / page_size).astype(np.int64)
    table = np.where(np.arange(NP)[None, :] < used[:, None],
                     perm.reshape(B, NP), 0)
    return (k_pages, v_pages,
            torch.from_numpy(table.astype(np.int32)).to(k_lin.device))
