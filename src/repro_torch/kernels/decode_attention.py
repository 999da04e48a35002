"""Decode attention: one query token per sequence against a dense KV cache,
or against a shared pool of KV pages, through Hopper kernels.

Ports of :func:`repro.kernels.decode_attention.decode_attention` and
:func:`~repro.kernels.decode_attention.paged_decode_attention` (the Pallas
kernels ``_decode_kernel`` and ``_paged_decode_kernel``), and of the
``paginate_kv`` helper that lays a dense cache out as pages.  The CUDA
source is ``repro_torch/csrc/decode_attention.cu``: one body serves both
layouts, and its header comment gives the design and what bounds it on
the H100 (the cache bytes it reads).

A tensor on the CPU is computed by the plain versions,
:func:`repro_torch.kernels.ref.decode_attention` and
:func:`~repro_torch.kernels.ref.paged_decode_attention`.  A CUDA tensor
goes to the kernel, or the call raises: there is no fallback.  ``q`` and
the cache (or pool) may each be float32 or bfloat16, independently.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, launcher, stream_ptr

_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
              + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                 ctypes.c_int, ctypes.c_void_p])
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: float = 0.0, prefix: int = 0) -> torch.Tensor:
    """q: (B, H, D); k/v cache: (B, T, KV, D); lengths: (B,) int32."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths,
                                    window=window, softcap=softcap,
                                    scale=scale, prefix=prefix)
    B, H, D = q.shape
    _, T, KV, _ = k_cache.shape
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (k_cache, v_cache, lengths)):
        raise ValueError("decode_attention: all inputs must share one CUDA "
                         "device")
    if q.dtype not in _TYPES or k_cache.dtype not in _TYPES \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention: q {q.dtype}, k {k_cache.dtype},"
                        f" v {v_cache.dtype} not float32/bfloat16 with k "
                        "and v alike")
    if lengths.dtype != torch.int32:
        raise TypeError("decode_attention: lengths must be int32")
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or KV == 0 or H % KV
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k_cache.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if D > 256 or T < 1:
        raise ValueError(f"decode_attention: needs D <= 256 and T >= 1, "
                         f"got D={D}, T={T}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("decode_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = launcher("decode_attention", _ARGTYPES)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k_cache.dtype == torch.bfloat16), B, H, KV, T, D,
        float(scale or D ** -0.5), int(window), float(softcap), int(prefix),
        stream_ptr(dev))
    check_launch("decode_attention", err)
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
    if q.device.type == "cpu":
        return ref.paged_decode_attention(
            q, k_pages, v_pages, page_table, lengths, window=window,
            softcap=softcap, scale=scale, prefix=prefix)
    B, H, D = q.shape
    P, KV, ps, _ = k_pages.shape
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (
            k_pages, v_pages, page_table, lengths)):
        raise ValueError("paged_decode_attention: all inputs must share one "
                         "CUDA device")
    if q.dtype not in _TYPES or k_pages.dtype not in _TYPES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_decode_attention: q {q.dtype}, k "
                        f"{k_pages.dtype}, v {v_pages.dtype} not "
                        "float32/bfloat16 with k and v alike")
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
    if D > 256 or min(P, ps, NP) < 1:
        raise ValueError(f"paged_decode_attention: needs D <= 256 and at "
                         f"least one page, row and table entry, got D={D}, "
                         f"P={P}, page_size={ps}, NP={NP}")
    if not all(t.is_contiguous()
               for t in (q, k_pages, v_pages, page_table, lengths)):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = launcher("decode_attention", _PAGED_ARGTYPES,
                   "paged_decode_attention_launch")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), int(k_pages.dtype == torch.bfloat16),
        B, H, KV, P, ps, NP, D, float(scale or D ** -0.5), int(window),
        float(softcap), int(prefix), stream_ptr(dev))
    check_launch("paged_decode_attention", err)
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
