"""Decode attention: one query token per sequence against a dense KV cache,
through a Hopper kernel.

Port of :func:`repro.kernels.decode_attention.decode_attention` (the Pallas
kernel ``_decode_kernel``).  The CUDA source is
``repro_torch/csrc/decode_attention.cu``; its header comment gives the
design and what bounds it on the H100 (the cache bytes it reads).  The
paged variant, ``paged_decode_attention``, is not ported yet.

A tensor on the CPU is computed by the plain version,
:func:`repro_torch.kernels.ref.decode_attention`.  A CUDA tensor goes to
the kernel, or the call raises: there is no fallback.  ``q`` and the cache
may each be float32 or bfloat16, independently.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, launcher, stream_ptr

_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
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
