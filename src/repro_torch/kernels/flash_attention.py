"""Prefill attention through a Hopper kernel.

Port of :func:`repro.kernels.flash_attention.flash_attention` (the Pallas
kernel ``_attn_kernel``): GQA, causal mask, sliding window with an
always-visible prefix, logit soft-capping and ``q_offset``.  The CUDA source
is ``repro_torch/csrc/flash_attention.cu``; its header comment gives the
design and what bounds it on the H100.

A tensor on the CPU is computed by the plain version,
:func:`repro_torch.kernels.ref.flash_attention`.  A CUDA tensor goes to
the kernel, or the call raises: there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, launcher, stream_ptr

_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
              + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = 0.0,
                    q_offset: int = 0, prefix: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KV, D).  Output like q."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset, prefix=prefix)
    B, S, H, D = q.shape
    _, T, KV, _ = k.shape
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k and v must share one CUDA "
                         "device")
    if q.dtype not in _TYPES or k.dtype not in _TYPES or v.dtype != k.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype} not float32/bfloat16 with k and v alike")
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or KV == 0 or H % KV):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}")
    if D > 256 or T < 1:
        raise ValueError(f"flash_attention: needs D <= 256 and T >= 1, got "
                         f"D={D}, T={T}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    err = launcher("flash_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        B, S, T, H, KV, D, float(scale or D ** -0.5), int(causal),
        int(window), float(softcap), int(prefix), int(q_offset),
        stream_ptr(dev))
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
