"""Quantized matmul: ``y = x @ (w_q * scale)`` through a Hopper kernel.

Port of :func:`repro.kernels.quant_matmul.quant_matmul` (the Pallas kernel
``_qmm_kernel``).  The CUDA source is ``repro_torch/csrc/quant_matmul.cu``;
its header comment gives the design and what bounds it on the H100 (the
weight bytes: it streams int8 weights at decode).

A tensor on the CPU is computed by the plain version,
:func:`repro_torch.kernels.ref.quant_matmul`.  A CUDA tensor goes to the
kernel, or the call raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, launcher, stream_ptr

_KC_MAX = 256  # rows of K one block stages (kKcMax in the source)
_BN = 128  # columns per block (kBN in the source)
_OUT_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
              + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def split_k(M: int, K: int, N: int, sms: int) -> tuple[int, int]:
    """(splits, rows per split) so that about four blocks per SM are in
    flight, each split stages at most 256 rows of K, and none is shorter
    than 64 rows unless K itself is.  Blocks tile M by 4 rows at decode
    (M <= 4) and by 8 otherwise, as the source does."""
    tiles = math.ceil(N / _BN) * math.ceil(M / (4 if M <= 4 else 8))
    want = math.ceil(4 * sms / tiles)
    splits = max(math.ceil(K / _KC_MAX), min(want, max(1, K // 64)))
    kc = math.ceil(K / splits)
    return math.ceil(K / kc), kc


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                 *, out_dtype=None) -> torch.Tensor:
    """x: (..., K) f32/bf16; w_q: (K, N) int8; scales: (K/group, N) f32."""
    if x.device.type == "cpu":
        return ref.quant_matmul(x, w_q, scales, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    K, N = w_q.shape
    G = scales.shape[0]
    dev = x.device
    if dev.type != "cuda" or w_q.device != dev or scales.device != dev:
        raise ValueError("quant_matmul: x, w_q and scales must share one "
                         "CUDA device")
    if x.dtype not in _OUT_TYPES or out_dtype not in _OUT_TYPES:
        raise TypeError(f"quant_matmul: x {x.dtype} / out {out_dtype} not "
                        "float32 or bfloat16")
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("quant_matmul: w_q must be int8 and scales float32")
    if x.shape[-1] != K or scales.ndim != 2 or scales.shape[1] != N \
            or G == 0 or K % G:
        raise ValueError(f"quant_matmul: shapes x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scales {tuple(scales.shape)}")
    if N % 4:
        raise ValueError(f"quant_matmul: N={N} is not a multiple of 4")
    if not (w_q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("quant_matmul: w_q and scales must be contiguous")
    if w_q.data_ptr() % 4 or scales.data_ptr() % 16:
        raise ValueError("quant_matmul: w_q must be 4-byte and scales "
                         "16-byte aligned")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():
        raise ValueError("quant_matmul: x must be contiguous")
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0:
        return out.reshape(*lead, N)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, kc = split_k(M, K, N, sms)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
    err = launcher("quant_matmul", _ARGTYPES)(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), w_q.data_ptr(),
        scales.data_ptr(), part.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), M, K, N, K // G, splits, kc,
        stream_ptr(dev))
    check_launch("quant_matmul", err)
    quant_matmul.launches += 1
    return out.reshape(*lead, N)


quant_matmul.launches = 0
