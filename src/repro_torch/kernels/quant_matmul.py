"""Quantized matmul: ``y = x @ (w_q * scale)`` through a Hopper kernel.

Port of :func:`repro.kernels.quant_matmul.quant_matmul` (the Pallas kernel
``_qmm_kernel``).  The CUDA source is ``repro_torch/csrc/quant_matmul.cu``;
its header comment gives the design and what bounds it on the H100 (the
weight bytes at decode, the f32 multiply-adds at prefill).  Each call is
one launch: the blocks that split K form one thread-block cluster and add
their partials through distributed shared memory, so the wrapper
allocates only the output.  :func:`qmm_plan` cuts a call from its shapes
alone.

A tensor on the CPU or on ``meta`` is computed by the plain version,
:func:`repro_torch.kernels.ref.quant_matmul`.  A CUDA tensor goes to the
kernel, or the call raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import (check_launch, launcher,
                                      refuse_grad, stream_ptr)

_MAX_M = 64  # rows of x one block takes
# Threads a block may have and blocks an SM holds: at decode (MT = 4),
# and above.  The plan is cut to them, and the kernel is built with them
# (its register cap and its ring of stages), so this is their one home.
_THREADS = (128, 192)
_SM_BLOCKS = (3, 2)
NVCC_DEFINES = {"QMM_THREADS_DECODE": _THREADS[0],
                "QMM_THREADS_PREFILL": _THREADS[1],
                "QMM_BLOCKS_DECODE": _SM_BLOCKS[0],
                "QMM_BLOCKS_PREFILL": _SM_BLOCKS[1]}
_CLUSTERS = (1, 2, 4, 8)
_OUT_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 12 + [ctypes.c_void_p])


class QmmPlan(NamedTuple):
    """How one call is cut (the launcher's arguments)."""
    bn: int  # columns of a block: 64 or 128
    cluster: int  # S: blocks splitting K, one thread-block cluster
    rows: int  # rows of K a split takes, a multiple of the group
    m_chunk: int  # rows of x a block takes, at most 64
    mt: int  # rows of x a thread holds: 4 at decode (M <= 4), else 16
    ks: int  # slices of a tile's rows (128 at decode, else 64)

    @property
    def threads(self) -> int:
        return self.bn // 4 * math.ceil(self.m_chunk / self.mt) * self.ks


@functools.lru_cache(maxsize=None)
def qmm_plan(M: int, K: int, N: int, group: int, sms: int) -> QmmPlan:
    """Cut an (M, K) @ (K, N) call with quantization group ``group`` for a
    card of ``sms`` SMs, from the shapes alone.

    Aims at about two blocks an SM: 128-column tiles where they give
    enough blocks with 8 splits, else 64; then the fewest splits S in
    {1, 2, 4, 8} that reach 2 * sms blocks, no more than the groups allow,
    with no split left empty, and no more blocks than the card holds at
    once.  Splits cut K at group multiples; the
    last may be shorter."""
    m_chunk = min(M, _MAX_M)
    mt = 4 if M <= 4 else 16
    m_tiles = math.ceil(M / m_chunk)
    want = 2 * sms
    if mt == 4:
        bn = 128 if math.ceil(N / 128) * _CLUSTERS[-1] >= want else 64
    else:  # 64-column tiles unless x is cut into chunks (and read again)
        bn = 64 if m_tiles == 1 else 128
    tiles = math.ceil(N / bn) * m_tiles
    G = K // group
    S = next((s for s in _CLUSTERS if tiles * s >= want), _CLUSTERS[-1])
    # Blocks the card runs at once: _SM_BLOCKS an SM, less a tenth, since
    # a cluster's blocks share one GPC and clusters of 8 cannot fill
    # every SM of one.  More blocks would run in a second wave.
    fit = sms * _SM_BLOCKS[mt > 4] * 9 // 10
    while S > 1 and (S > G or math.ceil(G / S) * (S - 1) >= G
                     or tiles * S > fit):
        S //= 2
    rg = math.ceil(m_chunk / mt)
    ks = 1
    while ks * 2 * rg * (bn // 4) <= _THREADS[mt > 4] and ks * 2 <= 16:
        ks *= 2
    return QmmPlan(bn, S, math.ceil(G / S) * group, m_chunk, mt, ks)


@functools.lru_cache(maxsize=None)
def _launcher():
    return launcher("quant_matmul", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                 *, out_dtype=None) -> torch.Tensor:
    """x: (..., K) f32/bf16; w_q: (K, N) int8; scales: (K/group, N) f32."""
    if x.device.type in ref.PLAIN_DEVICES:
        return ref.as_kernel(ref.quant_matmul, x, w_q, scales,
                             out_dtype=out_dtype)
    refuse_grad("quant_matmul", "ROADMAP A9: training runs dense master "
                "weights; the zoo's quantized variants only serve", x,
                scales)
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
    if not (w_q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("quant_matmul: w_q and scales must be contiguous")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():
        raise ValueError("quant_matmul: x must be contiguous")
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0:
        return out.reshape(*lead, N)
    group = K // G
    # The TMA path needs 16-byte row strides and bases, and splits that
    # end on whole 4-row steps; anything else takes the element-wise
    # variant.
    aligned = (N % 16 == 0 and K % 8 == 0 and group % 8 == 0
               and all(t.data_ptr() % 16 == 0 for t in (x2, w_q, scales)))
    plan = qmm_plan(M, K, N, group, _sms(dev.index))
    err = _launcher()(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), w_q.data_ptr(),
        scales.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        M, K, N, group, plan.bn, plan.cluster, plan.rows, plan.m_chunk,
        plan.mt, plan.ks, int(aligned), stream_ptr(dev))
    check_launch("quant_matmul", err)
    quant_matmul.launches += 1
    return out.reshape(*lead, N)


quant_matmul.launches = 0
