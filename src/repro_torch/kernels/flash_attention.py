"""Prefill attention through a Hopper kernel.

Port of :func:`repro.kernels.flash_attention.flash_attention` (the Pallas
kernel ``_attn_kernel``): GQA, causal mask, sliding window with an
always-visible prefix, logit soft-capping and ``q_offset``.  The CUDA source
is ``repro_torch/csrc/flash_attention.cu``; its header comment gives the
design and what bounds it on the H100.  :func:`flash_plan` cuts a call
from its shapes alone: rows a block, whether a block takes all query heads
of one KV head, keys a tile.

A tensor on the CPU is computed by the plain version,
:func:`repro_torch.kernels.ref.flash_attention`.  A CUDA tensor goes to
the kernel, or the call raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, launcher, stream_ptr

_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_float] + [ctypes.c_int] * 7
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
THREADS = 128  # kThreads
_PADS = (32, 64, 128, 256)  # D is padded to one of these (a template)
_TILES = (16, 32, 64)  # keys a tile
SMEM_SM = 228 * 1024  # an SM's shared memory (H100), 1 KB more a block
H100_SMS = 132


def _smem(dp: int, rows: int, bk: int, esz: int, stages: int) -> int:
    """Shared bytes of one block: ``layout()`` in the source, which the
    launcher checks against this number."""
    return (4 * rows * (dp + 4 + bk + 4 + 4)
            + esz * 2 * stages * bk * (dp + 16 // esz))


def _fit(smem: int) -> int:
    """Blocks of ``smem`` bytes an SM holds by shared memory and threads."""
    return min(SMEM_SM // (smem + 1024), 2048 // THREADS)


class FlashPlan(NamedTuple):
    """How one call is cut (the launcher's arguments and what follows)."""
    dp: int  # D padded: 32, 64, 128 or 256
    rows: int  # rows a block: bq positions x heads, 64 (32 at dp = 256)
    bq: int  # query positions a block
    heads: int  # query heads a block: 1, or the H / KV of one KV head
    bk: int  # keys a tile: 16, 32 or 64
    stages: int  # K/V staging buffers: 1 when one tile holds every key
    threads: int  # threads a block
    smem: int  # dynamic shared bytes a block
    sm_blocks: int  # blocks an SM holds by shared memory and threads
    blocks: int  # blocks of the grid


@functools.lru_cache(maxsize=None)
def flash_plan(B: int, S: int, T: int, H: int, KV: int, D: int,
               dtype: torch.dtype, sms: int = H100_SMS) -> FlashPlan:
    """Cut a call of q (B, S, H, D) against k, v (B, T, KV, D) in
    ``dtype`` (k's and v's) for a card of ``sms`` SMs, from shapes alone.

    A block holds 64 rows of the accumulator (32 at D = 256, where a
    row's 256 columns spread over 16 threads).  It groups the G = H / KV
    query heads of one KV head (64 / G positions each, so every K/V tile
    is staged once for G heads) only where that grid still has a block for
    every SM; otherwise it takes 64 positions of one head, which gives G
    times the blocks.  At the serving prefill (12 tokens) the grouped grid
    has 32 (tinyllama-1.1b) and 16 (gemma2-2b) blocks against 128 and 32
    a head at a time, so it keeps one head a block; the replay's prompts of
    1024 and 4200 tokens group (2048 and 2104 blocks).  Keys come in tiles
    of the fewest of 16, 32, 64 that hold all T (one stage), else of the
    most whose two-stage ring leaves room for two blocks an SM."""
    dp = next(d for d in _PADS if D <= d)
    rows = 32 if dp == 256 else 64
    G = H // KV
    esz = 2 if dtype == torch.bfloat16 else 4
    bq, heads = rows, 1
    if 1 < G <= rows and B * KV * math.ceil(S / (rows // G)) >= sms:
        bq, heads = rows // G, G
    if T <= _TILES[-1]:
        bk = next(t for t in _TILES if T <= t)
        stages = 1
    else:
        bk = next((t for t in reversed(_TILES)
                   if _fit(_smem(dp, rows, t, esz, 2)) >= 2), _TILES[0])
        stages = 2
    smem = _smem(dp, rows, bk, esz, stages)
    blocks = B * (KV if heads > 1 else H) * math.ceil(S / bq)
    return FlashPlan(dp, rows, bq, heads, bk, stages, THREADS, smem,
                     _fit(smem), blocks)


@functools.lru_cache(maxsize=None)
def _launcher():
    return launcher("flash_attention", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    plan = flash_plan(B, S, T, H, KV, D, k.dtype, _sms(dev.index))
    aligned = (D * k.element_size() % 16 == 0 and k.data_ptr() % 16 == 0
               and v.data_ptr() % 16 == 0)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        B, S, T, H, KV, D, float(scale or D ** -0.5), int(causal),
        int(window), float(softcap), int(prefix), int(q_offset), plan.dp,
        plan.bq, plan.heads, plan.bk, plan.stages, plan.smem, int(aligned),
        int(D % 4 == 0 and q.data_ptr() % 16 == 0), stream_ptr(dev))
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
