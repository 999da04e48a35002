"""Prefill attention through a Hopper kernel, and its gradient.

Port of :func:`repro.kernels.flash_attention.flash_attention` (the Pallas
kernel ``_attn_kernel``): GQA, causal mask, sliding window with an
always-visible prefix, logit soft-capping and ``q_offset``.  The CUDA source
is ``repro_torch/csrc/flash_attention.cu``; its header comment gives the
design and what bounds it on the H100.  :func:`flash_plan` cuts a call
from its shapes alone: rows a block, whether a block takes all query heads
of one KV head, keys a tile.

Training differentiates the call.  The Pallas kernel has no backward (the
reference trains through inline ``jnp`` attention); the port's is a kernel
of its own, ``repro_torch/csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`, cut by :func:`flash_bwd_plan`): on the
tensor cores where q, k and v are all bf16, on the CUDA cores where any
is f32.  When an input requires grad under grad mode,
:func:`flash_attention` runs as a ``torch.autograd.Function`` whose
forward is the same kernel, also writing each row's log-sum-exp, and
whose backward is that kernel.

A tensor on the CPU or on ``meta`` is computed by the plain versions,
:func:`repro_torch.kernels.ref.flash_attention` and
:func:`~repro_torch.kernels.ref.flash_attention_bwd`, through the same
Function, each counted by :func:`~repro_torch.kernels.ref.as_kernel` as
the kernel it stands for.  A CUDA tensor goes to the kernels, or the
call raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import placed, ref
from repro_torch.kernels.build import check_launch, launcher, stream_ptr

_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_float] + [ctypes.c_int] * 7
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
THREADS = 128  # kThreads
_PADS = (32, 64, 128, 256)  # D is padded to one of these (a template)
_TILES = (16, 32, 64)  # keys a tile
SMEM_SM = 228 * 1024  # an SM's shared memory (H100), 1 KB more a block
H100_SMS = 132
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float] + [ctypes.c_int] * 4
                 + [ctypes.c_longlong, ctypes.c_void_p])
BWD_THREADS = 256  # kThreads of flash_attention_bwd.cu (the f32 path)


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


class FlashBwdPlan(NamedTuple):
    """How the backward cuts a call (both of its kernels)."""
    path: str  # "bf16" (tensor cores: q, k, v all bf16) or "f32" (CUDA cores)
    dp: int  # D padded: 64, 128 or 256
    big: int  # keys a dK/dV block; query rows a dQ block
    small: int  # query rows a dK/dV step; keys a dQ step
    col_split: int  # warps sharing 16 rows by columns (bf16); 1 on f32
    stages: int  # buffers of the streamed tiles: 2 (cp.async ring) or 1
    head_split: int  # dK/dV blocks (a cluster) sharing a KV head's heads
    threads: int  # threads a block
    smem: int  # dynamic shared bytes a block (both kernels)
    sm_blocks: int  # blocks an SM holds by shared memory and threads
    q_blocks: int  # blocks of the dQ kernel's grid
    kv_blocks: int  # blocks of the dK/dV kernel's grid


# The bf16 path's tiles by D padded (``Tiles`` in the source): own rows a
# block, streamed rows a tile, warps sharing 16 rows by columns.
_BWD16_TILES = {64: (64, 64, 1), 128: (64, 32, 2), 256: (64, 64, 2)}


def _bwd_smem(dp: int, big: int, small: int) -> int:
    """Shared bytes of one f32-path backward block: ``layout()`` in
    ``flash_attention_bwd.cu``, which the launcher checks against this."""
    ld = dp + 4
    return 4 * (2 * big * ld + 2 * small * ld + 2 * small * (big + 4)
                + 2 * big + dp)


def _bwd16_smem(dp: int) -> int:
    """Shared bytes of one bf16-path backward block, either kernel:
    ``layout16()`` in ``flash_attention_bwd.cu`` (own and streamed bf16
    tiles at a stride of D padded + 8, the latter in two stages; P and dS
    when warps split the columns; lse and Delta; the empty rows' dO; the
    split blocks' f32 sums over the tiles after the loop)."""
    ro, rt, cw = _BWD16_TILES[dp]
    ldt = dp + 8
    o = 2 * (2 * ro * ldt + 4 * rt * ldt + (2 * ro * (rt + 8) if cw > 1
                                             else 0))
    o += 4 * (max(4 * rt, 2 * ro) + dp)
    return max(o, 4 * 2 * ro * (dp + 8))


def head_split(G: int, blocks: int, sms: int) -> int:
    """The dK/dV kernel's head split (``head_split`` in the source): the
    smallest divisor of G, at most 8 (a portable cluster), that gives the
    grid four blocks an SM, else the largest."""
    hs = 1
    for d in range(1, min(G, 8) + 1):
        if G % d == 0:
            hs = d
            if blocks * d >= 4 * sms:
                break
    return hs


@functools.lru_cache(maxsize=None)
def flash_bwd_plan(B: int, S: int, T: int, H: int, KV: int, D: int,
                   bf16: bool = False, sms: int = H100_SMS) -> FlashBwdPlan:
    """Cut the backward of q (B, S, H, D) against k, v (B, T, KV, D) from
    shapes alone, on the bf16 path (``bf16``: q, k and v all bfloat16,
    every training call) or the f32 path.  D pads to 64, 128 or 256
    (columns past D are zeros).

    bf16: own rows a block (keys of a dK/dV block, query rows of a dQ
    block) and streamed rows a tile are 64 and 64 at D <= 64 (4 warps,
    one 16-row slice each), 64 and 32 at D <= 128 and 64 and 64 at D =
    256 (8 warps, 2 to a slice by columns); streamed tiles in a two-stage
    ring; the dK/dV grid split over a KV head's query heads until it
    holds four blocks an SM (``head_split``).

    f32: every operand staged as float32, so BIG keys a dK/dV block
    (query rows a dQ block) and SMALL query rows a step (keys a step) are
    64 and 64 at D <= 64, 64 and 32 at D <= 128, and 32 and 32 at D =
    256, which keep a block's shared memory within the card's 227 KB (two
    blocks an SM at D <= 64)."""
    if D > 256:
        raise ValueError(f"flash_attention_bwd: needs D <= 256, got {D}")
    dp = next(d for d in (64, 128, 256) if D <= d)
    if bf16:
        big, small, cw = _BWD16_TILES[dp]
        threads, stages, smem = 32 * big // 16 * cw, 2, _bwd16_smem(dp)
    else:
        big = 32 if dp == 256 else 64
        small = 64 if dp == 64 else 32
        cw, threads, stages = 1, BWD_THREADS, 1
        smem = _bwd_smem(dp, big, small)
    kv_tiles = B * KV * math.ceil(T / big)
    hs = head_split(H // KV, kv_tiles, sms) if bf16 else 1
    return FlashBwdPlan("bf16" if bf16 else "f32", dp, big, small, cw,
                        stages, hs, threads, smem,
                        min(SMEM_SM // (smem + 1024), 2048 // threads),
                        B * H * math.ceil(S / big), kv_tiles * hs)


@functools.lru_cache(maxsize=None)
def has_empty_rows(S: int, T: int, causal: bool, window: int, prefix: int,
                   q_offset: int) -> bool:
    """Whether a query row of the call sees no key at all (the forward
    gives it the mean of v over all T; its gradient goes to every key's
    dV): visible keys are [lo, hi) and, under a window, the prefix
    before lo."""
    p = q_offset + np.arange(S)
    hi = np.minimum(T, p + 1) if causal else np.full(S, T)
    lo = np.maximum(0, p - window + 1) if window else np.zeros(S, np.int64)
    seen = np.maximum(hi - lo, 0)
    if window:
        seen = seen + np.maximum(np.minimum(np.minimum(prefix, lo), hi), 0)
    return bool(np.any(seen == 0))


@functools.lru_cache(maxsize=None)
def _launcher():
    return launcher("flash_attention", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    return launcher("flash_attention_bwd", _BWD_ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> None:
    """Raise on inputs the kernels cannot take."""
    B, S, H, D = q.shape
    _, T, KV, _ = k.shape
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{name}: q, k and v must share one CUDA device")
    if q.dtype not in _TYPES or k.dtype not in _TYPES or v.dtype != k.dtype:
        raise TypeError(f"{name}: q {q.dtype}, k {k.dtype}, v {v.dtype} not "
                        "float32/bfloat16 with k and v alike")
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or KV == 0 or H % KV):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}")
    if D > 256 or T < 1:
        raise ValueError(f"{name}: needs D <= 256 and T >= 1, got D={D}, "
                         f"T={T}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def _forward(q, k, v, kw: dict, with_lse: bool):
    """The forward kernel's launch: (out, lse (B, H, S) float32 or None).
    On the CPU and ``meta`` the plain version, lse None (the plain
    backward does not read it)."""
    if q.device.type in ref.PLAIN_DEVICES:
        lse_bytes = 4 * q.shape[0] * q.shape[2] * q.shape[1]
        return ref.as_kernel(ref.flash_attention, q, k, v, **kw,
                             extra_bytes=lse_bytes if with_lse else 0), None
    _check("flash_attention", q, k, v)
    B, S, H, D = q.shape
    _, T, KV, _ = k.shape
    dev = q.device
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    if B == 0 or S == 0:
        return out, lse
    plan = flash_plan(B, S, T, H, KV, D, k.dtype, _sms(dev.index))
    aligned = (D * k.element_size() % 16 == 0 and k.data_ptr() % 16 == 0
               and v.data_ptr() % 16 == 0)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        B, S, T, H, KV, D, float(kw["scale"] or D ** -0.5),
        int(kw["causal"]), int(kw["window"]), float(kw["softcap"]),
        int(kw["prefix"]), int(kw["q_offset"]), plan.dp, plan.bq,
        plan.heads, plan.bk, plan.stages, plan.smem, int(aligned),
        int(D % 4 == 0 and q.data_ptr() % 16 == 0), stream_ptr(dev))
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out, lse


class _Attention(torch.autograd.Function):
    """The kernel's forward (with each row's log-sum-exp) and backward."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = _forward(q, k, v, kw, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.kw)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = 0.0,
                    q_offset: int = 0, prefix: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KV, D).  Output like q.
    Differentiable through :func:`flash_attention_bwd` when an input
    requires grad, on every device.  A ``DTensor`` q runs each rank's
    heads (:mod:`.placed`; serving only)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, prefix=prefix)
    if placed.is_placed(q):
        return placed.flash_attention(flash_attention, q, k, v, kw)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, kw)
    return _forward(q, k, v, kw, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the forward and each row's log-sum-exp (B, H, S)
    float32 of its capped, masked scores, -inf for a row that sees no key;
    what the backward reads.  Plain version on the CPU and ``meta``."""
    kw = dict(dict(causal=True, window=0, softcap=0.0, scale=0.0,
                   q_offset=0, prefix=0), **kw)
    if q.device.type in ref.PLAIN_DEVICES:
        return ref.as_kernel(ref.flash_attention_lse, q, k, v, **kw)
    return _forward(q, k, v, kw, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: float = 0.0, q_offset: int = 0,
                        prefix: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``dout``, given its ``out`` and ``lse`` (:func:`flash_attention_lse`);
    each in its input's type.  On the CPU and ``meta`` the plain version:
    autograd through :func:`repro_torch.kernels.ref.flash_attention`
    (``out`` and ``lse`` unused)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, prefix=prefix)
    if q.device.type in ref.PLAIN_DEVICES:
        out_lse = (q.numel() * q.element_size()
                   + 4 * q.shape[0] * q.shape[2] * q.shape[1])
        return ref.as_kernel(ref.flash_attention_bwd, q, k, v, dout, **kw,
                             extra_bytes=out_lse)  # the kernel reads both
    _check("flash_attention_bwd", q, k, v)
    B, S, H, D = q.shape
    _, T, KV, _ = k.shape
    dev = q.device
    if q_offset < 0 or window < 0:
        raise ValueError(f"flash_attention_bwd: needs q_offset >= 0 and "
                         f"window >= 0, got {q_offset}, {window}")
    if (out.shape != q.shape or out.dtype != q.dtype
            or tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32
            or any(t.device != dev for t in (out, dout, lse))):
        raise ValueError("flash_attention_bwd: out must be like q and lse "
                         "(B, H, S) float32, on q's device")
    dout = dout.to(q.dtype).contiguous()
    out, lse = out.contiguous(), lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B == 0 or S == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    plan = flash_bwd_plan(B, S, T, H, KV, D, bool(
        q.dtype == k.dtype == torch.bfloat16), _sms(dev.index))
    err = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), B, S, T, H, KV, D,
        float(scale or D ** -0.5), int(causal), int(window), float(softcap),
        int(prefix), int(q_offset),
        int(has_empty_rows(S, T, bool(causal), int(window), int(prefix),
                           int(q_offset))),
        plan.dp, plan.smem, stream_ptr(dev))
    check_launch("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
