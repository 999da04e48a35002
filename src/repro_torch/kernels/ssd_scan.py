"""Mamba-2 SSD scan (chunked state-space duality) through a Hopper kernel,
and its gradient.

Port of :func:`repro.kernels.ssd_scan.ssd_scan` (the Pallas kernel
``_ssd_kernel``).  The CUDA source is ``repro_torch/csrc/ssd_scan.cu``;
its header comment gives the design and what bounds it on the H100.  A
call is one launch of thread-block clusters: the blocks that take the
16-column slices of one head's P share its decay block through
distributed shared memory.  :func:`ssd_plan` cuts a call from its shapes
alone (the chunk the kernel runs, whatever ``chunk`` the caller names:
the result depends on the chunk only through rounding).

Training differentiates the call.  The Pallas kernel has no backward (the
reference trains through ``jax.grad`` of the chunked form); the port's is
a kernel of its own, ``repro_torch/csrc/ssd_scan_bwd.cu``
(:func:`ssd_scan_bwd`, cut by :func:`ssd_bwd_plan`).  When a CUDA input
requires grad under grad mode, :func:`ssd_scan` runs as a
``torch.autograd.Function`` whose forward is the same kernel and whose
backward is that kernel; it saves only the inputs.

A tensor on the CPU is computed by the plain version,
:func:`repro_torch.kernels.ref.ssd_scan_chunked` at ``chunk``, which
autograd differentiates.  A CUDA tensor goes to the kernels, or the call
raises: there is no fallback.  ``x``, ``dt``, ``Bm`` and ``Cm`` share one
type, float32 or bfloat16; ``A``, ``D`` and ``init_state`` are taken as
float32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, launcher, stream_ptr

_TYPES = (torch.float32, torch.bfloat16)
MAX_P, MAX_N = 64, 128  # kMaxP, kMaxN in the source
PS = 16  # columns of P a block takes (kPS)
# Blocks an SM must hold at each chunk: the plan is cut to them and the
# kernel's register cap is built with them, so this is their one home.
_SM_BLOCKS = {16: 7, 32: 2, 64: 2}
NVCC_DEFINES = {f"SSD_BLOCKS_Q{q}": n for q, n in _SM_BLOCKS.items()}
SMEM_SM = 228 * 1024  # an SM's shared memory (H100), 1 KB more a block
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 4
                 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
BWD_THREADS = 256  # kThreads of ssd_scan_bwd.cu
_BWD_VECS = 10  # kVecs: per-row vectors of the chunk


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _threads(kq: int) -> int:
    """Threads a block at chunk ``kq`` (``threads_of`` in the source)."""
    return 128 if kq == 16 else 256


def _smem(kq: int, N: int, esz: int, stages: int) -> int:
    """Shared bytes of one block: ``layout()`` in the source, which the
    launcher checks against this number."""
    per16 = 16 // esz
    floats = (PS * (_round_up(N, 4) + 4)  # state slice
              + stages * kq * (kq + 4)  # M, a buffer a stage
              + PS * (kq + 4) + kq * PS  # x^T and x w as float32
              + kq * PS  # y_off
              + 2 * kq  # dt, two buffers
              + _threads(kq) // 32 * kq)  # each warp's a_cum
    raw = stages * kq * (2 * (_round_up(N, per16) + per16) + PS)
    return 4 * floats + esz * raw


def _fit(smem: int, threads: int) -> int:
    """Blocks of ``smem`` bytes and ``threads`` threads an SM holds by
    shared memory and threads."""
    return min(SMEM_SM // (smem + 1024), 2048 // threads)


class SsdPlan(NamedTuple):
    """How one call is cut (the launcher's arguments and what follows)."""
    kq: int  # chunk: rows of a tile, 16, 32 or 64
    ps: int  # columns of P a block takes
    cluster: int  # blocks a head (1, 2 or 4), one thread-block cluster
    stages: int  # staging buffers: 1 when one chunk holds the prompt
    threads: int  # threads a block
    smem: int  # dynamic shared bytes a block
    sm_blocks: int  # blocks an SM holds (shared memory, register cap)
    blocks: int  # blocks of the grid


@functools.lru_cache(maxsize=None)
def ssd_plan(B: int, S: int, H: int, P: int, G: int, N: int,
             dtype: torch.dtype) -> SsdPlan:
    """Cut a scan of x (B, S, H, P), B and C (B, S, G, N) in ``dtype``
    from the shapes alone.

    The chunk is the smallest of 16 and 32 rows that holds the prompt (a
    12-token prompt takes 16-row tiles, one chunk, one stage); a longer
    prompt takes 64-row chunks where their two-stage ring leaves room for
    two blocks an SM, else 32 (mamba2-780m's N = 128 in float32).  A
    block has 128 threads at 16 rows, where seven share an SM, and 256
    above, where one or two do and more warps shorten each phase.  P is
    cut in slices of 16 columns, one block each, the slices of a head one
    cluster of 1, 2 or 4 blocks (a slice past P only computes its rows of
    the decay block).  G only has to divide H: B and C of a group are
    read by each of its heads."""
    esz = 2 if dtype == torch.bfloat16 else 4
    cluster = 1 if P <= PS else 2 if P <= 2 * PS else 4
    if S <= 16:
        kq = 16
    elif (S <= 32
          or _fit(_smem(64, N, esz, 2), _threads(64)) < _SM_BLOCKS[64]):
        kq = 32
    else:
        kq = 64
    stages = 1 if S <= kq else 2
    smem = _smem(kq, N, esz, stages)
    threads = _threads(kq)
    return SsdPlan(kq, PS, cluster, stages, threads, smem,
                   min(_fit(smem, threads), _SM_BLOCKS[kq]),
                   cluster * H * B)


class SsdBwdPlan(NamedTuple):
    """How the backward cuts a call."""
    kq: int  # chunk: rows of a tile, 16, 32 or 64
    threads: int  # threads a block
    smem: int  # dynamic shared bytes a block
    sm_blocks: int  # blocks an SM holds by shared memory and threads
    blocks: int  # blocks of the grid: one a (head, sequence)
    chunks: int  # chunks a sequence, each a step of both passes


def _bwd_smem(kq: int, P: int, N: int) -> int:
    """Shared bytes of one backward block: ``layout()`` in
    ``ssd_scan_bwd.cu``, which the launcher checks against this.  Every
    tile is float32 with an odd row stride: the entry state and its
    cotangent (P, N); x, dy and g B (kq, P); B, C and one scratch
    (kq, N); three (kq, kq) blocks; the per-row vectors."""
    lq, lp, ln = kq | 1, P | 1, N | 1
    return 4 * (2 * P * ln + 3 * kq * lp + 3 * kq * ln + 3 * kq * lq
                + _BWD_VECS * kq + 64)


@functools.lru_cache(maxsize=None)
def ssd_bwd_plan(B: int, S: int, H: int, P: int, G: int,
                 N: int) -> SsdBwdPlan:
    """Cut the backward of a scan of x (B, S, H, P), B and C (B, S, G, N)
    from the shapes alone (every operand is staged as float32, so the
    types do not enter).  One block takes a (head, sequence).  The chunk
    is the largest of 64, 32 and 16 rows whose block leaves room for two
    an SM (16 at mamba2-780m's N = 128, 32 at hymba-1.5b's N = 16), and no
    larger than the smallest of them that holds the sequence."""
    fits = [q for q in (64, 32, 16)
            if _fit(_bwd_smem(q, P, N), BWD_THREADS) >= 2]
    kq = min(fits[0] if fits else 16,
             next((q for q in (16, 32) if S <= q), 64))
    smem = _bwd_smem(kq, P, N)
    return SsdBwdPlan(kq, BWD_THREADS, smem, _fit(smem, BWD_THREADS),
                      B * H, -(-S // kq))


@functools.lru_cache(maxsize=None)
def _launcher():
    return launcher("ssd_scan", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    return launcher("ssd_scan_bwd", _BWD_ARGTYPES)


def _aligned(esz: int, P: int, N: int, *pairs) -> bool:
    """Whether every (tensor, row stride) pair, P and N are whole multiples
    of 16 bytes: the kernel's cp.async staging."""
    return (P * esz % 16 == 0 and N * esz % 16 == 0
            and all(t.data_ptr() % 16 == 0 and rs * esz % 16 == 0
                    for t, rs in pairs))


def _rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` (B, S, ...) and the stride between its (b, s) rows, for a
    tensor whose rows are evenly strided and contiguous within (a column
    slice of a wider (B, S, C) tensor is); any other tensor is copied to
    a contiguous one first."""
    inner = t.shape[2:]
    want = []
    step = 1
    for n in reversed(inner):
        want.insert(0, step)
        step *= n
    rs = t.stride(1)
    if (list(t.stride()[2:]) != want or rs < step
            or (t.shape[0] > 1 and t.stride(0) != t.shape[1] * rs)):
        t = t.contiguous()
        rs = step
    return t, rs




def _check(name: str, x, dt, A, Bm, Cm, D, init_state) -> None:
    """Raise on inputs the kernels cannot take."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = x.device
    tensors = (dt, A, Bm, Cm, D) + ((init_state,) if init_state is not None
                                    else ())
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must share one CUDA device")
    if x.dtype not in _TYPES or any(t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"{name}: x {x.dtype}, dt {dt.dtype}, Bm "
                        f"{Bm.dtype}, Cm {Cm.dtype} not all float32 or all "
                        "bfloat16")
    if A.dtype not in _TYPES or D.dtype not in _TYPES:
        raise TypeError(f"{name}: A {A.dtype} / D {D.dtype} not float32 "
                        "or bfloat16")
    if (tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,) or tuple(Bm.shape) != (Bb, S, G, N)
            or Cm.shape != Bm.shape or G == 0 or H % G
            or (init_state is not None
                and tuple(init_state.shape) != (Bb, H, P, N))):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm/Cm "
                         f"{tuple(Bm.shape)}/{tuple(Cm.shape)}, D "
                         f"{tuple(D.shape)}")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"{name}: needs 1 <= P <= {MAX_P} and 1 <= N <= "
                         f"{MAX_N} (the state lives in shared memory), got "
                         f"P={P}, N={N}")


def _forward(x, dt, A, Bm, Cm, D, init_state, return_state: bool):
    """The forward kernel's launch: (y, final state float32 or None)."""
    _check("ssd_scan", x, dt, A, Bm, Cm, D, init_state)
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = x.device
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev)
    state = (torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
             if return_state else None)
    if Bb == 0 or S == 0:
        if state is not None:
            state.zero_() if init_state is None else state.copy_(init_state)
        return y, state
    x, x_rs = _rows(x)
    dt, dt_rs = _rows(dt)
    Bm, b_rs = _rows(Bm)
    Cm, c_rs = _rows(Cm)
    A = A.to(torch.float32).contiguous()
    D = D.to(torch.float32).contiguous()
    if init_state is not None:
        init_state = init_state.to(torch.float32).contiguous()
    plan = ssd_plan(Bb, S, H, P, G, N, x.dtype)
    err = _launcher()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), D.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(),
        init_state.data_ptr() if init_state is not None else None,
        y.data_ptr(), state.data_ptr() if state is not None else None,
        int(x.dtype == torch.bfloat16), Bb, S, H, P, G, N, x_rs, dt_rs,
        b_rs, c_rs, plan.kq, plan.cluster, plan.stages, plan.smem,
        int(_aligned(x.element_size(), P, N, (x, x_rs), (Bm, b_rs),
                     (Cm, c_rs))), stream_ptr(dev))
    check_launch("ssd_scan", err)
    ssd_scan.launches += 1
    return y, state


class _Scan(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, init_state, return_state):
        y, state = _forward(x, dt, A, Bm, Cm, D, init_state, return_state)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, init_state)
        ctx.set_materialize_grads(False)
        return (y, state) if return_state else y

    @staticmethod
    def backward(ctx, dy, dstate=None):
        x, dt, A, Bm, Cm, D, init_state = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy, init_state=init_state,
                             dstate=dstate)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             init_state: Optional[torch.Tensor] = None,
             return_state: bool = False, chunk: int = 256):
    """x: (B, S, H, P); dt: (B, S, H); A, D: (H,); Bm, Cm: (B, S, G, N);
    init_state: (B, H, P, N).  Returns y like x [, final state f32].  On
    the card, differentiable through :func:`ssd_scan_bwd` when an input
    requires grad."""
    if x.device.type == "cpu":
        return ref.ssd_scan_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                                    init_state=init_state,
                                    return_state=return_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, D, init_state)):
        return _Scan.apply(x, dt, A, Bm, Cm, D, init_state, return_state)
    y, state = _forward(x, dt, A, Bm, Cm, D, init_state, return_state)
    return (y, state) if return_state else y


ssd_scan.launches = 0


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                 dy: Optional[torch.Tensor], *,
                 init_state: Optional[torch.Tensor] = None,
                 dstate: Optional[torch.Tensor] = None, chunk: int = 256):
    """(dx, ddt, dA, dBm, dCm, dD, d init_state) of :func:`ssd_scan` for
    the output gradient ``dy`` (None: zero) and the final state's
    ``dstate`` (None: zero); each in its input's type, contiguous, and
    None for an absent ``init_state``.  On the CPU the plain version:
    autograd through :func:`repro_torch.kernels.ref.ssd_scan_chunked` at
    ``chunk``."""
    if x.device.type == "cpu":
        return ref.ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy,
                                init_state=init_state, dstate=dstate,
                                chunk=chunk)
    _check("ssd_scan_bwd", x, dt, A, Bm, Cm, D, init_state)
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    for name, t, shape in (("dy", dy, (Bb, S, H, P)),
                           ("dstate", dstate, (Bb, H, P, N))):
        if t is not None and (t.device != dev or tuple(t.shape) != shape):
            raise ValueError(f"ssd_scan_bwd: {name} must be {shape} on "
                             f"x's device, got {tuple(t.shape)} on "
                             f"{t.device}")
    dx = torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bb, S, H), dtype=dt.dtype, device=dev)
    dB = torch.empty((Bb, S, G, N), dtype=Bm.dtype, device=dev)
    dC = torch.empty((Bb, S, G, N), dtype=Cm.dtype, device=dev)
    dA = torch.empty((H,), **f32)
    dD = torch.empty((H,), **f32)
    dinit = (torch.empty((Bb, H, P, N), **f32) if init_state is not None
             else None)
    if Bb == 0 or S == 0:
        for t in (dx, ddt, dB, dC, dA, dD):
            t.zero_()
        if dinit is not None:
            dinit.copy_(dstate if dstate is not None else 0.0)
        return dx, ddt, dA.to(A.dtype), dB, dC, dD.to(D.dtype), dinit
    dy = (torch.zeros_like(dx) if dy is None
          else dy.to(x.dtype).contiguous())
    if dstate is not None:
        dstate = dstate.to(torch.float32).contiguous()
    x, x_rs = _rows(x)
    dt, dt_rs = _rows(dt)
    Bm, b_rs = _rows(Bm)
    Cm, c_rs = _rows(Cm)
    A32 = A.to(torch.float32).contiguous()
    D32 = D.to(torch.float32).contiguous()
    if init_state is not None:
        init_state = init_state.to(torch.float32).contiguous()
    plan = ssd_bwd_plan(Bb, S, H, P, G, N)
    states = torch.empty((Bb, H, plan.chunks, P, N), **f32)
    dBp = torch.empty((Bb, S, H, N), **f32)
    dCp = torch.empty((Bb, S, H, N), **f32)
    dAp = torch.empty((Bb, H), **f32)
    dDp = torch.empty((Bb, H), **f32)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = _bwd_launcher()(
        x.data_ptr(), dt.data_ptr(), A32.data_ptr(), D32.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), ptr(init_state), dy.data_ptr(),
        ptr(dstate), states.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), dDp.data_ptr(),
        ptr(dinit), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
        dD.data_ptr(), int(x.dtype == torch.bfloat16), Bb, S, H, P, G, N,
        x_rs, dt_rs, b_rs, c_rs, plan.kq, plan.smem, stream_ptr(dev))
    check_launch("ssd_scan_bwd", err)
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA.to(A.dtype), dB, dC, dD.to(D.dtype), dinit


ssd_scan_bwd.launches = 0
