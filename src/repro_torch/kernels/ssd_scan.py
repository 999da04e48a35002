"""Mamba-2 SSD scan (chunked state-space duality) through a Hopper kernel.

Port of :func:`repro.kernels.ssd_scan.ssd_scan` (the Pallas kernel
``_ssd_kernel``).  The CUDA source is ``repro_torch/csrc/ssd_scan.cu``;
its header comment gives the design and what bounds it on the H100.  A
call is one launch of thread-block clusters: the blocks that take the
16-column slices of one head's P share its decay block through
distributed shared memory.  :func:`ssd_plan` cuts a call from its shapes
alone (the chunk the kernel runs, whatever ``chunk`` the caller names:
the result depends on the chunk only through rounding).

A tensor on the CPU is computed by the plain version,
:func:`repro_torch.kernels.ref.ssd_scan_chunked` at ``chunk``.  A CUDA
tensor goes to the kernel, or the call raises: there is no fallback.
``x``, ``dt``, ``Bm`` and ``Cm`` share one type, float32 or bfloat16;
``A``, ``D`` and ``init_state`` are taken as float32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import (check_launch, launcher,
                                      refuse_grad, stream_ptr)

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


@functools.lru_cache(maxsize=None)
def _launcher():
    return launcher("ssd_scan", _ARGTYPES)


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             init_state: Optional[torch.Tensor] = None,
             return_state: bool = False, chunk: int = 256):
    """x: (B, S, H, P); dt: (B, S, H); A, D: (H,); Bm, Cm: (B, S, G, N);
    init_state: (B, H, P, N).  Returns y like x [, final state f32]."""
    if x.device.type == "cpu":
        return ref.ssd_scan_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                                    init_state=init_state,
                                    return_state=return_state)
    refuse_grad("ssd_scan", "its backward kernel is ROADMAP A14; until then "
                "the SSM and hybrid families train on the CPU only", x, dt,
                A, Bm, Cm, D, init_state)
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = x.device
    tensors = (dt, A, Bm, Cm, D) + ((init_state,) if init_state is not None
                                    else ())
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ssd_scan: all inputs must share one CUDA device")
    if x.dtype not in _TYPES or any(t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"ssd_scan: x {x.dtype}, dt {dt.dtype}, Bm "
                        f"{Bm.dtype}, Cm {Cm.dtype} not all float32 or all "
                        "bfloat16")
    if A.dtype not in _TYPES or D.dtype not in _TYPES:
        raise TypeError(f"ssd_scan: A {A.dtype} / D {D.dtype} not float32 "
                        "or bfloat16")
    if (tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,) or tuple(Bm.shape) != (Bb, S, G, N)
            or Cm.shape != Bm.shape or G == 0 or H % G
            or (init_state is not None
                and tuple(init_state.shape) != (Bb, H, P, N))):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm/Cm "
                         f"{tuple(Bm.shape)}/{tuple(Cm.shape)}, D "
                         f"{tuple(D.shape)}")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"ssd_scan: needs 1 <= P <= {MAX_P} and 1 <= N <= "
                         f"{MAX_N} (the state lives in shared memory), got "
                         f"P={P}, N={N}")
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev)
    state = (torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
             if return_state else None)
    if Bb == 0 or S == 0:
        if state is not None:
            state.zero_() if init_state is None else state.copy_(init_state)
        return (y, state) if return_state else y
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
    return (y, state) if return_state else y


ssd_scan.launches = 0
