"""Mamba-2 SSD scan (chunked state-space duality) through a Hopper kernel.

Port of :func:`repro.kernels.ssd_scan.ssd_scan` (the Pallas kernel
``_ssd_kernel``).  The CUDA source is ``repro_torch/csrc/ssd_scan.cu``;
its header comment gives the design, its chunk length (64 tokens, whatever
``chunk`` the caller names) and what bounds it on the H100.

A tensor on the CPU is computed by the plain version,
:func:`repro_torch.kernels.ref.ssd_scan_chunked` at ``chunk``.  A CUDA
tensor goes to the kernel, or the call raises: there is no fallback.
``x``, ``dt``, ``Bm`` and ``Cm`` share one type, float32 or bfloat16;
``A``, ``D`` and ``init_state`` are taken as float32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, launcher, stream_ptr

_TYPES = (torch.float32, torch.bfloat16)
MAX_P, MAX_N = 64, 128  # kMaxP, kMaxN in the source
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
              + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])


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
    err = launcher("ssd_scan", _ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), D.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(),
        init_state.data_ptr() if init_state is not None else None,
        y.data_ptr(), state.data_ptr() if state is not None else None,
        int(x.dtype == torch.bfloat16), Bb, S, H, P, G, N, x_rs, dt_rs,
        b_rs, c_rs, stream_ptr(dev))
    check_launch("ssd_scan", err)
    ssd_scan.launches += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0
