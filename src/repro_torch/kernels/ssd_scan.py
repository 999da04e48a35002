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
its own, ``repro_torch/csrc/ssd_scan_bwd.cu`` (:func:`ssd_scan_bwd`, cut
by :func:`ssd_bwd_plan`): four kernels a call, parallel over chunks (each
chunk's own states, the two state scans over the chunks, each chunk's
gradients from its entry state and its exit state's cotangent with the
heads of a group in thread-block clusters, a fixed-order reduce), on the
tensor cores for bf16 calls with every float32 operand split exactly into
three bf16 pieces.  When an input requires grad under grad mode,
:func:`ssd_scan` runs as a ``torch.autograd.Function`` whose forward is
the same kernel and whose backward is that call; it saves only the
inputs.

A tensor on the CPU or on ``meta`` is computed by the plain versions at
``chunk``, :func:`repro_torch.kernels.ref.ssd_scan_chunked` and
:func:`~repro_torch.kernels.ref.ssd_scan_bwd`, through the same
Function, each counted by :func:`~repro_torch.kernels.ref.as_kernel` as
the kernel it stands for.  A CUDA tensor goes to the kernels, or the
call raises: there is no fallback.  ``x``, ``dt``, ``Bm`` and ``Cm`` share one
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
_BWD_ARGTYPES = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2
                 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
BWD_THREADS = 256  # kThreads of ssd_scan_bwd.cu
_BWD_VECS = 7  # kVecs: per-row vectors of the gradient kernel
_BWD_LOCAL_VECS = 6  # kLocalVecs: of the local-states kernel
_BWD_ROW_PARTS = 4  # kRowParts: column tiles of a row's partial sums
_BWD_F_PARTS = 2 + 4  # kFRowParts + kFColParts: F's row and column sums


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
    """How the backward cuts a call: four kernels, the two chunk kernels
    over (head, chunk, sequence) blocks."""
    kq: int  # chunk: rows of a tile, 16, 32 or 64
    cluster: int  # heads a cluster of the gradient kernel (divides H/G)
    threads: int  # threads a block of the chunk kernels
    smem_local: int  # dynamic shared bytes of a local-states block
    smem: int  # dynamic shared bytes of a gradient block
    sm_blocks: int  # gradient blocks an SM holds by shared memory
    blocks: int  # blocks of each chunk kernel: B H chunks
    chunks: int  # chunks a sequence
    scan_threads: int  # threads of the state scans: a float4 of (P, N) each
    scratch: int  # bytes of float32 scratch the wrapper allocates


def _bwd_geo(kq: int, P: int, N: int) -> tuple[int, int, int]:
    """(rows, P, N) of a chunk kernel's tiles (``geo()`` in
    ``ssd_scan_bwd.cu``): the chunk at least 32 rows, P and N padded to
    multiples of 32."""
    return max(kq, 32), _round_up(P, 32), _round_up(N, 32)


def _bwd_smem(kq: int, P: int, N: int, esz: int) -> tuple[int, int]:
    """Shared bytes of a (local-states, gradient) block: ``local_layout()``
    and ``grads_layout()`` in ``ssd_scan_bwd.cu``, which the launcher
    checks against these (``esz``: the inputs' element size).  Row strides
    are 8 elements past the padded width.  Local: w x and e^a dy (Q, P)
    (three bf16 pieces each in a bf16 call, float32 in a float32 one); x
    and dy (Q, P) and B and C (Q, N) in the inputs' type; the per-row
    vectors.  Gradient: the chunk's entry state h and its exit cotangent
    g (P, N) (rows max(P, Q): the dC and dB partials reuse them) and M and
    W (Q, Q), as three bf16 pieces each in a bf16 call, as float32 in a
    float32 one; x and dy (Q, P) and B and C (Q, N) in the inputs' type; the
    per-row vectors and the row and column partial sums."""
    Qp, PP, NP = _bwd_geo(kq, P, N)
    fsz = 6 if esz == 2 else 4  # bytes of a float32 operand's element
    local = (fsz * 2 * Qp * (PP + 8) + esz * 2 * Qp * (PP + 8)
             + esz * 2 * Qp * (NP + 8) + 4 * _BWD_LOCAL_VECS * Qp)
    grads = (fsz * 2 * max(PP, Qp) * (NP + 8) + esz * 2 * Qp * (PP + 8)
             + esz * 2 * Qp * (NP + 8) + fsz * 2 * Qp * (Qp + 8)
             + 4 * ((_BWD_VECS + _BWD_F_PARTS + 2 * _BWD_ROW_PARTS) * Qp
                    + 32))
    return local, grads


def _bwd_cluster(H: int, G: int) -> int:
    """The gradient kernel's head cluster: the largest divisor of H/G up
    to 8 (a portable cluster), so a cluster never straddles two groups."""
    rep = H // G
    return max(d for d in range(1, min(rep, 8) + 1) if rep % d == 0)


@functools.lru_cache(maxsize=None)
def ssd_bwd_plan(B: int, S: int, H: int, P: int, G: int, N: int,
                 dtype: torch.dtype = torch.bfloat16) -> SsdBwdPlan:
    """Cut the backward of a scan of x (B, S, H, P), B and C (B, S, G, N)
    in ``dtype`` (which sets only the shared bytes: the inputs' tiles
    keep their type) from the shapes alone.

    The chunk is 64 rows, or the smallest of 16 and 32 that holds a short
    sequence.  At 64 the chunk states (B, H, S/64, P, N) float32 are 100
    MB a buffer at mamba2-780m's training shape and the intra-chunk Q^2
    work is under half of the products; 128 would halve the scratch but
    double that work, and its (Q, Q) M and W would not fit in shared
    memory beside the states.  Both training shapes fill
    the card with blocks: mamba2 3072, hymba 850.  The gradient kernel's
    heads form clusters of the largest divisor of H/G up to 8, which cuts
    the per-head dB and dC partials by that factor."""
    esz = 2 if dtype == torch.bfloat16 else 4
    kq = next((q for q in (16, 32) if S <= q), 64)
    chunks = -(-S // kq)
    cluster = _bwd_cluster(H, G)
    local, grads = _bwd_smem(kq, P, N, esz)
    _, PP, NP = _bwd_geo(kq, P, N)
    scratch = 4 * (2 * B * H * chunks * PP * NP + 3 * B * H * chunks
                   + 2 * B * S * (H // cluster) * N)
    return SsdBwdPlan(kq, cluster, BWD_THREADS, local, grads,
                      SMEM_SM // (grads + 1024), B * H * chunks, chunks,
                      PP * NP // 4, scratch)


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


def _forward(x, dt, A, Bm, Cm, D, init_state, return_state: bool,
             chunk: int):
    """The forward kernel's launch: (y, final state float32 or None).  On
    the CPU and ``meta`` the plain version at ``chunk``."""
    if x.device.type in ref.PLAIN_DEVICES:
        out = ref.as_kernel(ref.ssd_scan_chunked, x, dt, A, Bm, Cm, D,
                            chunk=chunk, init_state=init_state,
                            return_state=return_state)
        return out if return_state else (out, None)
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
    def forward(ctx, x, dt, A, Bm, Cm, D, init_state, return_state, chunk):
        y, state = _forward(x, dt, A, Bm, Cm, D, init_state, return_state,
                            chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, init_state)
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        return (y, state) if return_state else y

    @staticmethod
    def backward(ctx, dy, dstate=None):
        x, dt, A, Bm, Cm, D, init_state = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy, init_state=init_state,
                             dstate=dstate, chunk=ctx.chunk)
        return (*grads, None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             init_state: Optional[torch.Tensor] = None,
             return_state: bool = False, chunk: int = 256):
    """x: (B, S, H, P); dt: (B, S, H); A, D: (H,); Bm, Cm: (B, S, G, N);
    init_state: (B, H, P, N).  Returns y like x [, final state f32].
    Differentiable through :func:`ssd_scan_bwd` when an input requires
    grad, on every device."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, D, init_state)):
        return _Scan.apply(x, dt, A, Bm, Cm, D, init_state, return_state,
                           chunk)
    y, state = _forward(x, dt, A, Bm, Cm, D, init_state, return_state,
                        chunk)
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
    if x.device.type in ref.PLAIN_DEVICES:
        return ref.as_kernel(ref.ssd_scan_bwd, x, dt, A, Bm, Cm, D, dy,
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
    plan = ssd_bwd_plan(Bb, S, H, P, G, N, x.dtype)
    _, PP, NP = _bwd_geo(plan.kq, P, N)
    nc = plan.chunks
    st = torch.empty((Bb, H, nc, PP, NP), **f32)
    ct = torch.empty((Bb, H, nc, PP, NP), **f32)
    aend = torch.empty((Bb, H, nc), **f32)
    dBc = torch.empty((Bb, S, H // plan.cluster, N), **f32)
    dCc = torch.empty((Bb, S, H // plan.cluster, N), **f32)
    dAp = torch.empty((Bb, H, nc), **f32)
    dDp = torch.empty((Bb, H, nc), **f32)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = _bwd_launcher()(
        x.data_ptr(), dt.data_ptr(), A32.data_ptr(), D32.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), ptr(init_state), dy.data_ptr(),
        ptr(dstate), st.data_ptr(), ct.data_ptr(), aend.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dBc.data_ptr(), dCc.data_ptr(),
        dAp.data_ptr(), dDp.data_ptr(), ptr(dinit), dB.data_ptr(),
        dC.data_ptr(), dA.data_ptr(), dD.data_ptr(),
        int(x.dtype == torch.bfloat16), Bb, S, H, P, G, N, x_rs, dt_rs, b_rs,
        c_rs, plan.kq, plan.cluster, plan.smem_local, plan.smem,
        stream_ptr(dev))
    check_launch("ssd_scan_bwd", err)
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA.to(A.dtype), dB, dC, dD.to(D.dtype), dinit


ssd_scan_bwd.launches = 0
