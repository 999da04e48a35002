"""The ``ssd_scan`` backward kernel's plan and decomposition, on the CPU.

The kernel itself (``repro_torch/csrc/ssd_scan_bwd.cu``) runs only on the
card (``test_torch_train_cuda.py``).  Here its plain model,
``repro_torch.kernels.ref.ssd_scan_bwd_tiles`` (pass 1 the chunk-entry
states; pass 2 over the chunks in reverse with the state cotangent, per-head
partials of dB and dC summed over each group's heads in order, d(a) turned
into ddt and dA by a reverse cumulative sum), is held against ``jax.vjp``
of the JAX package's ``repro.kernels.ref.ssd_scan_chunked`` from the same
numpy inputs and cotangents: every gradient (x, dt, A, B, C, D and the
initial state) in float32 within 2e-4, the scan's tolerance in
``tests/test_kernels.py``.  At chunks of 16, 32 and 64 rows, ragged tails,
G < H, with and without an initial state and a final-state cotangent.  So
is the port's plain backward (``ref.ssd_scan_bwd``, autograd through the
port's chunked form), and ``ssd_bwd_plan`` cuts every training shape
within the card's limits, from the shapes alone.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ssd_scan import ssd_bwd_plan

TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ("x", "dt", "A", "B", "C", "D", "init_state")
# (B, S, H, P, G, N): one chunk, ragged tails at every chunk, G < H,
# hymba-1.5b's P = 64, N = 16 with G = 5 and mamba2-780m's N = 128.
SHAPES = [(1, 12, 2, 16, 1, 8), (2, 33, 4, 32, 2, 16),
          (1, 70, 10, 64, 5, 16), (2, 50, 4, 16, 1, 128)]
KQS = [16, 32, 64]


def _inputs(seed, B, S, H, P, G, N):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = r(B, S, H, P, scale=0.5)
    dt = np.logaddexp(r(B, S, H), 0).astype(np.float32)
    A = -np.exp(r(H, scale=0.5))
    Bm, Cm = r(B, S, G, N, scale=0.3), r(B, S, G, N, scale=0.3)
    D = r(H)
    init = r(B, H, P, N, scale=0.5)
    dy = r(B, S, H, P)
    dstate = r(B, H, P, N, scale=0.5)
    return (x, dt, A, Bm, Cm, D, init), dy, dstate


@functools.lru_cache(maxsize=None)
def _jax_grads(shape, with_init, with_dstate):
    """``jax.vjp`` of the reference's chunked scan (chunk 16: its form
    differs from every tile model's by rounding only) as numpy."""
    args, dy, dstate = _inputs(50, *shape)
    args = [jnp.asarray(a) for a in args]

    def f(x, dt, A, Bm, Cm, D, init):
        return jref.ssd_scan_chunked(x, dt, A, Bm, Cm, D, chunk=16,
                                     init_state=init if with_init else None,
                                     return_state=True)

    _, vjp = jax.vjp(f, *args)
    ds = dstate if with_dstate else np.zeros_like(dstate)
    grads = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    return [np.asarray(g) for g in grads[:6]] + (
        [np.asarray(grads[6])] if with_init else [None])


def _torch(shape, with_init, with_dstate):
    args, dy, dstate = _inputs(50, *shape)
    t = [torch.from_numpy(a) for a in args]
    return (t[:6], dict(init_state=t[6] if with_init else None,
                        dstate=torch.from_numpy(dstate) if with_dstate
                        else None),
            torch.from_numpy(dy))


def _hold(got, want):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_tiles_at_the_plans_chunk(shape, with_init, with_dstate):
    args, kw, dy = _torch(shape, with_init, with_dstate)
    kq = ssd_bwd_plan(*shape).kq
    got = tref.ssd_scan_bwd_tiles(*args, dy, kq=kq, **kw)
    _hold(got, _jax_grads(shape, with_init, with_dstate))


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[2], SHAPES[3]])
@pytest.mark.parametrize("kq", KQS)
def test_tiles_at_every_chunk(shape, kq):
    """Every chunk the kernel takes, on ragged tails, G < H and both
    state widths, with an initial state and a final-state cotangent."""
    args, kw, dy = _torch(shape, True, True)
    got = tref.ssd_scan_bwd_tiles(*args, dy, kq=kq, **kw)
    _hold(got, _jax_grads(shape, True, True))


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2]])
@pytest.mark.parametrize("with_init", [False, True])
def test_plain_backward_matches_jax(shape, with_init):
    """The kernel's oracle on the card, ``ref.ssd_scan_bwd`` (autograd
    through the port's chunked form at the reference's default chunk),
    and the CPU path of ``ssd_scan_bwd``, against ``jax.vjp``."""
    args, kw, dy = _torch(shape, with_init, True)
    want = _jax_grads(shape, with_init, True)
    _hold(tref.ssd_scan_bwd(*args, dy, **kw), want)
    _hold(tssd.ssd_scan_bwd(*args, dy, **kw), want)


def test_tiles_without_an_output_gradient():
    """dy None is a zero output gradient: only the final state's
    cotangent drives the gradients."""
    shape = SHAPES[1]
    args, kw, _ = _torch(shape, True, True)
    got = tref.ssd_scan_bwd_tiles(*args, None, kq=16, **kw)
    want = tref.ssd_scan_bwd(*args, torch.zeros(shape[:4]), **kw)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, msg=name, **TOL)


def test_tiles_model_in_bfloat16_returns_the_inputs_types():
    args, kw, dy = _torch(SHAPES[1], True, False)
    args = [a.bfloat16() if i in (0, 1, 3, 4) else a
            for i, a in enumerate(args)]
    got = tref.ssd_scan_bwd_tiles(*args, dy.bfloat16(), kq=32, **kw)
    want = tref.ssd_scan_bwd(*args, dy.bfloat16(), **kw)
    for name, a, g, w in zip(NAMES, args + [kw["init_state"]], got, want):
        assert g.dtype == a.dtype == w.dtype, name
        tol = (dict(rtol=3e-2, atol=3e-2) if a.dtype == torch.bfloat16
               else dict(rtol=1e-3, atol=1e-3))
        torch.testing.assert_close(g.float(), w.float(), msg=name, **tol)


def test_autograd_on_the_cpu_is_the_plain_backward():
    """``ssd_scan`` on CPU tensors is the chunked form, which autograd
    differentiates: its gradients are ``ssd_scan_bwd``'s."""
    args, kw, dy = _torch(SHAPES[1], True, True)
    leaves = [a.clone().requires_grad_() for a in args]
    init = kw["init_state"].clone().requires_grad_()
    y, h = tssd.ssd_scan(*leaves, init_state=init, return_state=True)
    got = torch.autograd.grad((y, h), leaves + [init], (dy, kw["dstate"]))
    want = tssd.ssd_scan_bwd(*args, dy, **kw)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, msg=name, rtol=1e-6, atol=1e-6)


# The training shapes: mamba2-780m at 4 x 1024 (48 heads of 64, N = 128)
# and hymba-1.5b at 1 x 2176 (25 heads of 64, N = 16, its 128 meta tokens
# in front of 2048); the serving widths and the sweep's.
TRAIN = [(4, 1024, 48, 64, 1, 128), (1, 2176, 25, 64, 1, 16),
         (4, 12, 48, 64, 1, 128), (1, 64, 2, 16, 1, 8),
         (2, 96, 4, 32, 2, 16), (1, 50, 2, 16, 1, 8), (2, 128, 48, 64, 1, 128)]


@pytest.mark.parametrize("shape", TRAIN)
def test_bwd_plan_fits_the_card(shape):
    B, S, H, P, G, N = shape
    p = ssd_bwd_plan(*shape)
    assert p.kq in KQS and p.threads == tssd.BWD_THREADS
    assert p.smem <= 227 * 1024  # a block's shared memory on the H100
    assert p.smem == tssd._bwd_smem(p.kq, P, N)
    assert p.sm_blocks >= 2  # the plan keeps two blocks an SM
    assert p.blocks == B * H and p.chunks == -(-S // p.kq)
    assert p.kq <= max(16, 1 << (S - 1).bit_length())  # no idle rows past S


def test_bwd_plan_cuts():
    """mamba2's N = 128 takes 16-row chunks, two blocks an SM; hymba's
    N = 16 takes 32 (64 would leave one block an SM); a short sequence
    takes the smallest chunk that holds it."""
    m = ssd_bwd_plan(4, 1024, 48, 64, 1, 128)
    assert (m.kq, m.sm_blocks, m.blocks, m.chunks) == (16, 2, 192, 64)
    h = ssd_bwd_plan(1, 2176, 25, 64, 1, 16)
    assert (h.kq, h.blocks, h.chunks) == (32, 25, 68)
    assert tssd._fit(tssd._bwd_smem(64, 64, 16), tssd.BWD_THREADS) == 1
    assert ssd_bwd_plan(1, 12, 2, 16, 1, 8).kq == 16
    assert ssd_bwd_plan(1, 20, 2, 16, 1, 8).kq == 32
    assert ssd_bwd_plan(1, 20, 2, 64, 1, 128).kq == 16


def test_token_sums_round_with_their_scale():
    """dA and dD sum over every token of the batch, so their rounding
    grows with the sum of the terms, not with the result: at the card
    sweep's mamba2 heads two float32 evaluations of the plain backward
    (chunks 16 and 256, the same arithmetic in another order) differ on
    dA past 2e-4 element-wise, yet within 2e-4 of its largest element;
    the per-token gradients agree within 2e-4.  So the card holds the
    kernel to the oracle at the kernel's own chunk, element-wise
    (``test_torch_train_cuda.py``, ``chip_smoke.py``)."""
    args, kw, dy = _torch((2, 128, 48, 64, 1, 128), True, False)
    a = tref.ssd_scan_bwd(*args, dy, chunk=16, **kw)
    b = tref.ssd_scan_bwd(*args, dy, chunk=256, **kw)
    da = float((a[2] - b[2]).abs().max())
    assert da > 2e-4
    assert da <= 2e-4 * float(b[2].abs().max())
    for name, x, y in zip(NAMES, a, b):
        if name not in ("A", "D"):
            torch.testing.assert_close(x, y, msg=name, **TOL)
