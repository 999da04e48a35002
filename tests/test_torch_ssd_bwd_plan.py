"""The ``ssd_scan`` backward kernels' plan and decomposition, on the CPU.

The kernels themselves (``repro_torch/csrc/ssd_scan_bwd.cu``) run only on
the card (``test_torch_train_cuda.py``).  Here their plain model,
``repro_torch.kernels.ref.ssd_scan_bwd_tiles`` (each chunk's own states,
the two state scans over the chunks, each chunk's gradients from its entry
state and its exit state's cotangent, per-head partials of dB and dC
summed over clusters of heads in rank order and then over each group's
clusters, d(a) turned into ddt by a reverse cumulative sum and into dA
term by term), is held against ``jax.vjp`` of the JAX package's
``repro.kernels.ref.ssd_scan_chunked`` from the same numpy inputs and
cotangents: every gradient (x, dt, A, B, C, D and the initial state) in
float32 within 2e-4, the scan's tolerance in ``tests/test_kernels.py``.
At chunks of 16, 32 and 64 rows, ragged tails, G < H, clusters of 1 to 5
heads, with and without an initial state and a final-state cotangent.  So
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
    plan = ssd_bwd_plan(*shape)
    got = tref.ssd_scan_bwd_tiles(*args, dy, kq=plan.kq,
                                  cluster=plan.cluster, **kw)
    _hold(got, _jax_grads(shape, with_init, with_dstate))


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[2], SHAPES[3]])
@pytest.mark.parametrize("kq", KQS)
def test_tiles_at_every_chunk(shape, kq):
    """Every chunk the kernel takes, on ragged tails, G < H and both
    state widths, with an initial state and a final-state cotangent."""
    args, kw, dy = _torch(shape, True, True)
    got = tref.ssd_scan_bwd_tiles(*args, dy, kq=kq, **kw)
    _hold(got, _jax_grads(shape, True, True))


@pytest.mark.parametrize("shape,cluster", [(SHAPES[1], 2), (SHAPES[2], 1),
                                           (SHAPES[2], 2), (SHAPES[3], 4)])
@pytest.mark.parametrize("kq", KQS)
def test_tiles_at_every_cluster(shape, cluster, kq):
    """The dB and dC partials summed over clusters of 1, 2 or 4 heads in
    rank order, then over each group's clusters (SHAPES[2]: 10 heads in 5
    groups, two a group; SHAPES[3]: 4 heads in one group), at every
    chunk, with an initial state and a final-state cotangent."""
    args, kw, dy = _torch(shape, True, True)
    got = tref.ssd_scan_bwd_tiles(*args, dy, kq=kq, cluster=cluster, **kw)
    _hold(got, _jax_grads(shape, True, True))


def test_tiles_refuse_a_cluster_across_groups():
    args, kw, dy = _torch(SHAPES[2], False, False)
    with pytest.raises(ValueError, match="does not divide"):
        tref.ssd_scan_bwd_tiles(*args, dy, kq=16, cluster=4, **kw)


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_plan_fits_the_card(shape, dtype):
    B, S, H, P, G, N = shape
    p = ssd_bwd_plan(*shape, dtype)
    esz = 2 if dtype == torch.bfloat16 else 4
    assert p.kq in KQS and p.threads == tssd.BWD_THREADS
    assert p.kq == ssd_bwd_plan(*shape).kq  # the type moves only the bytes
    # a block's shared memory on the H100, each kernel's equal to the
    # source's layout
    assert max(p.smem, p.smem_local) <= 227 * 1024
    assert (p.smem_local, p.smem) == tssd._bwd_smem(p.kq, P, N, esz)
    assert p.sm_blocks >= 1
    assert (H // G) % p.cluster == 0 and 1 <= p.cluster <= 8
    assert p.chunks == -(-S // p.kq) and p.blocks == B * H * p.chunks
    assert p.kq <= max(16, 1 << (S - 1).bit_length())  # no idle rows past S
    _, PP, NP = tssd._bwd_geo(p.kq, P, N)
    assert p.scratch == 4 * (2 * B * H * p.chunks * PP * NP
                             + 3 * B * H * p.chunks
                             + 2 * B * S * (H // p.cluster) * N)


def test_bwd_plan_cuts():
    """64-row chunks at both training shapes, each filling the card's 132
    SMs many times over with chunk blocks (mamba2-780m 3072, hymba-1.5b
    850); heads in clusters of 8 at mamba2's 48 a group, 5 at hymba's 25;
    a short sequence takes the smallest chunk that holds it; the scratch
    at mamba2's shape is under half the 600 MB the per-head design
    took."""
    m = ssd_bwd_plan(4, 1024, 48, 64, 1, 128)
    assert (m.kq, m.cluster, m.blocks, m.chunks) == (64, 8, 3072, 16)
    assert m.blocks >= 132 and m.sm_blocks == 1
    assert m.scratch < 300e6
    h = ssd_bwd_plan(1, 2176, 25, 64, 1, 16)
    assert (h.kq, h.cluster, h.blocks, h.chunks) == (64, 5, 850, 34)
    assert h.blocks >= 132 and h.sm_blocks == 1
    assert ssd_bwd_plan(1, 12, 2, 16, 1, 8).kq == 16
    assert ssd_bwd_plan(1, 20, 2, 16, 1, 8).kq == 32
    assert ssd_bwd_plan(1, 20, 2, 64, 1, 128).kq == 32
    assert ssd_bwd_plan(2, 70, 10, 64, 2, 16).cluster == 5
    assert ssd_bwd_plan(1, 90, 12, 32, 1, 64).cluster == 6
    # float32 tiles double the inputs' share and still fit one block
    assert ssd_bwd_plan(4, 1024, 48, 64, 1, 128,
                        torch.float32).smem <= 227 * 1024


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


def test_plain_backward_in_bfloat16_rounds_each_gradient_once():
    """On bf16 inputs the plain backward is the float32 gradient of the
    same values rounded to bf16 once: the chunked form widens each input
    once.  (Widening x twice, for the scan and for the D x skip, made
    autograd round both parts of x's gradient to bf16 and add them in
    bf16, which misses where the two parts cancel.)"""
    args, kw, dy = _torch(SHAPES[1], True, True)
    narrow = [a.bfloat16() if i in (0, 1, 3, 4) else a
              for i, a in enumerate(args)]
    got = tref.ssd_scan_bwd(*narrow, dy.bfloat16(), **kw)
    wide = tref.ssd_scan_bwd(*[a.float() for a in narrow],
                             dy.bfloat16().float(), **kw)
    for name, g, w in zip(NAMES, got, wide):
        assert torch.equal(g, w.to(g.dtype)), name


def _card_sweep_inputs(B, S, H, P, G, N, seed=5):
    """The card tests' scan inputs (``test_torch_train_cuda._ssd_inputs``)
    on the CPU, in float32."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    xbc = torch.cat([r(B, S, H * P, scale=0.5),
                     r(B, S, 2 * G * N, scale=0.3)], -1)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(r(B, S, H))
    A = -torch.exp(r(H, scale=0.5))
    D = r(H)
    init = r(B, H, P, N, scale=0.5)
    return (x, dt, A, Bm, Cm, D), init, r(B, S, H, P)


def test_the_cards_oracle_is_the_float64_evaluation():
    """The card holds the kernels to the plain backward evaluated on
    inputs widened to float64.  At the card sweep's mamba2 heads with an
    initial state and the kernel's 64-row chunks, the float32 evaluation
    of the same plain backward sits past 2e-4 from the float64 one on dA
    (a sum over every token of terms that cancel), while the kernels'
    decomposition in float32 (dA taken term by term) stays within it."""
    args, init, dy = _card_sweep_inputs(2, 128, 48, 64, 1, 128)
    exact = tref.ssd_scan_bwd(*[a.double() for a in args], dy.double(),
                              init_state=init.double(), chunk=64)
    assert all(g.dtype == torch.float64 for g in exact)
    f32 = tref.ssd_scan_bwd(*args, dy, init_state=init, chunk=64)
    tiles = tref.ssd_scan_bwd_tiles(*args, dy, kq=64, cluster=8,
                                    init_state=init)
    tol = 2e-4 + 2e-4 * exact[2].abs()
    assert ((f32[2].double() - exact[2]).abs() > tol).any()
    assert ((tiles[2].double() - exact[2]).abs() <= tol).all()
    for name, t, e in zip(NAMES, tiles, exact):
        torch.testing.assert_close(t.double(), e, msg=name, **TOL)
