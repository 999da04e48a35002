"""The ``ssd_scan`` kernel's plan and decomposition, on the CPU.

The kernel itself (``repro_torch/csrc/ssd_scan.cu``) runs only on the card
(``test_torch_kernels_cuda.py``).  Here its plain model,
``repro_torch.kernels.ref.ssd_scan_sliced`` (chunks of the plan's kQ, P
cut in 16-column slices, the decay block built in row blocks of the
cluster's ranks, the zero-state first chunk without its C . state term),
is held against the JAX package's sequential oracle
``repro.kernels.ref.ssd_scan`` and its Pallas kernel in interpret mode,
from the same numpy inputs, at the tolerances of ``tests/test_kernels.py``
(f32 2e-4; bf16 inputs: y 3e-2, the f32 state 2e-4): at S = 1, S = kQ +- 1,
ragged last chunks, with and without an initial state, G > 1 and
hymba-1.5b's P = 64, N = 16 with G = 5.  And ``ssd_plan`` cuts every
main-path shape within the card's limits, from the shapes alone.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro_torch.kernels import build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ssd_scan import ssd_plan

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
H100_SMS = 132
# (B, S, H, P, G, N): S = 1, kQ +- 1 at every chunk, ragged tails, G > 1,
# P of one, two and four slices, hymba-1.5b's P = 64, N = 16 at G = 5.
SHAPES = [(2, 1, 4, 64, 1, 128), (1, 15, 2, 64, 1, 128),
          (2, 17, 4, 32, 2, 16), (1, 31, 2, 16, 1, 8),
          (1, 33, 4, 64, 2, 32), (1, 63, 2, 64, 1, 16),
          (1, 65, 2, 32, 1, 16), (2, 100, 4, 16, 4, 8),
          (1, 70, 10, 64, 5, 16), (4, 12, 4, 64, 1, 128)]
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
    return x, dt, A, Bm, Cm, D, init


@functools.lru_cache(maxsize=None)
def _oracle(shape, with_init, dtype):
    """The JAX package's sequential oracle on the inputs (bf16-rounded for
    bf16), as numpy (y, state)."""
    x, dt, A, Bm, Cm, D, init = _inputs(40, *shape)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    y, s = jref.ssd_scan(
        jnp.asarray(x).astype(jdt), jnp.asarray(dt).astype(jdt),
        jnp.asarray(A), jnp.asarray(Bm).astype(jdt),
        jnp.asarray(Cm).astype(jdt), jnp.asarray(D),
        init_state=jnp.asarray(init) if with_init else None,
        return_state=True)
    return np.asarray(y, np.float32), np.asarray(s, np.float32)


def _sliced(shape, with_init, dtype, kq):
    x, dt, A, Bm, Cm, D, init = _inputs(40, *shape)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D, init)]
    y, s = tref.ssd_scan_sliced(
        t[0].to(tdt), t[1].to(tdt), t[2], t[3].to(tdt), t[4].to(tdt), t[5],
        kq=kq, init_state=t[6] if with_init else None, return_state=True)
    assert y.dtype == tdt and s.dtype == torch.float32
    return y.float().numpy(), s.numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliced_model_at_the_plans_chunk(shape, with_init, dtype):
    kq = ssd_plan(*shape, getattr(torch, dtype)).kq
    y, s = _sliced(shape, with_init, dtype, kq)
    want_y, want_s = _oracle(shape, with_init, dtype)
    np.testing.assert_allclose(y, want_y,
                               **(TOL if dtype == "float32" else BF16_TOL))
    np.testing.assert_allclose(s, want_s, **TOL)


@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[4], SHAPES[8]])
@pytest.mark.parametrize("kq", KQS)
def test_sliced_model_at_every_chunk(shape, kq):
    """Every kQ the kernel is built for, on shapes with ragged chunks, G >
    1 and hymba's widths, with an initial state."""
    y, s = _sliced(shape, True, "float32", kq)
    want_y, want_s = _oracle(shape, True, "float32")
    np.testing.assert_allclose(y, want_y, **TOL)
    np.testing.assert_allclose(s, want_s, **TOL)


@pytest.mark.parametrize("shape,chunk", [((1, 33, 4, 64, 2, 32), 16),
                                         ((1, 70, 10, 64, 5, 16), 32)])
def test_sliced_model_matches_pallas(shape, chunk):
    """The JAX package's Pallas kernel in interpret mode, at its own chunk,
    against the model at the plan's."""
    x, dt, A, Bm, Cm, D, init = _inputs(40, *shape)
    want_y, want_s = jssd.ssd_scan(
        *[jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)],
        init_state=jnp.asarray(init), chunk=chunk, return_state=True,
        interpret=True)
    y, s = _sliced(shape, True, "float32", ssd_plan(*shape,
                                                    torch.float32).kq)
    np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
    np.testing.assert_allclose(s, np.asarray(want_s), **TOL)


def test_sliced_model_one_chunk_one_slice_equals_chunked():
    """At one chunk and one slice the model is the chunked form's
    arithmetic: the two agree to rounding of the same sums."""
    t = [torch.from_numpy(a) for a in _inputs(41, 2, 12, 3, 16, 1, 8)]
    y, s = tref.ssd_scan_sliced(*t[:6], kq=16, return_state=True)
    want_y, want_s = tref.ssd_scan_chunked(*t[:6], chunk=16,
                                           return_state=True)
    torch.testing.assert_close(y, want_y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s, want_s, rtol=1e-6, atol=1e-6)


# mamba2-780m (48 heads of 64, N = 128, G = 1) at the serving prefill's
# batches and prompts and at 2048 tokens; hymba-1.5b's branch (25 heads of
# 64, N = 16); the sweep's widths.
MAIN = [(B, S, 48, 64, 1, 128) for B in (1, 4) for S in (1, 4, 12)] + [
    (1, 2048, 48, 64, 1, 128), (4, 12, 25, 64, 1, 16),
    (1, 2048, 25, 64, 5, 16), (2, 128, 48, 64, 1, 128), (1, 50, 2, 16, 1, 8)]


@pytest.mark.parametrize("shape", MAIN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_plan_fits_the_card(shape, dtype):
    B, S, H, P, G, N = shape
    p = ssd_plan(*shape, dtype)
    assert p.kq in KQS and p.ps == 16
    assert p.threads == (128 if p.kq == 16 else 256)
    assert p.cluster in (1, 2, 4) and p.cluster * p.ps >= P > (
        p.cluster // 2) * p.ps
    assert p.kq // p.cluster % 4 == 0  # a rank's rows of M: whole tiles
    assert p.stages == (1 if S <= p.kq else 2)
    assert p.smem <= 227 * 1024 and p.sm_blocks >= 1
    assert p.smem == tssd._smem(p.kq, N, 2 if dtype == torch.bfloat16
                                else 4, p.stages)
    assert p.blocks == p.cluster * H * B
    if S <= 16:  # a serving prompt: 16-row tiles, one chunk
        assert p.kq == 16 and p.stages == 1
    if S <= 12 and H == 48:  # mamba2's serving prefill: one wave
        assert p.sm_blocks >= 2 and p.smem <= 34 * 1024
        assert p.blocks <= p.sm_blocks * H100_SMS
    if S >= 2048:  # long prompts: two blocks an SM, two stages
        assert p.sm_blocks >= 2 and p.stages == 2


def test_ssd_plan_at_the_issue_shapes():
    """mamba2-780m: 768 blocks of about 31 KB at the serving prefill, seven
    an SM (one wave even where clusters of four reach only 124 SMs), 192 of
    about 95 KB (kQ = 32) at 2048 tokens."""
    serve = ssd_plan(4, 12, 48, 64, 1, 128, torch.float32)
    assert (serve.kq, serve.cluster, serve.blocks) == (16, 4, 768)
    assert serve.sm_blocks == 7 and serve.blocks <= 124 * serve.sm_blocks
    long = ssd_plan(1, 2048, 48, 64, 1, 128, torch.float32)
    assert (long.kq, long.cluster, long.blocks) == (32, 4, 192)
    assert 90 * 1024 <= long.smem <= 96 * 1024 and long.sm_blocks == 2
    assert ssd_plan(1, 2048, 25, 64, 5, 16, torch.float32).kq == 64


@pytest.mark.parametrize("limit", sorted(tssd.NVCC_DEFINES))
def test_kernel_is_built_with_the_plans_limits(limit):
    """The blocks an SM the plan counts on are the kernel's register cap,
    and the library's name changes with them."""
    assert f"-D{limit}={tssd.NVCC_DEFINES[limit]}" in build.flags("ssd_scan")
    target = build._target("ssd_scan")
    saved = tssd.NVCC_DEFINES[limit]
    try:
        tssd.NVCC_DEFINES[limit] = saved + 1
        assert build._target("ssd_scan") != target
    finally:
        tssd.NVCC_DEFINES[limit] = saved
