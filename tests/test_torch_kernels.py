"""The port's kernels against the JAX package's.

On the CPU: the plain PyTorch versions (``repro_torch.kernels.ref``, which
every wrapper uses for CPU tensors) against ``repro.kernels.ref`` and the
Pallas kernels in interpret mode (float32 cases; the bfloat16 cases
against ``repro.kernels.ref``, to which ``test_kernels.py`` holds the
Pallas kernels), on the sweeps of ``test_kernels.py``, from the same
numpy inputs.  The kernels themselves are held against these plain
versions on the card by ``test_torch_kernels_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as da
from repro.kernels import flash_attention as fa
from repro.kernels import quant_matmul as qm
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# Tolerances of tests/test_kernels.py.
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
QMM_TOL = dict(rtol=2e-4, atol=2e-4)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(a, dtype="float32"):
    """The same values in both frameworks (bf16 rounding is identical)."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **tol)


# ---------------------------------------------------------------------------
FLASH_SHAPES = [(1, 64, 4, 4, 32), (2, 160, 8, 4, 64), (1, 257, 6, 2, 128),
                (2, 128, 25, 5, 64)]


@pytest.mark.parametrize("B,S,H,KV,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference(B, S, H, KV, D, dtype):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (both(rand(rng, B, S, n, D), dtype)
                                    for n in (H, KV, KV))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    close(got, jref.flash_attention(jq, jk, jv), TOL[dtype])
    if dtype == "float32":  # test_kernels.py holds Pallas to ref in bf16
        close(got, fa.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                      interpret=True), TOL[dtype])


FLASH_MODES = [dict(window=32), dict(softcap=20.0), dict(window=16, prefix=8),
               dict(window=32, softcap=50.0, prefix=4), dict(q_offset=64)]


@pytest.mark.parametrize("kwargs", FLASH_MODES)
def test_flash_attention_plain_masking_modes(kwargs):
    B, S, H, KV, D = 2, 96, 4, 2, 32
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (both(rand(rng, B, S, n, D))
                                    for n in (H, KV, KV))
    got = ops.flash_attention(tq, tk, tv, **kwargs)
    close(got, jref.flash_attention(jq, jk, jv, **kwargs), TOL["float32"])
    close(got, fa.flash_attention(jq, jk, jv, block_q=32, block_k=32,
                                  interpret=True, **kwargs), TOL["float32"])


# ---------------------------------------------------------------------------
DECODE_SHAPES = [(2, 300, 8, 4, 64), (1, 64, 4, 4, 32), (3, 1000, 14, 2, 64)]


def _decode_inputs(rng, B, T, H, KV, D, dtype, kv_dtype=None):
    kv_dtype = kv_dtype or dtype
    q = both(rand(rng, B, H, D), dtype)
    k = both(rand(rng, B, T, KV, D), kv_dtype)
    v = both(rand(rng, B, T, KV, D), kv_dtype)
    lens = rng.integers(1, T, B).astype(np.int32)
    return q, k, v, (jnp.asarray(lens), torch.from_numpy(lens))


@pytest.mark.parametrize("B,T,H,KV,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_reference(B, T, H, KV, D, dtype):
    (jq, tq), (jk, tk), (jv, tv), (jl, tl) = _decode_inputs(
        np.random.default_rng(2), B, T, H, KV, D, dtype)
    got = ops.decode_attention(tq, tk, tv, tl)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, D)
    close(got, jref.decode_attention(jq, jk, jv, jl), TOL[dtype])
    if dtype == "float32":  # test_kernels.py holds Pallas to ref in bf16
        close(got, da.decode_attention(jq, jk, jv, jl, block_t=128,
                                       interpret=True), TOL[dtype])


@pytest.mark.parametrize("kwargs", [dict(window=64), dict(softcap=30.0),
                                    dict(window=32, prefix=8)])
def test_decode_attention_plain_window_softcap(kwargs):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv), _ = _decode_inputs(
        rng, 2, 200, 4, 2, 32, "float32")
    lens = np.array([150, 37], np.int32)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    got = ops.decode_attention(tq, tk, tv, tl, **kwargs)
    close(got, jref.decode_attention(jq, jk, jv, jl, **kwargs),
          TOL["float32"])
    close(got, da.decode_attention(jq, jk, jv, jl, block_t=64,
                                   interpret=True, **kwargs), TOL["float32"])


def test_decode_attention_plain_f32_query_bf16_cache():
    """The 8-bit variant's decode: an f32 query against the bf16 cache."""
    (jq, tq), (jk, tk), (jv, tv), (jl, tl) = _decode_inputs(
        np.random.default_rng(4), 2, 40, 8, 2, 16, "float32", "bfloat16")
    got = ops.decode_attention(tq, tk, tv, tl)
    assert got.dtype == torch.float32
    close(got, jref.decode_attention(jq, jk, jv, jl), TOL["float32"])


# ---------------------------------------------------------------------------
# The paged decode: test_kernels.py's sweep (many small pages with a ragged
# last page, a single page per sequence) plus a page size that is no
# multiple of 8 and does not divide T.
PAGED_SHAPES = [(2, 300, 8, 4, 64, 128), (3, 96, 4, 2, 32, 16),
                (1, 64, 4, 4, 32, 64), (2, 37, 4, 2, 16, 5)]
PAGED_MODES = [{}, dict(window=64), dict(softcap=30.0),
               dict(window=32, prefix=8)]


@pytest.mark.parametrize("B,T,H,KV,D,ps", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("permute", [True, False])
def test_paginate_kv_bit_exact(B, T, H, KV, D, ps, dtype, permute):
    """The same pages and table as the reference's helper, bit for bit:
    the odd-stride permutation, the zero tail of a ragged last page, and
    entries past each sequence's last page pointing to page 0."""
    rng = np.random.default_rng(14)
    (jk, tk), (jv, tv) = (both(rand(rng, B, T, KV, D), dtype)
                          for _ in range(2))
    lens = rng.integers(1, T, B).astype(np.int32)
    lens[0] = 1  # a row that uses a single page
    want = da.paginate_kv(jk, jv, jnp.asarray(lens), ps, permute=permute)
    got = ops.paginate_kv(tk, tv, torch.from_numpy(lens), ps,
                          permute=permute)
    assert got[2].dtype == torch.int32
    assert all(t.is_contiguous() for t in got), "the kernel's layout"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))
    P = B * -(-T // ps)
    assert got[0].shape == (P, KV, ps, D)
    if permute and P > 1:  # the physical layout is really scattered
        assert not np.array_equal(got[2].numpy().ravel(), np.arange(P))


def _paged_inputs(seed, B, T, H, KV, D, ps, dtype, kv_dtype=None):
    (jq, tq), (jk, tk), (jv, tv), (jl, tl) = _decode_inputs(
        np.random.default_rng(seed), B, T, H, KV, D, dtype, kv_dtype)
    jkp, jvp, jtab = da.paginate_kv(jk, jv, jl, ps)
    tkp, tvp, ttab = ops.paginate_kv(tk, tv, tl, ps)
    return ((jq, jkp, jvp, jtab, jl), (tq, tkp, tvp, ttab, tl),
            (jk, jv), (tk, tv))


@pytest.mark.parametrize("B,T,H,KV,D,ps", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", PAGED_MODES)
def test_paged_decode_attention_plain_matches_reference(B, T, H, KV, D, ps,
                                                        dtype, kwargs):
    """The port's plain paged version against the reference's oracle, the
    Pallas kernel in interpret mode (f32) and the dense version on the
    same logical cache."""
    jargs, targs, (jk, jv), (tk, tv) = _paged_inputs(
        15, B, T, H, KV, D, ps, dtype)
    got = ops.paged_decode_attention(*targs, **kwargs)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, D)
    close(got, jref.paged_decode_attention(*jargs, **kwargs), TOL[dtype])
    close(got, ops.decode_attention(targs[0], tk, tv, targs[4],
                                    **kwargs).float().numpy(), TOL[dtype])
    if dtype == "float32":  # test_kernels.py holds Pallas to ref in bf16
        close(got, da.paged_decode_attention(*jargs, interpret=True,
                                             **kwargs), TOL[dtype])


def test_paged_decode_attention_plain_empty_row():
    """A row with nothing visible (lengths == 0) gets the reference's
    answer: the mean of v over every gathered row, the zero tail of the
    last page and the repeated page 0 included."""
    rng = np.random.default_rng(16)
    (jq, tq), (jk, tk), (jv, tv) = (both(rand(rng, *s)) for s in (
        (3, 4, 16), (3, 40, 2, 16), (3, 40, 2, 16)))
    lens = np.array([0, 17, 0], np.int32)
    jargs = (jq, *da.paginate_kv(jk, jv, jnp.asarray(lens), 16),
             jnp.asarray(lens))
    targs = (tq, *ops.paginate_kv(tk, tv, torch.from_numpy(lens), 16),
             torch.from_numpy(lens))
    got = ops.paged_decode_attention(*targs)
    close(got, jref.paged_decode_attention(*jargs), TOL["float32"])
    close(got, da.paged_decode_attention(*jargs, interpret=True),
          TOL["float32"])


# ---------------------------------------------------------------------------
QMM_SHAPES = [(64, 256, 128, 128, 8), (100, 384, 200, 128, 8),
              (32, 128, 64, 32, 4), (8, 512, 512, 512, 8)]


@pytest.mark.parametrize("M,K,N,group,bits", QMM_SHAPES)
def test_quant_matmul_plain_matches_reference(M, K, N, group, bits):
    rng = np.random.default_rng(5)
    (jx, tx), (jw, tw) = both(rand(rng, M, K)), both(rand(rng, K, N))
    jwq, jsc = jref.quantize_weights(jw, bits=bits, group=group)
    twq, tsc = ops.quantize_weights(tw, bits=bits, group=group)
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    got = ops.quant_matmul(tx, twq, tsc)
    close(got, jref.quant_matmul(jx, jwq, jsc), QMM_TOL)
    close(got, qm.quant_matmul(jx, jwq, jsc, block_m=32, block_n=64,
                               block_k=group, interpret=True), QMM_TOL)


def test_quant_matmul_plain_batched_lhs_and_bf16():
    rng = np.random.default_rng(6)
    x, w = rand(rng, 2, 5, 7, 128), rand(rng, 128, 96)
    (jw, tw) = both(w)
    jwq, jsc = jref.quantize_weights(jw, bits=8, group=64)
    twq, tsc = ops.quantize_weights(tw, bits=8, group=64)
    for dtype, tol in (("float32", QMM_TOL), ("bfloat16", TOL["bfloat16"])):
        jx, tx = both(x, dtype)
        got = ops.quant_matmul(tx, twq, tsc)
        assert got.shape == (2, 5, 7, 96) and got.dtype == TDT[dtype]
        close(got, jref.quant_matmul(jx, jwq, jsc), tol)


@pytest.mark.parametrize("bits,group,shape", [
    (8, 32, (256, 128)), (4, 64, (256, 128)), (8, 128, (96, 40)),
    (4, 32, (2048, 64))])
def test_quantize_weights_bit_exact(bits, group, shape):
    """Zoo sizes and wire bytes are computed from this output, so the
    port must reproduce the reference bit for bit (including K not
    divisible by the group: one degenerate group)."""
    w = rand(np.random.default_rng(7), *shape, scale=0.05)
    jq, js = jref.quantize_weights(jnp.asarray(w), bits=bits, group=group)
    tq, ts = ops.quantize_weights(torch.from_numpy(w), bits=bits,
                                  group=group)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


# ---------------------------------------------------------------------------
SSD_SHAPES = [(1, 64, 2, 16, 1, 8, 16), (2, 96, 4, 32, 2, 16, 32),
              (1, 50, 2, 16, 1, 8, 16),  # ragged chunk
              (2, 128, 48, 64, 1, 128, 64)]  # mamba2-like dims
SSD_TOL = dict(rtol=2e-4, atol=2e-4)
# The port's three forms of the scan; ops.ssd_scan is the CPU path of the
# kernel wrapper (the chunked form at the caller's chunk).
SSD_FORMS = {
    "ref.ssd_scan": lambda *a, chunk, **kw: tref.ssd_scan(*a, **kw),
    "ref.ssd_scan_chunked": tref.ssd_scan_chunked,
    "ops.ssd_scan": ops.ssd_scan,
}


def _ssd_inputs(seed, B, S, H, P, G, N):
    """x, dt (post-softplus), A (negative), Bm, Cm, D as numpy, the way
    test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rand(rng, B, S, H, P, scale=0.5)
    dt = np.logaddexp(rand(rng, B, S, H), 0).astype(np.float32)
    A = -np.exp(rand(rng, H, scale=0.5))
    Bm = rand(rng, B, S, G, N, scale=0.3)
    Cm = rand(rng, B, S, G, N, scale=0.3)
    D = rand(rng, H)
    return x, dt, A, Bm, Cm, D


@functools.lru_cache(maxsize=None)
def _ssd_reference(shape):
    """The JAX package's sequential oracle and Pallas kernel (interpret
    mode) on one sweep shape: ((y, state), (y, state)) as numpy."""
    *dims, chunk = shape
    args = [jnp.asarray(a) for a in _ssd_inputs(11, *dims)]
    want = jref.ssd_scan(*args, return_state=True)
    pallas = jssd.ssd_scan(*args, chunk=chunk, return_state=True,
                           interpret=True)
    return (tuple(np.asarray(t) for t in want),
            tuple(np.asarray(t) for t in pallas))


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("form", list(SSD_FORMS))
def test_ssd_scan_plain_matches_reference_and_pallas(shape, form):
    *dims, chunk = shape
    args = [torch.from_numpy(a) for a in _ssd_inputs(11, *dims)]
    y, state = SSD_FORMS[form](*args, chunk=chunk, return_state=True)
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    (want_y, want_s), (pal_y, pal_s) = _ssd_reference(shape)
    for ref_y, ref_s in ((want_y, want_s), (pal_y, pal_s)):
        close(y, ref_y, SSD_TOL)
        close(state, ref_s, SSD_TOL)


@pytest.mark.parametrize("shape", SSD_SHAPES[:3])
def test_ssd_scan_plain_bf16_matches_reference(shape):
    """bf16 inputs (the 16-bit variant's prefill): y in bf16 at the bf16
    tolerance, the f32 state at 2e-4 (both sides compute in f32 from the
    same bf16 values)."""
    *dims, chunk = shape
    arrays = _ssd_inputs(12, *dims)
    j = [both(a, "bfloat16")[0] for a in arrays[:2]] + [
        jnp.asarray(arrays[2])] + [both(a, "bfloat16")[0]
                                   for a in arrays[3:5]] + [
        jnp.asarray(arrays[5])]
    t = [both(a, "bfloat16")[1] for a in arrays[:2]] + [
        torch.from_numpy(arrays[2])] + [both(a, "bfloat16")[1]
                                        for a in arrays[3:5]] + [
        torch.from_numpy(arrays[5])]
    want_y, want_s = jref.ssd_scan_chunked(*j, chunk=chunk,
                                           return_state=True)
    y, state = ops.ssd_scan(*t, chunk=chunk, return_state=True)
    assert y.dtype == torch.bfloat16
    close(y, want_y, TOL["bfloat16"])
    close(state, want_s, SSD_TOL)


@pytest.mark.parametrize("form", ["ref.ssd_scan_chunked", "ops.ssd_scan"])
def test_ssd_state_continuation(form):
    """Scanning [0:48] then [48:80] with the carried state equals scanning
    [0:80], and both equal the JAX package's chunked scan."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(9, 1, 80, 2, 16, 1, 8)]
    x, dt, A, Bm, Cm, D = args
    fn = SSD_FORMS[form]
    full = fn(*args, chunk=16)
    y1, st1 = fn(x[:, :48], dt[:, :48], A, Bm[:, :48], Cm[:, :48], D,
                 chunk=16, return_state=True)
    y2 = fn(x[:, 48:], dt[:, 48:], A, Bm[:, 48:], Cm[:, 48:], D, chunk=16,
            init_state=st1)
    close(torch.cat([y1, y2], dim=1), full.numpy(), SSD_TOL)
    want = jref.ssd_scan_chunked(*[jnp.asarray(a.numpy()) for a in args],
                                 chunk=16)
    close(full, want, SSD_TOL)


def test_ssd_step_matches_scan():
    """The sequential ssd_step over tokens equals the batched scan, and
    each step equals the JAX package's ssd_step."""
    arrays = _ssd_inputs(13, 1, 12, 2, 8, 1, 4)
    x, dt, A, Bm, Cm, D = [torch.from_numpy(a) for a in arrays]
    jx, jdt, jA, jB, jC, jD = [jnp.asarray(a) for a in arrays]
    want = tref.ssd_scan(x, dt, A, Bm, Cm, D)
    state = torch.zeros((1, 2, 8, 4))
    jstate = jnp.zeros((1, 2, 8, 4), jnp.float32)
    outs = []
    for t in range(12):
        y, state = ops.ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D,
                                state)
        jy, jstate = jref.ssd_step(jx[:, t], jdt[:, t], jA, jB[:, t],
                                   jC[:, t], jD, jstate)
        close(y, jy, SSD_TOL)
        close(state, jstate, SSD_TOL)
        outs.append(y)
    close(torch.stack(outs, dim=1), want.numpy(), SSD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_step_matches_batch(dtype):
    """The rolling-buffer conv step equals the whole-sequence conv, and
    both equal the JAX package's (in bf16 too: each rounds once, from the
    same f32 sum)."""
    B, S, C, W = 2, 10, 8, 4
    rng = np.random.default_rng(17)
    (jx, tx), (jw, tw) = both(rand(rng, B, S, C), dtype), both(
        rand(rng, W, C), dtype)
    jb, tb = both(rand(rng, C, scale=0.1), dtype)
    want = ops.causal_conv1d(tx, tw, tb)
    assert want.dtype == TDT[dtype]
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        TOL["bfloat16"]
    close(want, jref.causal_conv1d(jx, jw, jb), tol)
    buf = torch.zeros((B, W - 1, C), dtype=TDT[dtype])
    outs = []
    for t in range(S):
        y, buf = ops.causal_conv1d_step(tx[:, t], tw, tb, buf)
        outs.append(y)
    close(torch.stack(outs, 1), want.float().numpy(), tol)


def test_conv1d_step_promotes_the_buffer_like_the_reference():
    """An 8-bit variant's decode: f32 activations against the cache's
    bf16 buffer give an f32 buffer, in both packages."""
    rng = np.random.default_rng(18)
    (jx, tx), (jw, tw), (jb, tb) = (both(rand(rng, *s))
                                    for s in ((2, 8), (4, 8), (8,)))
    jbuf, tbuf = both(rand(rng, 2, 3, 8), "bfloat16")
    jy, jnew = jref.causal_conv1d_step(jx, jw, jb, jbuf)
    ty, tnew = ops.causal_conv1d_step(tx, tw, tb, tbuf)
    assert tnew.dtype == torch.float32 and jnew.dtype == jnp.float32
    close(ty, jy, dict(rtol=1e-5, atol=1e-5))
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A tensor on a device that is neither a plain one (the CPU,
    ``meta``) nor CUDA goes to the kernel's checks, which refuse it:
    nothing falls back to the plain version there."""

    class Elsewhere(torch.Tensor):
        @property
        def device(self):
            return torch.device("xpu")

    def m(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype,
                           device="meta").as_subclass(Elsewhere)

    assert "xpu" not in tref.PLAIN_DEVICES
    q = m(1, 2, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, 0], q, q, m(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.quant_matmul(m(2, 8), m(8, 4, dtype=torch.int8), m(1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(
            m(1, 2, 8), m(2, 2, 4, 8), m(2, 2, 4, 8),
            m(1, 2, dtype=torch.int32), m(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(m(1, 4, 2, 8), m(1, 4, 2), m(2), m(1, 4, 1, 4),
                     m(1, 4, 1, 4), m(2))


def test_meta_calls_take_the_plain_version_and_build_nothing(monkeypatch):
    """Only a CUDA tensor reaches a kernel: a ``meta`` tensor, like a CPU
    one, takes the plain version, which gives the shapes and types the
    plain version gives on the CPU; nothing is built or launched."""
    from repro_torch.kernels import build

    def no_build(*a, **k):
        raise AssertionError("a meta call built a kernel")

    monkeypatch.setattr(build, "library", no_build)
    monkeypatch.setattr(build, "build_all", no_build)
    rng = np.random.default_rng(19)

    def pair(*shape, dtype=torch.float32):
        t = torch.from_numpy(rand(rng, *shape)).to(dtype)
        return t, t.to("meta")

    def same(fn, *args, **kw):
        want = fn(*(a[0] for a in args), **kw)
        got = fn(*(a[1] for a in args), **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert [g if g is None else (g.device.type, g.shape, g.dtype)
                for g in got] == [w if w is None else
                                  ("meta", w.shape, w.dtype) for w in want]

    q, k = pair(2, 16, 4, 8), pair(2, 16, 2, 8)
    counts = {n: getattr(ops, n).launches for n in (
        "flash_attention", "decode_attention", "paged_decode_attention",
        "quant_matmul", "ssd_scan")}
    same(ops.flash_attention, q, k, k, window=4, softcap=5.0)
    same(ops.flash_attention, pair(2, 16, 4, 8, dtype=torch.bfloat16),
         k, k)
    lens = (torch.tensor([5, 16], dtype=torch.int32),) * 2
    lens = (lens[0], lens[1].to("meta"))
    same(ops.decode_attention, pair(2, 4, 8), k, k, lens)
    kp, vp, table = ops.paginate_kv(k[0], k[0], lens[0], 8)
    same(ops.paged_decode_attention, pair(2, 4, 8), (kp, kp.to("meta")),
         (vp, vp.to("meta")), (table, table.to("meta")), lens)
    wq, ws = tref.quantize_weights(torch.from_numpy(rand(rng, 64, 16)),
                                   bits=8, group=32)
    same(ops.quant_matmul, pair(3, 64), (wq, wq.to("meta")),
         (ws, ws.to("meta")))
    x, dt = pair(1, 32, 2, 8), pair(1, 32, 2)
    A, Bm, D = pair(2), pair(1, 32, 1, 4), pair(2)
    same(ops.ssd_scan, x, dt, A, Bm, Bm, D, return_state=True, chunk=16)
    out, lse = tref.flash_attention_lse(q[0], k[0], k[0])
    same(ops.flash_attention_bwd, q, k, k, (out, out.to("meta")), q,
         (lse, lse.to("meta")))
    same(ops.ssd_scan_bwd, x, dt, A, Bm, Bm, D, x, chunk=16)
    assert counts == {n: getattr(ops, n).launches for n in counts}
