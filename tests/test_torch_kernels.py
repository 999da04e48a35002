"""The port's kernels against the JAX package's.

On the CPU: the plain PyTorch versions (``repro_torch.kernels.ref``, which
every wrapper uses for CPU tensors) against ``repro.kernels.ref`` and the
Pallas kernels in interpret mode (float32 cases; the bfloat16 cases
against ``repro.kernels.ref``, to which ``test_kernels.py`` holds the
Pallas kernels), on the sweeps of ``test_kernels.py``, from the same
numpy inputs.  The kernels themselves are held against these plain
versions on the card by ``test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as da
from repro.kernels import flash_attention as fa
from repro.kernels import quant_matmul as qm
from repro.kernels import ref as jref
from repro_torch.kernels import ops

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


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only a CPU tensor takes the plain version; anything else goes to
    the kernel's checks, which refuse a device that is not CUDA."""
    q = torch.zeros((1, 2, 2, 8), device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], q, q,
                             torch.ones(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        ops.quant_matmul(torch.zeros((2, 8), device="meta"),
                         torch.zeros((8, 4), dtype=torch.int8, device="meta"),
                         torch.zeros((1, 4), device="meta"))
