"""The ``quant_matmul`` kernel's plan and split-K arithmetic, on the CPU.

The kernel itself (``repro_torch/csrc/quant_matmul.cu``) runs only on the
card (``test_torch_kernels_cuda.py``).  Here its plain model,
``repro_torch.kernels.ref.quant_matmul_splits`` (one f32 partial per
split of K, added in split order as a cluster's ranks add them), is held
against the JAX package's ``repro.kernels.ref.quant_matmul`` and its
Pallas kernel in interpret mode, from the same numpy inputs, at the
tolerances of ``tests/test_kernels.py`` (f32 2e-4, bf16 3e-2): on its
sweep at S = 1, 2, 4 and 8, at K = 1600 whose last split is short, and at
N = 3257.  And ``qmm_plan`` cuts every main-path shape as the kernel
requires, from the shapes alone.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant_matmul as qm
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quant_matmul import qmm_plan

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QMM_SHAPES = [(64, 256, 128, 128, 8), (100, 384, 200, 128, 8),
              (32, 128, 64, 32, 4), (8, 512, 512, 512, 8)]
CLUSTERS = [1, 2, 4, 8]
# Every distinct per-layer (K, N) of the served tenants at full width:
# tinyllama-1.1b, mamba2-780m (ssm_in, ssm_out), gemma2-2b; and
# hymba-1.5b's ssm_in.
MAIN_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
               (1536, 6448), (3072, 1536),
               (2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
               (9216, 2304)]
HYMBA_SSM_IN = (1600, 3257)
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _inputs(M, K, N, group, bits, seed=30):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    wq, sc = ops.quantize_weights(torch.from_numpy(w), bits=bits, group=group)
    return x, wq.numpy(), sc.numpy()


@functools.lru_cache(maxsize=None)
def _pallas(M, K, N, group, bits):
    x, wq, sc = _inputs(M, K, N, group, bits)
    return np.asarray(qm.quant_matmul(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sc), block_m=32,
        block_n=64, block_k=group, interpret=True), np.float32)


def _splits(M, K, N, group, bits, S, dtype):
    """(the plain split model, the JAX reference) on the same inputs."""
    x, wq, sc = _inputs(M, K, N, group, bits)
    rows = math.ceil(K // group / S) * group
    got = tref.quant_matmul_splits(
        torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(wq),
        torch.from_numpy(sc), splits=S, rows=rows)
    assert got.dtype == TDT[dtype] and got.shape == (M, N)
    want = jref.quant_matmul(jnp.asarray(x).astype(JDT[dtype]),
                             jnp.asarray(wq), jnp.asarray(sc))
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("M,K,N,group,bits", QMM_SHAPES)
@pytest.mark.parametrize("S", CLUSTERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_matches_reference(M, K, N, group, bits, S, dtype):
    got, want = _splits(M, K, N, group, bits, S, dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if dtype == "float32":  # the Pallas kernel is held to the f32 reference
        np.testing.assert_allclose(got, _pallas(M, K, N, group, bits),
                                   **TOL[dtype])


@pytest.mark.parametrize("M,K,N", [(4, *HYMBA_SSM_IN), (5, 1600, 96),
                                   (3, 256, 3257)])
@pytest.mark.parametrize("S", CLUSTERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_short_last_split_and_odd_width(M, K, N, S, dtype):
    """K = 1600 is 50 groups of 32: at S = 8 the splits take 7 groups and
    the last takes 1; N = 3257 is no multiple of 4 or 16."""
    got, want = _splits(M, K, N, 32, 8, S, dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_split_model_single_split_equals_plain_bitwise():
    x, wq, sc = _inputs(8, 256, 64, 32, 8)
    args = (torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(sc))
    assert torch.equal(tref.quant_matmul_splits(*args, splits=1, rows=256),
                       tref.quant_matmul(*args))


@pytest.mark.parametrize("K,N", MAIN_SHAPES + [HYMBA_SSM_IN])
@pytest.mark.parametrize("M", [1, 4, 48, 4096])
def test_qmm_plan_cuts_main_shapes(K, N, M):
    group = 32
    p = qmm_plan(M, K, N, group, H100_SMS)
    G = K // group
    assert p.cluster in CLUSTERS and p.cluster <= G
    assert p.rows % group == 0 and p.rows > 0
    # The splits cover K exactly, and none is empty.
    assert p.cluster * p.rows >= K > (p.cluster - 1) * p.rows
    assert 1 <= p.m_chunk <= 64 and p.m_chunk == min(M, 64)
    assert p.mt == (4 if M <= 4 else 16)
    assert p.bn in (64, 128) and (128 if M <= 4 else 64) % (4 * p.ks) == 0
    assert 0 < p.threads <= tqm._THREADS[M > 4]
    assert p.threads % 32 == 0
    if M <= 4:  # decode: all rows of x in one chunk, one row group
        assert p.threads == p.bn // 4 * p.ks
    blocks = math.ceil(N / p.bn) * p.cluster * math.ceil(M / p.m_chunk)
    fit = H100_SMS * tqm._SM_BLOCKS[M > 4] * 9 // 10
    assert p.cluster == 1 or blocks <= fit  # one wave of clusters
    if p.cluster < 8 and 2 * p.cluster <= G:  # more splits would not pay
        assert (blocks >= 2 * H100_SMS or 2 * blocks > fit
                or math.ceil(G / (2 * p.cluster)) * (2 * p.cluster - 1) >= G)


@pytest.mark.parametrize("K,group", [(32, 32), (96, 48), (100, 100),
                                     (512, 512), (1600, 32), (9216, 128)])
def test_qmm_plan_odd_groups(K, group):
    """Few or odd groups: S never exceeds the groups, and no split is
    empty."""
    p = qmm_plan(4, K, 256, group, H100_SMS)
    G = K // group
    assert p.cluster <= G and p.rows % group == 0
    assert p.cluster * p.rows >= K > (p.cluster - 1) * p.rows


@pytest.mark.parametrize("limit", sorted(tqm.NVCC_DEFINES))
def test_kernel_is_built_with_the_plans_limits(limit):
    """The threads a block and blocks an SM that the plan is cut to are
    the ones the kernel is compiled with (its register cap and ring), and
    the library's name changes with them."""
    flags = build.flags("quant_matmul")
    assert f"-D{limit}={tqm.NVCC_DEFINES[limit]}" in flags
    target = build._target("quant_matmul")
    saved = tqm.NVCC_DEFINES[limit]
    try:
        tqm.NVCC_DEFINES[limit] = saved + 1
        assert build._target("quant_matmul") != target
    finally:
        tqm.NVCC_DEFINES[limit] = saved

