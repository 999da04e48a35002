"""Each hand-written Hopper kernel against its plain PyTorch version, on
the card (marked ``cuda``; skipped without an sm_90 device).  The shapes
are the sweeps of ``test_kernels.py`` plus the main path's widths, in the
dtype combinations the serving path uses.  Imports no JAX: it runs on
the machine with the card.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
QMM_TOL = dict(rtol=2e-4, atol=2e-4)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [(1, 64, 4, 4, 32), (2, 160, 8, 4, 64), (1, 257, 6, 2, 128),
                (2, 128, 25, 5, 64), (4, 12, 32, 4, 64)]
FLASH_MODES = [dict(window=32), dict(softcap=20.0), dict(window=16, prefix=8),
               dict(window=32, softcap=50.0, prefix=4), dict(q_offset=64)]
DECODE_SHAPES = [(2, 300, 8, 4, 64), (1, 64, 4, 4, 32), (3, 1000, 14, 2, 64),
                 (4, 20, 32, 4, 64)]
QMM_SHAPES = [(64, 256, 128, 128, 8), (100, 384, 200, 128, 8),
              (32, 128, 64, 32, 4), (8, 512, 512, 512, 8)]


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def sm90():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


def _on(dev, *arrays, dtype="float32"):
    return [torch.from_numpy(a).to(dev, TDT[dtype]) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", [{}] + FLASH_MODES)
def test_flash_attention_kernel(sm90, B, S, H, KV, D, dtype, kwargs):
    rng = np.random.default_rng(8)
    q, k, v = _on(sm90, rand(rng, B, S, H, D), rand(rng, B, S, KV, D),
                  rand(rng, B, S, KV, D), dtype=dtype)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = tref.flash_attention(q, k, v, **kwargs)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype,kv_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("kwargs", [{}, dict(window=64), dict(softcap=30.0),
                                    dict(window=32, prefix=8)])
def test_decode_attention_kernel(sm90, B, T, H, KV, D, dtype, kv_dtype,
                                 kwargs):
    rng = np.random.default_rng(9)
    (q,) = _on(sm90, rand(rng, B, H, D), dtype=dtype)
    k, v = _on(sm90, rand(rng, B, T, KV, D), rand(rng, B, T, KV, D),
               dtype=kv_dtype)
    lens = torch.from_numpy(rng.integers(1, T, B).astype(np.int32)).to(sm90)
    got = ops.decode_attention(q, k, v, lens, **kwargs)
    want = tref.decode_attention(q, k, v, lens, **kwargs)
    tol = TOL["bfloat16" if "bfloat16" in (dtype, kv_dtype) else "float32"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,group,bits", QMM_SHAPES + [
    (4, 2048, 2048, 32, 8), (48, 5632, 2048, 32, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_kernel(sm90, M, K, N, group, bits, dtype):
    rng = np.random.default_rng(10)
    (x,) = _on(sm90, rand(rng, M, K), dtype=dtype)
    (w,) = _on(sm90, rand(rng, K, N))
    wq, sc = ops.quantize_weights(w, bits=bits, group=group)
    got = ops.quant_matmul(x, wq, sc)
    want = tref.quant_matmul(x, wq, sc)
    tol = QMM_TOL if dtype == "float32" else TOL["bfloat16"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
