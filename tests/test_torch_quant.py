"""The port's zoo quantization and ``fidelity`` against the JAX package's.

Ports of ``tests/test_quant.py`` on the port's own functions (size
reduction, 1-D leaves left alone, the quantized forward and decode finite,
quantized == dequantized at 2e-4, the fidelity ordering 8 > 4 bits), with
reduced tinyllama's reference weights carried over as numpy, and
``fidelity``'s numbers held to the reference's on the same weights and
tokens: equal top-1 agreement, logit MSE within 1e-4 relative.  The MSE
is of differences about 0.02 (8 bits) wide, while each side's logits may
move by the forward's f32 tolerance, 3e-5, and sum in another order; the
two sides measured 8e-7 apart (8 bits) and 5e-7 (4 bits) on this input.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.quant import quantize as JQ
from repro_torch.configs import get_config as tget
from repro_torch.models import transformer as TT
from repro_torch.quant import quantize as TQ

MSE_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jget("tinyllama-1.1b", reduced=True)
    jparams = JT.init_params(jcfg, jax.random.key(3), jnp.float32)
    params = TT.params_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    return (tget("tinyllama-1.1b", reduced=True), params,
            {"tokens": torch.from_numpy(tokens)}, jcfg, jparams,
            {"tokens": jnp.asarray(tokens)})


def test_size_reduction(setup):
    _, params, *_ = setup
    base = TQ.params_nbytes(params)
    q16 = TQ.quantize_params(params, bits=16)
    q8 = TQ.quantize_params(params, bits=8, group=32)
    assert TQ.params_nbytes(q16) < base * 0.6
    assert TQ.params_nbytes(q8) < base * 0.45  # ~3.5x (paper observation B)


def test_one_d_params_not_quantized(setup):
    _, params, *_ = setup
    q8 = TQ.quantize_params(params, bits=8, group=32)
    assert not TQ.is_quantized(q8["layers"]["ln1"])
    assert q8["layers"]["ln1"].dtype == params["layers"]["ln1"].dtype
    assert not TQ.is_quantized(q8["embed"])


def test_quantized_forward_runs_directly(setup):
    """``mm`` serves {"q","s"} weights through ``quant_matmul`` without
    dequantizing them."""
    cfg, params, batch, *_ = setup
    q8 = TQ.quantize_params(params, bits=8, group=32)
    logits = TT.forward(cfg, q8, batch)
    assert logits.shape == (2, 16, 1, cfg.padded_vocab)
    assert torch.isfinite(logits).all()


def test_quantized_equals_dequantized(setup):
    """Serving through quant_matmul == the dense forward on dequantized
    weights."""
    cfg, params, batch, *_ = setup
    q8 = TQ.quantize_params(params, bits=8, group=32)
    f_q = TT.forward(cfg, q8, batch)
    f_d = TT.forward(cfg, TQ.dequantize_params(q8), batch)
    np.testing.assert_allclose(f_q.numpy(), f_d.numpy(), rtol=2e-4,
                               atol=2e-4)


def _tfwd(cfg, params, batch):
    return TT.forward(cfg, params, batch)[..., 0, :]


def _jfwd(cfg, params, batch):
    return JT.forward(cfg, params, batch)[..., 0, :]


def test_fidelity_ordering(setup):
    """Paper observation (C): lower precision, lower accuracy.  int8 stays
    close to the reference; int4 degrades substantially."""
    cfg, params, batch, *_ = setup
    f8 = TQ.fidelity(cfg, params, TQ.quantize_params(params, bits=8,
                                                     group=32), batch, _tfwd)
    f4 = TQ.fidelity(cfg, params, TQ.quantize_params(params, bits=4,
                                                     group=32), batch, _tfwd)
    assert f8["top1_agreement"] > f4["top1_agreement"]
    assert f8["logit_mse"] < f4["logit_mse"]
    assert f8["top1_agreement"] > 85.0


@pytest.mark.parametrize("bits", [8, 4])
def test_fidelity_matches_reference(setup, bits):
    cfg, params, batch, jcfg, jparams, jbatch = setup
    got = TQ.fidelity(cfg, params, TQ.quantize_params(params, bits=bits,
                                                      group=32), batch, _tfwd)
    want = JQ.fidelity(jcfg, jparams, JQ.quantize_params(
        jparams, bits=bits, group=32), jbatch, _jfwd)
    assert set(got) == set(want) == {"top1_agreement", "logit_mse"}
    assert all(isinstance(v, float) for v in got.values())
    assert got["top1_agreement"] == want["top1_agreement"]
    assert got["logit_mse"] == pytest.approx(want["logit_mse"],
                                             rel=MSE_RTOL)


def test_quantized_decode(setup):
    cfg, params, batch, *_ = setup
    q8 = TQ.quantize_params(params, bits=8, group=32)
    logits, cache = TT.prefill(cfg, q8, batch, max_len=20)
    tok = TT.greedy_token(cfg, logits)
    logits, cache = TT.decode_step(cfg, q8, cache, tok)
    assert torch.isfinite(logits).all()
