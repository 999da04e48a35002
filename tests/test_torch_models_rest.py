"""The rest of ``tests/test_models.py`` on the port, and the dense
families the model parity tests did not reach.

The reference's ``test_smoke_prefill_decode`` for every reduced
architecture, ``test_vocab_padding_masked`` and
``test_param_count_matches_init``; then reduced yi-6b and granite-3-2b
(the reference's weights carried over as numpy): prefill logits at 32,
16 and 8 bits against ``repro.models.transformer.prefill`` at the
tolerances of ``tests/test_kernels.py`` (f32 3e-5, bf16 3e-2, 8-bit
2e-4), and 8 greedy ids against ``repro.serving.server._generate_tokens``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.quant import quantize as JQ
from repro.serving.server import _generate_tokens as jgen
from repro_torch.configs import get_config as tget
from repro_torch.models import transformer as TT
from repro_torch.quant import quantize as TQ
from repro_torch.serving.server import _generate_tokens as tgen
from repro_torch.training import pytree

LOGIT_TOL = {32: dict(rtol=3e-5, atol=3e-5), 16: dict(rtol=3e-2, atol=3e-2),
             8: dict(rtol=2e-4, atol=2e-4)}


def make_batch(cfg, B=2, S=16, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    shape = (B, S) if cfg.num_codebooks == 1 else (B, S, cfg.num_codebooks)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    if labels:
        batch["labels"] = torch.from_numpy(np.roll(tokens, -1, axis=1))
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_prefill_decode(arch):
    cfg = tget(arch, reduced=True)
    batch = make_batch(cfg, labels=False)
    params = TT.init_params(cfg, 0, torch.float32, device="cpu")
    S = batch["tokens"].shape[1]
    logits, cache = TT.prefill(cfg, params, batch, max_len=S + 4)
    tok = TT.greedy_token(cfg, logits)
    for _ in range(3):
        logits, cache = TT.decode_step(cfg, params, cache, tok)
        tok = TT.greedy_token(cfg, logits)
        assert torch.isfinite(logits).all()
    expected_extra = cfg.num_meta_tokens + (
        cfg.num_vision_tokens if cfg.frontend == "vision_stub" else 0)
    assert int(cache["lengths"][0]) == S + expected_extra + 3


def test_vocab_padding_masked():
    """Padded vocab columns never win argmax and don't affect loss."""
    cfg = tget("granite-3-2b", reduced=True)  # vocab 131 -> pad 144
    assert cfg.padded_vocab > cfg.vocab_size
    params = TT.init_params(cfg, 0, torch.float32, device="cpu")
    batch = make_batch(cfg)
    logits, _ = TT.prefill(cfg, params, batch, max_len=20)
    ids = TT.greedy_token(cfg, logits)
    assert (ids < cfg.vocab_size).all()
    loss, _ = TT.loss_fn(cfg, params, batch, remat=False)
    assert np.isfinite(float(loss))


def test_param_count_matches_init():
    """Config capacity math == actual initialized parameter count."""
    for arch in ARCH_NAMES:
        cfg = tget(arch, reduced=True)
        params = TT.init_params(cfg, 0, torch.float32, device="cpu")
        assert sum(p.numel() for p in pytree.leaves(params)) \
            == cfg.param_count(), arch


def _variants(arch, bits):
    cfg = jget(arch, reduced=True)
    params = JT.init_params(cfg, jax.random.key(5), jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    if bits == 32:
        return cfg, params, TT.params_from_numpy(np_params)
    return (cfg, JQ.quantize_params(params, bits=bits, group=32),
            TQ.quantize_params(TT.params_from_numpy(np_params), bits=bits,
                               group=32))


@pytest.mark.parametrize("arch", ["yi-6b", "granite-3-2b"])
@pytest.mark.parametrize("bits", [32, 16, 8])
def test_dense_family_prefill_matches_reference(arch, bits):
    cfg, jvar, tvar = _variants(arch, bits)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, _ = JT.prefill(cfg, jvar, {"tokens": jnp.asarray(prompts)},
                       max_len=12)
    tl, _ = TT.prefill(tget(arch, reduced=True), tvar,
                       {"tokens": torch.from_numpy(prompts)}, max_len=12)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               **LOGIT_TOL[bits])


@pytest.mark.parametrize("arch", ["yi-6b", "granite-3-2b"])
@pytest.mark.parametrize("bits", [32, 16, 8])
def test_dense_family_greedy_ids_match_reference(arch, bits):
    cfg, jvar, tvar = _variants(arch, bits)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32)
    S = prompts.shape[1]
    want = np.asarray(jgen(cfg, jvar, jnp.asarray(prompts), max_new=8,
                           max_len=S + 8))
    got = tgen(tget(arch, reduced=True), tvar, torch.from_numpy(prompts),
               max_new=8, max_len=S + 8)
    np.testing.assert_array_equal(got.numpy(), want)
