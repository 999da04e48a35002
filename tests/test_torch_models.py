"""The port's model, zoo and budget math against the JAX package's.

Reduced tinyllama and mamba2 with the reference's weights carried over
as numpy: prefill logits (and mamba2's SSM cache) of the 32-, 16- and
8-bit variants against ``repro.models.transformer.prefill``, and 8-token
greedy decodes against ``repro.serving.server._generate_tokens``; reduced
gemma2's prefill and greedy decodes.  ``forward`` and ``forward_hidden``
against the reference's (reduced tinyllama, gemma2 and mamba2 at 32 and 8
bits, the vision and audio families at 32), and against the port's own
prefill and decode.  For all ten configs: the
configs, ``params_nbytes`` per zoo variant, ``zoo_from_config`` and
``kv_cache_mb`` equal to the reference's, at reduced size and (by shape
math, no weights) at full size.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_config as jget
from repro.core.model_zoo import zoo_from_config as jzoo
from repro.models import transformer as JT
from repro.quant import quantize as JQ
from repro.serving.engine import kv_cache_mb as jkv
from repro.serving.server import _generate_tokens as jgen
from repro_torch.configs import get_config as tget
from repro_torch.core.model_zoo import zoo_from_config as tzoo
from repro_torch.models import transformer as TT
from repro_torch.quant import quantize as TQ
from repro_torch.serving.engine import kv_cache_mb as tkv
from repro_torch.serving.server import _generate_tokens as tgen

# Tolerances of tests/test_kernels.py, by the variant's arithmetic.
LOGIT_TOL = {32: dict(rtol=3e-5, atol=3e-5), 16: dict(rtol=3e-2, atol=3e-2),
             8: dict(rtol=2e-4, atol=2e-4)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tinyllama():
    cfg = jget("tinyllama-1.1b", reduced=True)
    params = JT.init_params(cfg, jax.random.key(3), jnp.float32)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32)
    return cfg, params, prompts


def _variants(params, bits):
    jvar = JQ.quantize_params(params, bits=bits, group=32)
    tvar = TQ.quantize_params(TT.params_from_numpy(_np_tree(params)),
                              bits=bits, group=32)
    return jvar, tvar


def _flat(tree):
    out = {}
    TQ.tree_map(lambda path, t: out.__setitem__(path, t), tree)
    return out


@pytest.mark.parametrize("bits", [32, 16, 8])
def test_zoo_variant_matches_reference_bit_for_bit(tinyllama, bits):
    _, params, _ = tinyllama
    jvar, tvar = _variants(params, bits)
    got, want = _flat(tvar), _flat(TT.params_from_numpy(_np_tree(jvar)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        assert torch.equal(got[path], w), path
    assert TQ.params_nbytes(tvar) == JQ.params_nbytes(jvar)


@pytest.mark.parametrize("bits", [32, 16, 8])
def test_prefill_logits_match_reference(tinyllama, bits):
    cfg, params, prompts = tinyllama
    jvar, tvar = _variants(params, bits)
    S = prompts.shape[1]
    want, jcache = JT.prefill(cfg, jvar, {"tokens": jnp.asarray(prompts)},
                              max_len=S + 4)
    got, tcache = TT.prefill(tget("tinyllama-1.1b", reduced=True), tvar,
                             {"tokens": torch.from_numpy(prompts)},
                             max_len=S + 4)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got, want = got.numpy(), np.asarray(want)
    if bits == 16:
        # bf16 rounds at different points in the two packages (the
        # reference's inline attention rounds its softmax weights to bf16;
        # the kernels keep f32), and the error a logit near zero inherits
        # is that of the largest ones: hold the bf16 variant's logits to
        # the bf16 tolerance as a relative error of the whole vector.
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < LOGIT_TOL[16]["rtol"], rel
    else:
        np.testing.assert_allclose(got, want, **LOGIT_TOL[bits])
    assert tcache["k"].shape == jcache["k"].shape
    assert tcache["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))


@pytest.mark.parametrize("bits", [32, 16, 8])
def test_greedy_decode_ids_match_reference(tinyllama, bits):
    """8 greedy tokens through prefill and the decode loop (the port's
    decode attention keeps softmax weights in f32 where the reference
    rounds them to the bf16 cache's type; the ids still agree)."""
    cfg, params, prompts = tinyllama
    jvar, tvar = _variants(params, bits)
    S = prompts.shape[1]
    want = np.asarray(jgen(cfg, jvar, jnp.asarray(prompts), max_new=8,
                           max_len=S + 8))
    got = tgen(tget("tinyllama-1.1b", reduced=True), tvar,
               torch.from_numpy(prompts), max_new=8, max_len=S + 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_windowed_softcapped_family_prefill_matches_reference():
    """gemma2 (local/global windows, attention and final softcaps, post
    norms, scaled embeddings, gelu) at f32: the masking paths of the
    attention kernels on the model path."""
    cfg = jget("gemma2-2b", reduced=True)
    params = JT.init_params(cfg, jax.random.key(5), jnp.float32)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = JT.prefill(cfg, params, {"tokens": jnp.asarray(prompts)},
                         max_len=16)
    got, _ = TT.prefill(tget("gemma2-2b", reduced=True),
                        TT.params_from_numpy(_np_tree(params)),
                        {"tokens": torch.from_numpy(prompts)}, max_len=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **LOGIT_TOL[32])


@pytest.fixture(scope="module")
def mamba2():
    cfg = jget("mamba2-780m", reduced=True)
    return cfg, JT.init_params(cfg, jax.random.key(3), jnp.float32)


def _mamba2_prompts(cfg, S):
    return np.random.default_rng(S).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)


@pytest.mark.parametrize("bits", [32, 16, 8])
def test_mamba2_zoo_variant_matches_reference_bit_for_bit(mamba2, bits):
    _, params = mamba2
    jvar, tvar = _variants(params, bits)
    got, want = _flat(tvar), _flat(TT.params_from_numpy(_np_tree(jvar)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        assert torch.equal(got[path], w), path
    if bits == 8:  # depthwise conv taps are never quantized
        assert not TQ.is_quantized(tvar["layers"]["conv_w"])
        assert TQ.is_quantized(tvar["layers"]["ssm_in"])


# 20 tokens cross the reduced config's 16-token chunk with a ragged tail;
# 1 and 2 are shorter than the conv's 3-token tail (zeros in front).
@pytest.mark.parametrize("S", [20, 1, 2])
@pytest.mark.parametrize("bits", [32, 16, 8])
def test_mamba2_prefill_logits_and_cache_match_reference(mamba2, bits, S):
    cfg, params = mamba2
    jvar, tvar = _variants(params, bits)
    prompts = _mamba2_prompts(cfg, S)
    want, jcache = JT.prefill(cfg, jvar, {"tokens": jnp.asarray(prompts)},
                              max_len=S + 4)
    got, tcache = TT.prefill(tget("mamba2-780m", reduced=True), tvar,
                             {"tokens": torch.from_numpy(prompts)},
                             max_len=S + 4)
    assert set(tcache) == set(jcache) == {"state", "conv", "lengths"}
    assert tcache["state"].dtype == torch.float32
    assert tcache["conv"].dtype == torch.bfloat16
    got_s, want_s = tcache["state"].numpy(), np.asarray(jcache["state"])
    got_c = tcache["conv"].float().numpy()
    want_c = np.asarray(jcache["conv"].astype(jnp.float32))
    got, want = got.numpy(), np.asarray(want)
    if bits == 16:
        # bf16 products round at other points in the two packages, and
        # the scan carries the difference through the layers: hold the
        # logits and the cache as relative errors at the bf16 tolerance.
        for g, w in ((got, want), (got_s, want_s), (got_c, want_c)):
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel < LOGIT_TOL[16]["rtol"], rel
    else:
        np.testing.assert_allclose(got, want, **LOGIT_TOL[bits])
        np.testing.assert_allclose(got_s, want_s, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))


def test_mamba2_decode_step_keeps_the_cache_types(mamba2):
    """The 8-bit variant decodes its conv buffer in f32 (its embedding
    stays f32); the port stores it in the cache's bf16 as the reference's
    serving loop casts it, and the state and buffer match that cast."""
    cfg, params = mamba2
    jvar, tvar = _variants(params, 8)
    prompts = _mamba2_prompts(cfg, 20)
    tok = prompts[:, -1]
    _, jcache = JT.prefill(cfg, jvar, {"tokens": jnp.asarray(prompts)},
                           max_len=24)
    _, jnew = JT.decode_step(cfg, jvar, jcache, jnp.asarray(tok))
    assert jnew["conv"].dtype == jnp.float32
    _, tcache = TT.prefill(tget("mamba2-780m", reduced=True), tvar,
                           {"tokens": torch.from_numpy(prompts)}, max_len=24)
    _, tnew = TT.decode_step(tget("mamba2-780m", reduced=True), tvar,
                             tcache, torch.from_numpy(tok))
    assert tnew["conv"].dtype == torch.bfloat16
    assert tnew["state"].dtype == torch.float32
    np.testing.assert_array_equal(
        tnew["conv"].float().numpy(),
        np.asarray(jnew["conv"].astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_allclose(tnew["state"].numpy(),
                               np.asarray(jnew["state"]), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("bits", [32, 16, 8])
def test_mamba2_greedy_decode_ids_match_reference(mamba2, bits):
    """8 greedy tokens after a 20-token prompt: the SSM state and the conv
    buffer carried through the decode loop in the cache's types."""
    cfg, params = mamba2
    jvar, tvar = _variants(params, bits)
    prompts = _mamba2_prompts(cfg, 20)
    want = np.asarray(jgen(cfg, jvar, jnp.asarray(prompts), max_new=8,
                           max_len=28))
    got = tgen(tget("mamba2-780m", reduced=True), tvar,
               torch.from_numpy(prompts), max_new=8, max_len=28)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [32, 8])
def test_gemma2_greedy_decode_ids_match_reference(bits):
    """Reduced gemma2 decodes past its 8-token window: the windowed and
    softcapped decode path against the reference's serving loop."""
    cfg = jget("gemma2-2b", reduced=True)
    params = JT.init_params(cfg, jax.random.key(5), jnp.float32)
    jvar, tvar = _variants(params, bits)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jgen(cfg, jvar, jnp.asarray(prompts), max_new=8,
                           max_len=20))
    got = tgen(tget("gemma2-2b", reduced=True), tvar,
               torch.from_numpy(prompts), max_new=8, max_len=20)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The decode cache's other layouts: int8 k/v with f32 scales, the deferred
# write of uniform_pos, and pages read through paged_decode_attention.
# ---------------------------------------------------------------------------
ATTN = {"tinyllama-1.1b": 3, "gemma2-2b": 5}  # arch -> reference init key


@functools.lru_cache(maxsize=None)
def _attn_model(name):
    cfg = jget(name, reduced=True)
    return cfg, JT.init_params(cfg, jax.random.key(ATTN[name]), jnp.float32)


def _attn_variants(name, bits):
    cfg, params = _attn_model(name)
    if bits == 32:
        return cfg, params, TT.params_from_numpy(_np_tree(params))
    return (cfg,) + _variants(params, bits)


def _attn_prompts(cfg):
    # 12 tokens: past reduced gemma2's 8-token window, as its decode is.
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)


def _close_logits(got, want, bits):
    got, want = got.numpy(), np.asarray(want)
    if bits == 16:  # as in test_prefill_logits_match_reference
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < LOGIT_TOL[16]["rtol"], rel
    else:
        np.testing.assert_allclose(got, want, **LOGIT_TOL[bits])


@pytest.mark.parametrize("shape", [(2, 7, 4, 16), (3, 2, 64), (1, 5, 1, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(shape, dtype):
    """Equal int8 values and f32 scales on equal inputs (round half to
    even, the 1e-8 floor on an all-zero row)."""
    from repro.models.layers import quantize_kv as jquant
    from repro_torch.models.layers import quantize_kv as tquant

    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    x[0, 0] = 0.0  # a row whose scale takes the floor
    x.reshape(-1, shape[-1])[-1, :3] = (127.0, 2.5, -0.5)  # scale 1: ties
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jquant(jx)
    tq, ts = tquant(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("name", list(ATTN))
@pytest.mark.parametrize("bits", [32, 16, 8])
def test_int8_cache_prefill_matches_reference(name, bits):
    """prefill(quantize_cache=True): the int8 cache's scales at the
    variant's tolerance, its dequantized k/v within one quantization step
    of the reference's (16-bit: bf16 activations round at other points,
    so the dequantized cache is held as a relative error at the bf16
    tolerance), and the logits as for the bf16 cache."""
    cfg, jvar, tvar = _attn_variants(name, bits)
    prompts = _attn_prompts(cfg)
    want, jc = JT.prefill(cfg, jvar, {"tokens": jnp.asarray(prompts)},
                          max_len=20, quantize_cache=True)
    got, tc = TT.prefill(tget(name, reduced=True), tvar,
                         {"tokens": torch.from_numpy(prompts)}, max_len=20,
                         quantize_cache=True)
    assert set(tc) == set(jc) == {"k", "v", "k_scale", "v_scale", "lengths"}
    _close_logits(got, want, bits)
    for n in ("k", "v"):
        assert tc[n].dtype == torch.int8 and tc[n].shape == jc[n].shape
        assert tc[n + "_scale"].dtype == torch.float32
        ts, js = tc[n + "_scale"].numpy(), np.asarray(jc[n + "_scale"])
        deq_t = tc[n].numpy() * ts[..., None]
        deq_j = np.asarray(jc[n]) * js[..., None]
        if bits == 16:
            for g, w in ((ts, js), (deq_t, deq_j)):
                rel = np.linalg.norm(g - w) / np.linalg.norm(w)
                assert rel < LOGIT_TOL[16]["rtol"], (n, rel)
        else:
            np.testing.assert_allclose(ts, js, **LOGIT_TOL[32])
            step = js[..., None] * (1 + 1e-5)
            assert (np.abs(deq_t - deq_j) <= step).all(), n
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def _decode_both(name, bits, steps, *, quantize_cache=False,
                 cache_dtype="bfloat16", uniform_pos=False):
    """Prefill and ``steps`` greedy decode steps in both packages; the
    ids must agree at every step (so both decode the same tokens).
    Returns [(port logits, reference logits)] and the final caches."""
    cfg, jvar, tvar = _attn_variants(name, bits)
    tcfg = tget(name, reduced=True)
    prompts = _attn_prompts(cfg)
    jl, jc = JT.prefill(cfg, jvar, {"tokens": jnp.asarray(prompts)},
                        max_len=20, quantize_cache=quantize_cache,
                        cache_dtype=getattr(jnp, cache_dtype))
    tl, tc = TT.prefill(tcfg, tvar, {"tokens": torch.from_numpy(prompts)},
                        max_len=20, quantize_cache=quantize_cache,
                        cache_dtype=getattr(torch, cache_dtype))
    pairs = [(tl, jl)]
    for step in range(steps):
        jt, tt = JT.greedy_token(cfg, jl), TT.greedy_token(tcfg, tl)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"step {step}")
        jl, jc = JT.decode_step(cfg, jvar, jc, jt, uniform_pos=uniform_pos)
        tl, tc = TT.decode_step(tcfg, tvar, tc, tt, uniform_pos=uniform_pos)
        pairs.append((tl, jl))
    return pairs, tc, jc


@pytest.mark.parametrize("name", list(ATTN))
@pytest.mark.parametrize("bits", [32, 16, 8])
def test_int8_cache_decode_matches_reference(name, bits):
    """8 greedy steps on the int8 cache (the deferred write of the fresh
    token's int8 k/v and scales at lengths[0]): equal ids, and every
    step's logits within the variant's tolerance."""
    pairs, tc, jc = _decode_both(name, bits, 8, quantize_cache=True)
    for got, want in pairs:
        _close_logits(got, want, bits)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    if bits != 16:  # the written tokens' scales (f32 activations)
        np.testing.assert_allclose(tc["k_scale"].numpy(),
                                   np.asarray(jc["k_scale"]),
                                   **LOGIT_TOL[32])


@pytest.mark.parametrize("name", list(ATTN))
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_uniform_pos_decode_matches_reference(name, cache_dtype):
    """decode_step(uniform_pos=True) on the f32 variant: the attention
    reads the cache plus the fresh token through a log-sum-exp, and the
    fresh k/v land at lengths[0].  With an f32 cache both packages
    compute in f32 (tolerance 3e-5); with a bf16 cache the reference
    rounds the softmax weights to bf16 before the value product, and a
    weight that falls on a rounding boundary may round the other way, so
    the bf16 tolerance holds."""
    tol = LOGIT_TOL[32 if cache_dtype == "float32" else 16]
    pairs, tc, jc = _decode_both(name, 32, 8, cache_dtype=cache_dtype,
                                 uniform_pos=True)
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for n in ("k", "v"):
        assert tc[n].dtype == getattr(torch, cache_dtype)
        np.testing.assert_allclose(
            tc[n].float().numpy(), np.asarray(jc[n].astype(jnp.float32)),
            **tol)


@pytest.mark.parametrize("name", list(ATTN))
def test_paged_decode_replay_matches_dense(name, monkeypatch):
    """A CPU replay whose decode attention pages each layer's cache with
    paginate_kv (page sizes 3 and 8) and reads it through the plain
    paged_decode_attention gives the dense decode's logits."""
    from repro_torch.kernels import ops

    cfg = tget(name, reduced=True)
    _, _, tvar = _attn_variants(name, 32)
    prompts = torch.from_numpy(_attn_prompts(cfg))
    dense = ops.decode_attention
    calls = []

    def paged(q, k_cache, v_cache, lengths, **kw):
        want = dense(q, k_cache, v_cache, lengths, **kw)
        for ps in (3, 8):
            pages = ops.paginate_kv(k_cache, v_cache, lengths, ps)
            got = ops.paged_decode_attention(q, *pages, lengths, **kw)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       **LOGIT_TOL[32])
            calls.append(ps)
        return got

    def run():
        logits, cache = TT.prefill(cfg, tvar, {"tokens": prompts},
                                   max_len=16)
        out = [logits]
        for _ in range(4):
            logits, cache = TT.decode_step(cfg, tvar, cache,
                                           TT.greedy_token(cfg, logits))
            out.append(logits)
        return out

    want = run()
    monkeypatch.setattr(ops, "decode_attention", paged)
    got = run()
    assert len(calls) == 4 * cfg.num_layers * 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **LOGIT_TOL[32])


# ---------------------------------------------------------------------------
# The full-sequence forward: against the reference, and against the port's
# own prefill and decode (the reference's test_decode_matches_forward).
# ---------------------------------------------------------------------------
FORWARD = {"tinyllama-1.1b": 3, "gemma2-2b": 5, "mamba2-780m": 3,
           "internvl2-1b": 7, "musicgen-large": 7}  # arch -> init key


@functools.lru_cache(maxsize=None)
def _ref_model(name):
    cfg = jget(name, reduced=True)
    return cfg, JT.init_params(cfg, jax.random.key(FORWARD[name]),
                               jnp.float32)


def _forward_batch(cfg, B, S, seed=0):
    """numpy tokens (B, S) or (B, S, Kcb), and patch embeddings for the
    vision stub."""
    rng = np.random.default_rng(seed)
    shape = (B, S) if cfg.num_codebooks == 1 else (B, S, cfg.num_codebooks)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# 20 tokens: past reduced gemma2's 8-token window and across mamba2's
# 16-token chunk.  The vision and audio families at f32.
@pytest.mark.parametrize("name,bits", [
    (n, b) for n in ("tinyllama-1.1b", "gemma2-2b", "mamba2-780m")
    for b in (32, 8)] + [("internvl2-1b", 32), ("musicgen-large", 32)])
@pytest.mark.parametrize("fn", ["forward", "forward_hidden"])
def test_forward_matches_reference(name, bits, fn):
    cfg, params = _ref_model(name)
    if bits == 32:
        jvar, tvar = params, TT.params_from_numpy(_np_tree(params))
    else:
        jvar, tvar = _variants(params, bits)
    jbatch, tbatch = _both(_forward_batch(cfg, 2, 20))
    want = getattr(JT, fn)(cfg, jvar, jbatch)
    got = getattr(TT, fn)(tget(name, reduced=True), tvar, tbatch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **LOGIT_TOL[bits])


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "mamba2-780m",
                                  "gemma2-2b", "musicgen-large"])
def test_decode_matches_forward(name):
    """Greedy decode logits == teacher-forced full forward logits (the
    reference's test on the port, with the reference's weights and its
    tolerance)."""
    cfg = tget(name, reduced=True)
    params = TT.params_from_numpy(_np_tree(_ref_model(name)[1]))
    B, S, S0 = 2, 12, 8
    batch = {k: torch.from_numpy(v)
             for k, v in _forward_batch(cfg, B, S, seed=1).items()}
    tokens = batch["tokens"]
    full = TT.forward(cfg, params, batch)  # (B, S_total, Kcb, Vp)
    off = full.shape[1] - S
    lp, cache = TT.prefill(cfg, params, dict(batch, tokens=tokens[:, :S0]),
                           max_len=S + 2, cache_dtype=torch.float32)
    np.testing.assert_allclose(lp.numpy(), full[:, off + S0 - 1].numpy(),
                               rtol=3e-2, atol=3e-2)
    for i in range(S0, S):
        lp, cache = TT.decode_step(cfg, params, cache, tokens[:, i])
        np.testing.assert_allclose(lp.numpy(), full[:, off + i].numpy(),
                                   rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("kw,item", [(dict(remat=True), "A9")])
@pytest.mark.parametrize("fn", ["forward", "forward_hidden"])
def test_forward_modes_not_ported_raise(kw, item, fn):
    """The modes that raised until their ROADMAP item was ported now run:
    ``remat=True`` (A9, training) recomputes each block in the backward
    and leaves the forward's values unchanged."""
    cfg = tget("tinyllama-1.1b", reduced=True)
    params = TT.init_params(cfg, 0, torch.float32, device="cpu")
    batch = {"tokens": torch.arange(4, dtype=torch.int32)[None]}
    assert item == "A9"
    got = getattr(TT, fn)(cfg, params, batch, **kw)
    assert torch.equal(got, getattr(TT, fn)(cfg, params, batch))


def test_init_params_without_a_card_names_the_cause(monkeypatch):
    """Asking for CUDA where there is none raises the port's message,
    not torch's about its CUDA generator."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget("tinyllama-1.1b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        TT.init_params(cfg, 0, torch.float32)


def test_sliding_window_restricts_context():
    """Causality through the windowed layers: changing the last token must
    not move any earlier position's logits (the reference's test on the
    port, reduced gemma2 with its 8-token window)."""
    cfg = tget("gemma2-2b", reduced=True)
    jcfg = jget("gemma2-2b", reduced=True)
    params = TT.params_from_numpy(_np_tree(
        JT.init_params(jcfg, jax.random.key(0), jnp.float32)))
    t1 = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 24))
    t3 = t1.copy()
    t3[0, -1] = (t1[0, -1] + 1) % cfg.vocab_size
    f1 = TT.forward(cfg, params, {"tokens": torch.from_numpy(t1)})
    f3 = TT.forward(cfg, params, {"tokens": torch.from_numpy(t3)})
    np.testing.assert_allclose(f1[:, :-1].numpy(), f3[:, :-1].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not torch.equal(f1[:, -1], f3[:, -1])


# ---------------------------------------------------------------------------
# Configs, zoos and budgets for all ten architectures.
# ---------------------------------------------------------------------------
def _shape_nbytes(abstract, bits, group=32):
    """The reference's quantize_params rule, applied to leaf shapes."""
    total = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(abstract):
        ps = JQ._path_str(path)
        n = int(np.prod(leaf.shape))
        if bits >= 16:
            total += n * (bits // 8 if leaf.ndim >= 2 else 4)
            continue
        min_ndim = 3 if ps.startswith("layers") else 2
        if any(e in ps for e in JQ._EXCLUDE) or leaf.ndim < min_ndim:
            total += n * leaf.dtype.itemsize
            continue
        K = leaf.shape[-2]
        G = K // group if K % group == 0 else 1
        total += n + n // K * G * 4
    return total


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("reduced", [True, False])
def test_config_zoo_and_kv_budget_match_reference(name, reduced):
    jcfg, tcfg = jget(name, reduced=reduced), tget(name, reduced=reduced)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for precisions in ((16, 8, 4), (16, 8)):
        jz, tz = jzoo(jcfg, precisions=precisions), tzoo(
            tcfg, precisions=precisions)
        assert [dataclasses.astuple(v) for v in tz.variants] == \
            [dataclasses.astuple(v) for v in jz.variants]
    for batch, max_len in ((1, 8), (4, 32), (2, 12)):
        for quantized in (False, True):
            assert tkv(tcfg, batch, max_len, quantized) == \
                jkv(jcfg, batch, max_len, quantized)
    # Shapes only on both sides: the port's params on the meta device, the
    # reference's quantize_params traced over abstract params (at full
    # size its per-slice loops take minutes to trace, so the reference's
    # rule is applied to the leaf shapes instead).
    tparams = TT.init_params(tcfg, 0, torch.float32, device="meta")
    abstract = JT.abstract_params(jcfg, jnp.float32)
    for bits in (16, 8, 4):
        got = TQ.params_nbytes(TQ.quantize_params(tparams, bits=bits,
                                                  group=32))
        if reduced:
            want = sum(leaf.size * leaf.dtype.itemsize
                       for leaf in jax.tree.leaves(jax.eval_shape(
                           functools.partial(JQ.quantize_params, bits=bits,
                                             group=32), abstract)))
        else:
            want = _shape_nbytes(abstract, bits)
        assert got == want, (name, bits)
