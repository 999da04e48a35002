"""The hybrid and MoE families of the port against the JAX package's.

Reduced hymba-1.5b (attention and SSM branches on one norm, fused; meta
tokens through ``prefix`` under a window), olmoe-1b-7b (top-8 of 64
experts, scaled down) and llama4-scout (top-1 routing plus a shared
expert), with the reference's weights carried over as numpy: zoo variants
byte for byte, prefill logits and caches, decode steps, ``forward`` and
``forward_hidden``, and the greedy ids of ``TenantRuntime.generate``.
The decode steps run on an f32 cache: on a bf16 cache the reference
rounds its softmax weights to bf16 where the port's kernels keep f32
(ROADMAP §C), and llama4's top-1 router turns that rounding into a
different expert now and then.  The MoE FFN's ``ragged`` and ``local``
forms against ``dense`` and against the reference's own ``ragged`` and
``local`` (the latter at the layer, on a one-device mesh, the only place
the reference runs it on one CPU device).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant import quantize as JQ
from repro.serving.engine import kv_cache_mb as jkv
from repro.serving.server import _generate_tokens as jgen
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.quant import quantize as TQ
from repro_torch.serving.engine import kv_cache_mb as tkv
from repro_torch.serving.server import TenantRuntime

FAMILIES = ("hymba-1.5b", "olmoe-1b-7b", "llama4-scout-17b-a16e")
MOE = FAMILIES[1:]
LOGIT_TOL = {32: dict(rtol=3e-5, atol=3e-5), 16: dict(rtol=3e-2, atol=3e-2),
             8: dict(rtol=2e-4, atol=2e-4)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    cfg = jget(name, reduced=True)
    return JT.init_params(cfg, jax.random.key(3), jnp.float32)


@functools.lru_cache(maxsize=None)
def _variants(name, bits):
    """(reference variant, the port's variant of the same weights)."""
    params = _ref_params(name)
    if bits == 32:
        return params, TT.params_from_numpy(_np_tree(params))
    return (JQ.quantize_params(params, bits=bits, group=32),
            TQ.quantize_params(TT.params_from_numpy(_np_tree(params)),
                               bits=bits, group=32))


def _prompts(name, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, jget(name, reduced=True).vocab_size, (B, S)).astype(np.int32)


def _flat(tree):
    out = {}
    TQ.tree_map(lambda path, t: out.__setitem__(path, t), tree)
    return out


def _close(got, want, bits):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if bits == 16:  # bf16 rounds at other points: a relative error
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < LOGIT_TOL[16]["rtol"], rel
    else:
        np.testing.assert_allclose(got, want, **LOGIT_TOL[bits])


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("bits", [32, 16, 8])
def test_family_zoo_variant_matches_reference_bit_for_bit(name, bits):
    """Every leaf (meta tokens, the fuse norms, the router, the 3-D
    expert stacks quantized per expert slice) and ``params_nbytes``."""
    jvar, tvar = _variants(name, bits)
    got, want = _flat(tvar), _flat(TT.params_from_numpy(_np_tree(jvar)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        assert torch.equal(got[path], w), path
    assert TQ.params_nbytes(tvar) == JQ.params_nbytes(jvar)
    leaves = {p.split("/")[1] for p in got if p.startswith("layers/")}
    if name == "hymba-1.5b":
        assert {"fuse_na", "fuse_ns", "ssm_in", "wq"} <= leaves
        assert "meta" in tvar
    else:
        assert {"router", "we_g", "we_u", "we_d"} <= leaves
        if bits == 8:
            assert TQ.is_quantized(tvar["layers"]["we_g"])
            assert tvar["layers"]["we_g"]["q"].ndim == 4  # (L, E, D, F)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("batch,max_len", [(2, 20), (4, 33)])
def test_family_cache_bytes_equal_kv_cache_mb(name, batch, max_len):
    """The cache prefill builds is what admission charges, in both
    packages: hymba's k/v (meta rows included), state and conv."""
    cfg = tget(name, reduced=True)
    _, tvar = _variants(name, 32)
    prompts = torch.from_numpy(_prompts(name, B=batch, S=5))
    _, cache = TT.prefill(cfg, tvar, {"tokens": prompts}, max_len=max_len)
    nbytes = sum(t.numel() * t.element_size() for t in cache.values())
    assert nbytes / (1024 * 1024) == tkv(cfg, batch, max_len)
    assert tkv(cfg, batch, max_len) == jkv(jget(name, reduced=True), batch,
                                           max_len)
    want = {"k", "v", "lengths"} | ({"state", "conv"}
                                    if cfg.family == "hybrid" else set())
    assert set(cache) == want


@pytest.mark.parametrize("name,bits", [
    (n, b) for n in FAMILIES for b in (32, 8)] + [
    ("hymba-1.5b", 16), ("olmoe-1b-7b", 16)])
def test_family_prefill_logits_and_cache_match_reference(name, bits):
    jcfg = jget(name, reduced=True)
    jvar, tvar = _variants(name, bits)
    prompts = _prompts(name)
    want, jc = JT.prefill(jcfg, jvar, {"tokens": jnp.asarray(prompts)},
                          max_len=20)
    got, tc = TT.prefill(tget(name, reduced=True), tvar,
                         {"tokens": torch.from_numpy(prompts)}, max_len=20)
    assert set(tc) == set(jc)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.numpy(), want, bits)
    for n, t in tc.items():
        assert t.shape == jc[n].shape, n
        assert str(t.dtype).split(".")[-1] == str(jc[n].dtype), n
        if n == "lengths":
            np.testing.assert_array_equal(t.numpy(), np.asarray(jc[n]))
        elif bits != 16:  # 8-bit and f32 weights: f32 activations,
            # stored in the cache's type (a bf16 leaf within one step of
            # its 8-bit mantissa: a value on a rounding boundary)
            tol = 2.0 ** -8 if t.dtype == torch.bfloat16 else 2e-4
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(jc[n].astype(jnp.float32)),
                rtol=tol, atol=tol, err_msg=n)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("bits", [32, 8])
def test_family_decode_steps_match_reference(name, bits):
    """Prefill and 4 greedy decode steps on an f32 cache: equal ids at
    every step, every step's logits and the final cache within the
    variant's tolerance."""
    jcfg, tcfg = jget(name, reduced=True), tget(name, reduced=True)
    jvar, tvar = _variants(name, bits)
    prompts = _prompts(name)
    jl, jc = JT.prefill(jcfg, jvar, {"tokens": jnp.asarray(prompts)},
                        max_len=18, cache_dtype=jnp.float32)
    tl, tc = TT.prefill(tcfg, tvar, {"tokens": torch.from_numpy(prompts)},
                        max_len=18, cache_dtype=torch.float32)
    for step in range(4):
        _close(tl.numpy(), jl, bits)
        jt, tt = JT.greedy_token(jcfg, jl), TT.greedy_token(tcfg, tl)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"step {step}")
        jl, jc = JT.decode_step(jcfg, jvar, jc, jt)
        tl, tc = TT.decode_step(tcfg, tvar, tc, tt)
    _close(tl.numpy(), jl, bits)
    for n, t in tc.items():
        np.testing.assert_allclose(t.float().numpy(), np.asarray(
            jc[n]).astype(np.float32), rtol=2e-4, atol=2e-4, err_msg=n)


@pytest.mark.parametrize("name,bits", [(n, b) for n in FAMILIES
                                       for b in (32, 8)])
@pytest.mark.parametrize("fn", ["forward", "forward_hidden"])
def test_family_forward_matches_reference(name, bits, fn):
    jvar, tvar = _variants(name, bits)
    prompts = _prompts(name, S=20)
    want = getattr(JT, fn)(jget(name, reduced=True), jvar,
                           {"tokens": jnp.asarray(prompts)})
    got = getattr(TT, fn)(tget(name, reduced=True), tvar,
                          {"tokens": torch.from_numpy(prompts)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.numpy(), want, bits)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_decode_matches_forward(name):
    """Greedy decode logits == teacher-forced full forward logits (the
    reference's test_decode_matches_forward, whose hymba case this is),
    with the reference's tolerance."""
    cfg = tget(name, reduced=True)
    _, params = _variants(name, 32)
    B, S, S0 = 2, 12, 8
    tokens = torch.from_numpy(_prompts(name, B, S, seed=1))
    full = TT.forward(cfg, params, {"tokens": tokens})
    off = full.shape[1] - S
    assert off == cfg.num_meta_tokens
    lp, cache = TT.prefill(cfg, params, {"tokens": tokens[:, :S0]},
                           max_len=S + 2, cache_dtype=torch.float32)
    np.testing.assert_allclose(lp.numpy(), full[:, off + S0 - 1].numpy(),
                               rtol=3e-2, atol=3e-2)
    for i in range(S0, S):
        lp, cache = TT.decode_step(cfg, params, cache, tokens[:, i])
        np.testing.assert_allclose(lp.numpy(), full[:, off + i].numpy(),
                                   rtol=3e-2, atol=3e-2)


def test_meta_tokens_always_visible():
    """hymba's meta tokens reach positions past the window: the
    reference's test on the port (reduced window 8, 20 tokens)."""
    cfg = tget("hymba-1.5b", reduced=True)
    _, params = _variants("hymba-1.5b", 32)
    tokens = {"tokens": torch.from_numpy(_prompts("hymba-1.5b", 1, 20))}
    f1 = TT.forward(cfg, params, tokens)
    f2 = TT.forward(cfg, dict(params, meta=params["meta"] + 1.0), tokens)
    assert float((f1[:, -1] - f2[:, -1]).abs().max()) > 1e-6


def test_meta_tokens_reach_decode_past_the_window():
    """The decode kernel's prefix on the model path: every position of a
    20-token decode sees the meta tokens' change, also past the window."""
    cfg = tget("hymba-1.5b", reduced=True)
    _, params = _variants("hymba-1.5b", 32)
    prompts = torch.from_numpy(_prompts("hymba-1.5b", 2, 4))

    def last(p):
        lp, cache = TT.prefill(cfg, p, {"tokens": prompts}, max_len=24)
        for _ in range(16):
            lp, cache = TT.decode_step(cfg, p, cache,
                                       TT.greedy_token(cfg, lp))
        return lp, cache

    l1, c1 = last(params)
    l2, _ = last(dict(params, meta=params["meta"] + 1.0))
    assert int(c1["lengths"][0]) == 4 + 16 + cfg.num_meta_tokens
    assert float((l1 - l2).abs().max()) > 1e-6


def test_hybrid_cache_has_no_int8_layout():
    cfg = tget("hymba-1.5b", reduced=True)
    _, params = _variants("hymba-1.5b", 32)
    with pytest.raises(ValueError, match="no int8 layout"):
        TT.prefill(cfg, params, {"tokens": torch.zeros((1, 4),
                                                       dtype=torch.int32)},
                   max_len=8, quantize_cache=True)
    # Admission charges the bf16 layout, as the reference does.
    assert tkv(cfg, 2, 12, True) == tkv(cfg, 2, 12, False)


@pytest.mark.parametrize("name", MOE)
def test_moe_ragged_matches_dense(name):
    cfg = tget(name, reduced=True)
    _, params = _variants(name, 32)
    batch = {"tokens": torch.from_numpy(_prompts(name, 2, 16))}
    np.testing.assert_allclose(
        TT.forward(cfg, params, batch, moe_impl="ragged").numpy(),
        TT.forward(cfg, params, batch, moe_impl="dense").numpy(),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("fn", ["prefill", "forward"])
def test_moe_ragged_matches_reference_ragged(name, bits, fn):
    jvar, tvar = _variants(name, bits)
    prompts = _prompts(name, S=16)
    kw = dict(max_len=20) if fn == "prefill" else {}
    want = getattr(JT, fn)(jget(name, reduced=True), jvar,
                           {"tokens": jnp.asarray(prompts)},
                           moe_impl="ragged", **kw)
    got = getattr(TT, fn)(tget(name, reduced=True), tvar,
                          {"tokens": torch.from_numpy(prompts)},
                          moe_impl="ragged", **kw)
    if fn == "prefill":
        (want, _), (got, _) = want, got
    _close(got.numpy(), want, bits)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("T", [12, 80])
def test_moe_local_matches_reference_local(name, bits, T):
    """One layer's ``moe_ffn(impl="local")`` on a (1, 1) data × model
    mesh in the reference, the port's per-expert loop with the same
    capacity.  At 80 tokens every token is one vector plus a little noise,
    so they all route alike and olmoe's favoured experts get 80 slots
    each against a capacity of 40: the two drop the same overflow slots."""
    jcfg, tcfg = jget(name, reduced=True), tget(name, reduced=True)
    jvar, tvar = _variants(name, bits)
    jlp = jax.tree.map(lambda a: a[0], jvar["layers"])
    tlp = TT._layer(tvar["layers"], 0)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T // 2, jcfg.d_model)).astype(np.float32)
    if T > 32:
        x = x * 0.05 + rng.standard_normal(jcfg.d_model).astype(np.float32)
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        want = jax.jit(lambda lp, x: JL.moe_ffn(jcfg, lp, x, impl="local"))(
            jlp, jnp.asarray(x))
    got = TL.moe_ffn(tcfg, tlp, torch.from_numpy(x), impl="local")
    _close(got.numpy(), want, bits)
    dense = TL.moe_ffn(tcfg, tlp, torch.from_numpy(x), impl="dense")
    if T > 32:  # overflow slots dropped: not what dense computes
        assert not np.allclose(got.numpy(), dense.numpy(), atol=1e-3)
    else:  # no slot dropped: the routed sum of dense
        _close(got.numpy(), dense.numpy(), 8)


def test_unknown_moe_impl_raises():
    cfg = tget("olmoe-1b-7b", reduced=True)
    _, params = _variants("olmoe-1b-7b", 32)
    with pytest.raises(ValueError, match="moe_impl"):
        TT.forward(cfg, params, {"tokens": torch.zeros((1, 4),
                                                       dtype=torch.int32)},
                   moe_impl="sparse")


@pytest.mark.parametrize("name", ["hymba-1.5b", "olmoe-1b-7b"])
@pytest.mark.parametrize("bits", [32, 8])
def test_runtime_generate_ids_match_reference(name, bits):
    """``TenantRuntime.generate`` on the CPU (the eager loop, the cache in
    bf16 as served) against the reference's fused ``_generate_tokens``
    on its own quantization of the same weights."""
    params = _ref_params(name)
    rt = TenantRuntime(name, tget(name, reduced=True),
                       TT.params_from_numpy(_np_tree(params)),
                       precisions=(bits,), device="cpu")
    rt.set_variant(rt.zoo.by_bits(bits))
    jvar, _ = _variants(name, bits)
    prompts = _prompts(name, 3, 9, seed=4)
    got = rt.generate(prompts, 6)
    want = np.asarray(jgen(jget(name, reduced=True), jvar,
                           jnp.asarray(prompts), max_new=6, max_len=15))
    assert rt.captures == 0 and rt.pool is None
    np.testing.assert_array_equal(got, want)
