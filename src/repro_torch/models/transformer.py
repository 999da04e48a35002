"""Unified LM-family model: parameters, caches, prefill, decode and the
full-sequence forward.

Port of :mod:`repro.models.transformer`.  Parameters and caches are plain
dicts of tensors keyed like the reference's pytrees, per-layer leaves
stacked along a leading ``L`` axis; where the reference scans over layers,
the port runs a Python loop over the slices.  Every family's block is
ported: attention (dense, vlm, audio), the pure SSM (mamba2), the hybrid
block whose attention and SSM branches share one norm and are fused
(hymba), and the MoE FFN (olmoe, llama4).  Training's pieces are ported
too: :func:`loss_fn` (sequence-chunked cross entropy with z-loss, each
chunk recomputed in the backward) and ``remat=True`` (each block
recomputed in the backward), both through ``torch.utils.checkpoint``
where the reference uses ``jax.checkpoint``.

Remat keeps what the reference's policy keeps: with
:func:`set_remat_save_tp` on (the default), the five products the
reference names ``"tp_out"`` (the attention and hybrid output
projections, the SSM's ``ssm_out``, the MLP's down projection, the MoE
FFN's output) are kept across the checkpoint, and everything else in the
block is recomputed.  A tagged product goes through :func:`_tp_out`: in a
remat's forward it keeps the product, and in the recomputation it hands
the kept one back in order, so a projection is not multiplied again while
its backward still gets the inputs it saves.  Only :func:`_tp_out` looks
at the remat's state, a thread-local set by the checkpoint's two
contexts; no dispatch mode sees the block's other operations.  The
recomputation stops once the backward has every tensor it saves, so a
product that only feeds the block's output is not rerun with or without
the kept products, as the reference's recomputation drops it as dead
code.  The reference's ``set_scan_unroll`` has no counterpart: the port
loops over the layers in Python, so a layer is never a scan body that a
cost count would see once.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

PyTree = Any

# Save exactly the reference's "tp_out" products across the remat
# boundary (its row-parallel outputs, each the result of a model-axis
# all-reduce there).  Costs about 2 L B S D bf16 of residency, so the
# launcher turns it off for the largest tenant, as the reference's does.
REMAT_SAVE_TP: bool = True
# The remat context of this thread (a _Kept, or None): the forward runs on
# the caller's thread and its recomputation on the backward's.
_REMAT = threading.local()


def set_remat_save_tp(on: bool) -> None:
    global REMAT_SAVE_TP
    REMAT_SAVE_TP = on


class _Kept:
    """One remat call's tagged products: its forward appends each
    (``load`` False), its recomputation reads them back in order (``load``
    True; from the first again on every recomputation)."""

    def __init__(self, kept: list, load: bool):
        self.kept, self.load, self.i = kept, load, 0

    def __enter__(self):
        self.prev, _REMAT.ctx, self.i = getattr(_REMAT, "ctx", None), self, 0

    def __exit__(self, *exc):
        _REMAT.ctx = self.prev


def _kept_contexts():
    kept: list = []
    return _Kept(kept, False), _Kept(kept, True)


class _KeptMM(torch.autograd.Function):
    """``x @ w`` that saves its inputs, as the matmul's backward needs;
    given the product already (``out[0]``), it multiplies nothing."""

    @staticmethod
    def forward(ctx, x, w, out):
        ctx.save_for_backward(x, w)
        return x @ w if out[0] is None else out[0].detach()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.mT if ctx.needs_input_grad[0] else None
        gw = (x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw, None


def _tp_out(x, w=None):
    """The tagged product ``x @ w`` (``x`` itself where ``w`` is None),
    kept across the remat it runs in, if any."""
    ctx = getattr(_REMAT, "ctx", None)
    if ctx is None:
        return x if w is None else L.mm(x, w)
    if ctx.load:
        out = ctx.kept[ctx.i]
        ctx.i += 1
        return out if w is None else _KeptMM.apply(x, w, [out])
    out = x if w is None else _KeptMM.apply(x, w, [None])
    ctx.kept.append(out.detach())
    return out


def _remat(fn, *args):
    """``fn(*args)`` recomputed in the backward, keeping the tagged
    products when :data:`REMAT_SAVE_TP` is on."""
    kw = dict(context_fn=_kept_contexts) if REMAT_SAVE_TP else {}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)

# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------
def _layer_param_template(cfg: ModelConfig
                          ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, init kind). Shapes are per-layer (no L dim)."""
    D, F = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    t: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    hybrid = cfg.family == "hybrid"
    if cfg.uses_attention:
        t["ln1"] = ((D,), "zeros")
        t["wq"] = ((D, H * hd), "dense")
        t["wk"] = ((D, KV * hd), "dense")
        t["wv"] = ((D, KV * hd), "dense")
        t["wo"] = ((H * hd, D), "dense")
        if cfg.post_norm:
            t["post_ln1"] = ((D,), "zeros")
        if cfg.qk_norm:
            t["q_norm"] = ((hd,), "zeros")
            t["k_norm"] = ((hd,), "zeros")
    if cfg.uses_ssm:
        di = D if hybrid else cfg.ssm_d_inner
        nh = di // cfg.ssm_head_dim
        G, N, W = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv_width
        convd = di + 2 * G * N
        if not cfg.uses_attention:
            t["ln1"] = ((D,), "zeros")
        t["ssm_in"] = ((D, 2 * di + 2 * G * N + nh), "dense")
        t["conv_w"] = ((W, convd), "conv")
        t["conv_b"] = ((convd,), "zeros")
        t["A_log"] = ((nh,), "a_log")
        t["D_skip"] = ((nh,), "ones")
        t["dt_bias"] = ((nh,), "dt_bias")
        t["ssm_gnorm"] = ((di,), "zeros")
        if not hybrid:
            t["ssm_out"] = ((di, D), "dense")
    if hybrid:
        t["fuse_na"] = ((D,), "zeros")
        t["fuse_ns"] = ((D,), "zeros")
    if cfg.is_moe:
        E, Fe = cfg.num_experts, cfg.moe_d_ff
        t["ln2"] = ((D,), "zeros")
        t["router"] = ((D, E), "dense")
        t["we_g"] = ((E, D, Fe), "dense3")
        t["we_u"] = ((E, D, Fe), "dense3")
        t["we_d"] = ((E, Fe, D), "dense3")
        if cfg.num_shared_experts:
            t["ws_g"] = ((D, F), "dense")
            t["ws_u"] = ((D, F), "dense")
            t["ws_d"] = ((F, D), "dense")
    elif F:
        t["ln2"] = ((D,), "zeros")
        t["wg"] = ((D, F), "dense")
        t["wu"] = ((D, F), "dense")
        t["wd"] = ((F, D), "dense")
        if cfg.post_norm:
            t["post_ln2"] = ((D,), "zeros")
    return t


def _init_one(g: torch.Generator, shape, kind, dtype, device):
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)

    def uniform(lo, hi):
        u = torch.rand(shape, generator=g, device=device)
        return lo + (hi - lo) * u

    if kind == "a_log":
        return torch.log(uniform(1.0, 16.0))
    if kind == "dt_bias":
        dt = uniform(1e-3, 0.1)
        return dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    # dense / dense3 / conv: normal * fan_in ** -0.5 over the per-layer
    # shape (dense3 and conv fan in over dims 1 and 0 of it).
    fan_in = {"conv": shape[1], "dense3": shape[2]}.get(kind, shape[-2])
    w = torch.randn(shape, generator=g, device=device) * fan_in ** -0.5
    return w.to(dtype)


def init_params(cfg: ModelConfig, seed: int, dtype=torch.bfloat16,
                device="cuda") -> PyTree:
    """Random parameters from ``seed`` on ``device``.  The port's own
    initializer: same shapes and scales as the reference's, not the same
    numbers (tests carry the reference's weights over with
    :func:`params_from_numpy`).  Asking for CUDA without a card raises
    (:func:`~repro_torch.serving.server.resolve_device`)."""
    from repro_torch.serving.server import resolve_device

    device = resolve_device(device)
    # On "meta" only shapes exist (zoo and budget math at full width).
    g = torch.Generator(device="cpu" if device.type == "meta" else device)
    g.manual_seed(seed)
    D, Vp, Kcb = cfg.d_model, cfg.padded_vocab, cfg.num_codebooks
    params: Dict[str, Any] = {}
    params["embed"] = (torch.randn((Kcb, Vp, D), generator=g, device=device)
                       * D ** -0.5).to(dtype)
    if cfg.num_meta_tokens:
        params["meta"] = (torch.randn((cfg.num_meta_tokens, D), generator=g,
                                      device=device) * 0.02).to(dtype)
    Lc = cfg.num_layers
    params["layers"] = {
        name: _init_one(g, (Lc,) + shape, kind, dtype, device)
        for name, (shape, kind) in sorted(_layer_param_template(cfg).items())}
    params["final_norm"] = torch.zeros((D,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((Kcb, D, Vp), generator=g,
                                      device=device) * D ** -0.5).to(dtype)
    return params


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> PyTree:
    """The parameter tree's shapes and types, on the ``meta`` device:
    nothing is allocated (the reference's ``jax.eval_shape`` of
    ``init_params``)."""
    return init_params(cfg, 0, dtype, device="meta")


def params_from_numpy(tree: PyTree, device="cpu") -> PyTree:
    """A reference parameter tree (``repro.models.transformer.init_params``
    output, or a quantized variant, as numpy arrays) as the port's params
    on ``device``.  bfloat16 arrays cross as their raw 16 bits."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16, quantized: bool = False
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) of the decode cache, for every family: the
    shapes ``repro.models.transformer.init_cache`` builds."""
    Lc = cfg.num_layers
    out = {"lengths": ((batch,), torch.int32)}
    if cfg.uses_attention:
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        T = max_len + cfg.cache_extra_tokens
        kv = (Lc, batch, T, KV, hd)
        if quantized and cfg.family != "hybrid":
            out.update(k=(kv, torch.int8), v=(kv, torch.int8),
                       k_scale=(kv[:-1], torch.float32),
                       v_scale=(kv[:-1], torch.float32))
        else:
            out.update(k=(kv, dtype), v=(kv, dtype))
    if cfg.uses_ssm:
        di = cfg.d_model if cfg.family == "hybrid" else cfg.ssm_d_inner
        nh = di // cfg.ssm_head_dim
        convd = di + 2 * cfg.ssm_ngroups * cfg.ssm_state
        out["state"] = ((Lc, batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                        torch.float32)
        out["conv"] = ((Lc, batch, cfg.ssm_conv_width - 1, convd), dtype)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, quantized: bool = False,
               device="cpu") -> PyTree:
    """A zeroed decode cache; leaves stacked (L, ...)."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_shapes(
                cfg, batch, max_len, dtype, quantized).items()}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, quantized: bool = False) -> PyTree:
    """The decode cache's shapes and types, on the ``meta`` device."""
    return init_cache(cfg, batch, max_len, dtype, quantized, device="meta")


def _layer_windows(cfg: ModelConfig) -> Tuple[int, ...]:
    return tuple(cfg.window_for_kind(k) for k in cfg.layer_kinds())


def _layer(layers: dict, i: int) -> dict:
    """Slice ``i`` of every stacked leaf (quantized leaves included)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# One block (every family)
# ---------------------------------------------------------------------------
def _ffn(cfg: ModelConfig, h, lp, moe_impl: str):
    """The block's FFN and its residual: the MoE FFN, or the dense MLP
    where the config has one."""
    if cfg.is_moe:
        x2 = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
        return h + _tp_out(L.moe_ffn(cfg, lp, x2, impl=moe_impl))
    if cfg.d_ff:
        x2 = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
        ff = _tp_out(L.mlp_hidden(cfg, x2, lp["wg"], lp["wu"]),
                     lp["wd"])
        if cfg.post_norm:
            ff = L.rms_norm(ff, lp["post_ln2"], cfg.norm_eps)
        h = h + ff
    return h


def _fuse(cfg: ModelConfig, lp, attn_raw, ssm_raw):
    """The hybrid block's mix: each branch normed, averaged, projected."""
    fused = 0.5 * (L.rms_norm(attn_raw, lp["fuse_na"], cfg.norm_eps)
                   + L.rms_norm(ssm_raw, lp["fuse_ns"], cfg.norm_eps))
    return _tp_out(fused, lp["wo"])


def _block_prefill(cfg: ModelConfig, h, lp, window: int, positions, *,
                   moe_impl: str = "dense", collect_cache: bool = True):
    """Returns (h, the layer's cache leaves: k/v and/or the SSM state and
    conv tail; none without ``collect_cache``)."""
    x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    cache = {}
    if cfg.uses_ssm:
        hybrid = cfg.family == "hybrid"
        out = L.ssm_prefill(cfg, lp, x, hybrid=hybrid,
                            return_state=collect_cache)
        y, *leaves = out if collect_cache else (out,)
        cache.update(zip(("state", "conv"), leaves))
        if not hybrid:  # pure SSM (mamba2)
            return (_ffn(cfg, h + _tp_out(y, lp["ssm_out"]), lp,
                         moe_impl), cache)
    attn_raw, k, v = L.attention_prefill(
        cfg, lp, x, positions, window, prefix=cfg.num_meta_tokens)
    if collect_cache:
        cache.update(k=k, v=v)
    if cfg.family == "hybrid":
        return _ffn(cfg, h + _fuse(cfg, lp, attn_raw, y), lp,
                    moe_impl), cache
    attn = _tp_out(attn_raw, lp["wo"])
    if cfg.post_norm:
        attn = L.rms_norm(attn, lp["post_ln1"], cfg.norm_eps)
    return _ffn(cfg, h + attn, lp, moe_impl), cache


def _block_decode(cfg: ModelConfig, h, lp, window: int, cache, i: int,
                  lengths, uniform_pos: bool = False,
                  moe_impl: str = "dense"):
    """One decode step of layer ``i``; writes the new k/v (with their
    scales, in an int8 cache) and/or the new SSM state and conv buffer
    into the layer's cache slices in place (in the cache's types, as the
    reference's serving loop casts its carry).  With ``uniform_pos`` or an
    int8 cache the fresh token is written at ``lengths[0]`` after its
    attention, the reference's deferred write."""
    x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if cfg.uses_ssm:
        hybrid = cfg.family == "hybrid"
        y, state, conv = L.ssm_decode(cfg, lp, x, cache["state"][i],
                                      cache["conv"][i], hybrid=hybrid)
        cache["state"][i].copy_(state)
        cache["conv"][i].copy_(conv)
        if not hybrid:
            return _ffn(cfg, h + L.mm(y, lp["ssm_out"]), lp, moe_impl)
        attn_raw = L.attention_decode(
            cfg, lp, x, cache["k"][i], cache["v"][i], lengths, window,
            prefix=cfg.num_meta_tokens, uniform_pos=uniform_pos)
        return _ffn(cfg, h + _fuse(cfg, lp, attn_raw, y), lp, moe_impl)
    if "k_scale" in cache:  # int8 KV cache
        names = ("k", "k_scale", "v", "v_scale")
        attn_raw, *fresh = L.attention_decode_q(
            cfg, lp, x, *(cache[n][i] for n in names), lengths, window,
            prefix=cfg.num_meta_tokens)
        for n, t in zip(names, fresh):
            L.write_token(cache[n][i], t, lengths)
    else:
        attn_raw = L.attention_decode(
            cfg, lp, x, cache["k"][i], cache["v"][i], lengths, window,
            prefix=cfg.num_meta_tokens, uniform_pos=uniform_pos)
    attn = L.mm(attn_raw, lp["wo"])
    if cfg.post_norm:
        attn = L.rms_norm(attn, lp["post_ln1"], cfg.norm_eps)
    return _ffn(cfg, h + attn, lp, moe_impl)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens: (B, S) int, or (B, S, Kcb) for multi-codebook audio."""
    emb = params["embed"]  # (Kcb, Vp, D)
    if cfg.num_codebooks == 1:
        h = emb[0][tokens.long()]
    else:
        h = sum(emb[i][tokens[..., i].long()]
                for i in range(cfg.num_codebooks))
    if cfg.emb_scale:
        # The scale rounded to h's type, as the reference rounds it; a CPU
        # scalar, so no copy to the card (a CUDA graph can capture this).
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def lm_logits(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    """h: (B, S, D) -> logits (B, S, Kcb, Vp) float32."""
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params["embed"].transpose(1, 2)  # (Kcb, D, Vp)
    else:
        w = L.dense_w(params["head"])
    logits = torch.einsum("bsd,kdv->bskv", h, w).float()
    if cfg.final_logit_softcap:
        logits = L.softcap(logits, cfg.final_logit_softcap)
    return logits


def _frontend(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Hidden states after the stub frontends and meta tokens."""
    h = embed_tokens(cfg, params, batch["tokens"])
    B = h.shape[0]
    if cfg.frontend == "vision_stub":
        vis = batch["patch_embeds"].to(h.dtype)  # (B, Nv, D) — STUB input
        h = torch.cat([vis, h], dim=1)
    if cfg.num_meta_tokens:
        meta = params["meta"][None].expand(B, -1, -1).to(h.dtype)
        h = torch.cat([meta, h], dim=1)
    return h


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------
def _hidden(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            moe_impl: str, remat: bool) -> torch.Tensor:
    """Hidden states after the last block, before the final norm: every
    block over the whole sequence, no cache built.  ``remat=True`` keeps
    each block's input (and, with :data:`REMAT_SAVE_TP`, its tagged
    products) for the backward and recomputes the rest of the block there
    (the reference's ``jax.checkpoint`` over its layer scan)."""
    h = _frontend(cfg, params, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    for i, window in enumerate(_layer_windows(cfg)):
        def block(h, lp, window=window):
            return _block_prefill(cfg, h, lp, window, positions,
                                  moe_impl=moe_impl, collect_cache=False)[0]

        lp = _layer(params["layers"], i)
        h = _remat(block, h, lp) if remat else block(h, lp)
    return h


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            moe_impl: str = "dense", remat: bool = False) -> torch.Tensor:
    """Full-sequence logits: (B, S_total, Kcb, Vp) float32."""
    return lm_logits(cfg, params, _hidden(cfg, params, batch, moe_impl,
                                          remat))


def forward_hidden(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   *, moe_impl: str = "dense",
                   remat: bool = False) -> torch.Tensor:
    """Final-normed hidden states (B, S_total, D): no logits projection."""
    return L.rms_norm(_hidden(cfg, params, batch, moe_impl, remat),
                      params["final_norm"], cfg.norm_eps)


CE_CHUNK = 512  # sequence-chunked cross entropy (keeps logits off HBM)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            moe_impl: str = "dense", remat: bool = True,
            z_loss: float = 1e-4):
    """Causal LM loss, padded-vocab masked, computed in chunks of
    ``CE_CHUNK`` positions (and the remainder) so that the full
    (B, S, Vp) logits never exist: each chunk's body is checkpointed and
    recomputes its logits in the backward.  The softcap of the final
    logits, z-loss ``z * sum(lse^2) / denom``.  Returns (loss, metrics
    ``loss``, ``nll``, ``accuracy``), as the reference's."""
    hidden = forward_hidden(cfg, params, batch, moe_impl=moe_impl,
                            remat=remat)
    B, S_total, D = hidden.shape
    labels = batch["labels"]  # (B, S) or (B, S, Kcb)
    if labels.ndim == 2:
        labels = labels[..., None]
    S = labels.shape[1]
    hidden = hidden[:, S_total - S:, :]  # frontend/meta positions: unlabeled
    if cfg.tie_embeddings:
        w = params["embed"].transpose(1, 2)  # (Kcb, D, Vp)
    else:
        w = L.dense_w(params["head"])
    Vp = w.shape[-1]
    col_ok = torch.arange(Vp, device=hidden.device) < cfg.vocab_size

    def chunk_stats(h_chunk, lab_chunk):
        # h_chunk: (B, ck, D); lab_chunk: (B, ck, Kcb)
        logits = torch.einsum("bsd,kdv->bskv", h_chunk,
                              w.to(h_chunk.dtype)).float()
        if cfg.final_logit_softcap:
            logits = L.softcap(logits, cfg.final_logit_softcap)
        logits = torch.where(col_ok, logits, -1e9)
        lse = torch.logsumexp(logits, dim=-1)  # (B, ck, Kcb)
        lab = torch.gather(logits, -1, lab_chunk[..., None].long())[..., 0]
        correct = logits.argmax(dim=-1) == lab_chunk
        return torch.stack([(lse - lab).sum(), (lse * lse).sum(),
                            correct.float().sum()])

    ck = min(CE_CHUNK, S)
    sums = torch.zeros(3, device=hidden.device)
    for c0 in range(0, S - S % ck, ck):
        sums = sums + checkpoint(chunk_stats, hidden[:, c0:c0 + ck],
                                 labels[:, c0:c0 + ck], use_reentrant=False,
                                 preserve_rng_state=False)
    if S % ck:
        sums = sums + chunk_stats(hidden[:, S - S % ck:],
                                  labels[:, S - S % ck:])
    nll_sum, zsq_sum, acc_sum = sums.unbind()
    denom = float(B * S * labels.shape[-1])
    nll = nll_sum / denom
    loss = nll
    if z_loss:
        loss = loss + z_loss * zsq_sum / denom
    metrics = {"loss": loss, "nll": nll, "accuracy": acc_sum / denom}
    return loss, metrics


# ---------------------------------------------------------------------------
# Prefill: run the full prompt, build the decode cache
# ---------------------------------------------------------------------------
def prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            max_len: int, *, moe_impl: str = "dense",
            cache_dtype=torch.bfloat16, quantize_cache: bool = False):
    """Returns (last-token logits (B, Kcb, Vp), populated cache).
    ``quantize_cache=True`` stores k/v as int8 with per-(token, kv-head)
    f32 scales (:func:`~repro_torch.models.layers.quantize_kv`); a hybrid
    model's cache has no int8 layout (the reference's ``init_cache``
    builds none), so it refuses it."""
    if quantize_cache and cfg.family == "hybrid":
        raise ValueError(f"{cfg.name}: a hybrid model's cache stays in "
                         "cache_dtype; it has no int8 layout")
    h = _frontend(cfg, params, batch)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, device=h.device)
    cache = init_cache(cfg, B, max_len, cache_dtype, quantized=quantize_cache,
                       device=h.device)
    for i, window in enumerate(_layer_windows(cfg)):
        h, leaves = _block_prefill(cfg, h, _layer(params["layers"], i),
                                   window, positions, moe_impl=moe_impl)
        if quantize_cache and "k" in leaves:
            for name in ("k", "v"):
                leaves[name], leaves[name + "_scale"] = L.quantize_kv(
                    leaves[name])
        # k/v (and scales) and the conv tail in the cache's types, the SSM
        # state in f32.
        for name, t in leaves.items():
            dst = cache[name][i]
            (dst if name in ("state", "conv") else dst[:, :S]).copy_(t)
    cache["lengths"].fill_(S)
    logits = lm_logits(cfg, params, h[:, -1:, :])[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# Decode: one token for every sequence in the batch
# ---------------------------------------------------------------------------
def decode_step(cfg: ModelConfig, params, cache: PyTree,
                tokens: torch.Tensor, *, moe_impl: str = "dense",
                uniform_pos: bool = False):
    """tokens: (B,) or (B, Kcb).  Returns (logits (B, Kcb, Vp), cache).

    The returned cache holds the same k/v (or state/conv) tensors, updated
    in place, and a new ``lengths``.  ``uniform_pos=True`` (every row at
    the same position, as in the reference's lowered serve step) reads
    the cache through the deferred path and writes the fresh token at
    ``lengths[0]``; an int8 cache always does."""
    tok = tokens[:, None] if cfg.num_codebooks == 1 else tokens[:, None, :]
    h = embed_tokens(cfg, params, tok)  # (B, 1, D)
    lengths = cache["lengths"]
    for i, window in enumerate(_layer_windows(cfg)):
        h = _block_decode(cfg, h, _layer(params["layers"], i), window,
                          cache, i, lengths, uniform_pos, moe_impl)
    new_cache = dict(cache, lengths=lengths + 1)
    logits = lm_logits(cfg, params, h)[:, 0]
    return logits, new_cache


def greedy_token(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """logits (B, Kcb, Vp) -> next token ids (B,) or (B, Kcb), int32."""
    col = torch.arange(logits.shape[-1], device=logits.device)
    masked = torch.where(col < cfg.vocab_size, logits,
                         torch.full_like(logits, float("-inf")))
    ids = masked.argmax(dim=-1).to(torch.int32)
    return ids[:, 0] if cfg.num_codebooks == 1 else ids
