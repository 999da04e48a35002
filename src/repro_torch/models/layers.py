"""Building-block layers of every family.

Port of :mod:`repro.models.layers`: pure functions over explicit parameter
dicts.  Per-layer parameters arrive as one slice of the stacked ``(L, ...)``
leaves.  Attention runs through the port's kernels: prefill through
``ops.flash_attention``, decode against a dense bf16 or f32 cache through
``ops.decode_attention``; the Mamba-2 branch's prefill scan through
``ops.ssd_scan``.  The reference's two other decode paths, the deferred
write (``uniform_pos``) and the int8 KV cache (``quantize_kv``,
``attention_decode_q``), are written inline in ``jnp`` there, outside any
Pallas kernel, and are plain PyTorch here on every device; so are the
MoE FFN's expert products (einsums over the dequantized expert stacks in
the reference too), its router going through ``mm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.config import ModelConfig
from repro_torch.quant.quantize import dequantize_leaf, is_quantized


# ---------------------------------------------------------------------------
# Weight application — quantized zoo variants go through the fused dequant
# matmul kernel (the paper's low-precision serving path).
# ---------------------------------------------------------------------------
def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for dense or quantized ({"q","s"}) 2-D weights."""
    if is_quantized(w):
        return ops.quant_matmul(x, w["q"], w["s"], out_dtype=x.dtype)
    return x @ w


def dense_w(w) -> torch.Tensor:
    """Materialize a (possibly quantized) weight densely — used where the
    fused kernel doesn't apply (the LM head)."""
    return dequantize_leaf(w)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    # Variance in f32, the result in x's dtype, scaled by (1 + w).
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    scale = torch.rsqrt(var + eps)[..., None]
    wf = 1.0 + w.float()
    return (x * scale.to(x.dtype)) * wf.to(x.dtype)


def act_fn(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) on every input, as ``jax.nn.softplus`` computes it
    (``F.softplus`` turns into the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with positions (S,) or (B, S)."""
    D = x.shape[-1]
    half = D // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.float()[:, :, None] * freq[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention branch (full-sequence prefill and single-token decode)
# ---------------------------------------------------------------------------
def _qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor, positions):
    """Projected, normed and rotated q, k, v: (B, S, H|KV, hd)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = mm(x, lp["wq"]).reshape(B, S, H, hd)
    k = mm(x, lp["wk"]).reshape(B, S, KV, hd)
    v = mm(x, lp["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attention_prefill(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                      positions: torch.Tensor, window: int,
                      prefix: int = 0):
    """x: (B, S, D) input-normed.  Returns (attn_out (B, S, H*hd), k, v)
    so the caller can build caches."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, lp, x, positions)
    out = ops.flash_attention(
        q, k, v, causal=True, window=window,
        softcap=cfg.attn_logit_softcap, scale=cfg.attn_scale, prefix=prefix)
    return out.reshape(B, S, -1), k, v


def attention_decode(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, window: int, prefix: int = 0,
                     uniform_pos: bool = False):
    """One token per sequence.  x: (B, 1, D) input-normed; k/v cache:
    (B, T, KV, hd); lengths: (B,) int32, the new token's index.

    Unlike the reference, which returns updated copies of the caches,
    the new token's k/v are written into ``k_cache``/``v_cache`` in place;
    returns attn_out (B, 1, H*hd).  By default each row's k/v are written
    at its own length and the dense cache is read through
    ``ops.decode_attention``.  ``uniform_pos=True`` is the reference's
    deferred write: the attention reads the cache as it was plus the fresh
    token (:func:`_decode_attention_deferred`), and the fresh k/v are then
    written at ``lengths[0]`` for every row."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, lp, x, lengths[:, None])
    if uniform_pos:
        out = _decode_attention_deferred(
            q[:, 0], k[:, 0], v[:, 0], k_cache, v_cache, lengths,
            window=window, softcap_v=cfg.attn_logit_softcap,
            scale=cfg.attn_scale, prefix=prefix)
        write_token(k_cache, k[:, 0], lengths)
        write_token(v_cache, v[:, 0], lengths)
        return out.reshape(B, 1, -1)
    bidx = torch.arange(B, device=x.device)
    pos = lengths.long()
    k_cache[bidx, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos] = v[:, 0].to(v_cache.dtype)
    out = ops.decode_attention(
        q[:, 0].contiguous(), k_cache, v_cache, lengths + 1, window=window,
        softcap=cfg.attn_logit_softcap, scale=cfg.attn_scale, prefix=prefix)
    return out.reshape(B, 1, -1)


def write_token(cache: torch.Tensor, fresh: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """Write one token's ``fresh`` (B, ...) into ``cache`` (B, T, ...) at
    position ``lengths[0]`` of every row, in the cache's type, in place:
    the reference's deferred ``dynamic_update_slice`` (which clamps the
    start so the slice fits), without a host sync."""
    pos = lengths[:1].long().clamp(0, cache.shape[1] - 1)
    cache.index_copy_(1, pos, fresh[:, None].to(cache.dtype))


def quantize_kv(x: torch.Tensor):
    """Per-(token, kv-head) symmetric int8 quantization of k/v rows.
    x: (..., KV, hd) -> (int8 values, f32 scales (..., KV)).  Bit-exact
    with the reference: f32 division, round half to even."""
    xf = x.float()
    scales = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scales[..., None]), -128, 127)
    return q.to(torch.int8), scales


def _masked_scores(s, s_self, lengths, *, window, softcap_v, prefix):
    """Soft-capped scores over the cache, masked to the keys before
    ``lengths`` inside the window (which counts the fresh token), and the
    fresh token's own score."""
    if softcap_v:
        s = softcap(s, softcap_v)
        s_self = softcap(s_self, softcap_v)
    T = s.shape[-1]
    kv_pos = torch.arange(T, device=s.device)[None, :]
    lens = lengths.long()[:, None]
    valid = kv_pos < lens
    if window:
        valid &= (kv_pos >= lens + 1 - window) | (kv_pos < prefix)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    return s, s_self


def _lse_weights(s, s_self):
    """Unnormalised softmax weights of the cache's keys and of the fresh
    token, combined through a log-sum-exp (not concatenated), and their
    sum."""
    m = torch.maximum(s.amax(dim=-1, keepdim=True), s_self)
    e = torch.exp(s - m)
    e_self = torch.exp(s_self - m)
    return e, e_self, e.sum(dim=-1, keepdim=True) + e_self


def _scaled_query(q: torch.Tensor, scale: float):
    """q·scale computed in f32 and rounded back to q's type."""
    return (q.float() * (scale or q.shape[-1] ** -0.5)).to(q.dtype)


def _decode_attention_deferred(q, k_new, v_new, k_cache, v_cache, lengths,
                               *, window, softcap_v, scale, prefix):
    """Decode attention where the fresh token's k/v ride alongside the
    (not yet updated) cache: scores over [cache, self].  The weights are
    cast to the cache's type before the value product, as the reference
    casts them."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    qf = _scaled_query(q, scale).reshape(B, KV, H // KV, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.float())
    s_self = torch.einsum("bkgd,bkd->bkg", qf, k_new.float())[..., None]
    s, s_self = _masked_scores(s, s_self, lengths, window=window,
                               softcap_v=softcap_v, prefix=prefix)
    e, e_self, denom = _lse_weights(s, s_self)
    o = torch.einsum("bkgt,btkd->bkgd", e.to(v_cache.dtype).float(),
                     v_cache.float())
    o = (o + e_self * v_new.float()[:, :, None, :]) / denom
    return o.reshape(B, H, D).to(q.dtype)


def _decode_attention_deferred_q(q, k_new, v_new, kq, ks, vq, vs, lengths,
                                 *, window, softcap_v, scale, prefix):
    """int8-KV-cache decode attention: as in the reference, the k scales
    fold into the scores and the v scales into the weights, one multiply
    per (token, head), and the int8 values and the v-scaled weights are
    cast to the query's type before their products (here the products
    then run in f32 on widened copies of the layer's int8 cache).
    kq/vq: (B, T, KV, hd) int8; ks/vs: (B, T, KV) f32."""
    B, H, D = q.shape
    KV = kq.shape[2]
    qf = _scaled_query(q, scale).reshape(B, KV, H // KV, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qf, kq.to(q.dtype).float())
    s = s * ks.transpose(1, 2)[:, :, None, :]  # fold in k scales
    s_self = torch.einsum("bkgd,bkd->bkg", qf, k_new.float())[..., None]
    s, s_self = _masked_scores(s, s_self, lengths, window=window,
                               softcap_v=softcap_v, prefix=prefix)
    e, e_self, denom = _lse_weights(s, s_self)
    ec = (e * vs.transpose(1, 2)[:, :, None, :]).to(q.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", ec.float(), vq.to(q.dtype).float())
    o = (o + e_self * v_new.float()[:, :, None, :]) / denom
    return o.reshape(B, H, D).to(q.dtype)


def attention_decode_q(cfg: ModelConfig, lp: dict, x: torch.Tensor, kq, ks,
                       vq, vs, lengths: torch.Tensor, window: int,
                       prefix: int = 0):
    """Quantized-cache decode step (deferred write): attends over the int8
    cache plus the fresh token and returns (attn_out (B, 1, H*hd), the
    fresh token's int8 k, its k scales, int8 v, v scales), which the
    caller writes at ``lengths[0]``."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, lp, x, lengths[:, None])
    out = _decode_attention_deferred_q(
        q[:, 0], k[:, 0], v[:, 0], kq, ks, vq, vs, lengths, window=window,
        softcap_v=cfg.attn_logit_softcap, scale=cfg.attn_scale,
        prefix=prefix)
    knq, kns = quantize_kv(k[:, 0])
    vnq, vns = quantize_kv(v[:, 0])
    return out.reshape(B, 1, -1), knq, kns, vnq, vns


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------
def mlp_hidden(cfg: ModelConfig, x: torch.Tensor, wg, wu) -> torch.Tensor:
    """The gated MLP's hidden activations, before its down projection."""
    return act_fn(mm(x, wg), cfg.act) * mm(x, wu)


def mlp(cfg: ModelConfig, x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    return mm(mlp_hidden(cfg, x, wg, wu), wd)


# ---------------------------------------------------------------------------
# Mixture-of-Experts FFN
# ---------------------------------------------------------------------------
def moe_ffn(cfg: ModelConfig, lp: dict, x: torch.Tensor,
            impl: str = "dense") -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): top-K routing over ``cfg.num_experts``
    experts, plus the shared expert where the config has one.

    ``impl="dense"`` (the reference's serving default) runs every expert on
    every token and zeroes the unrouted ones through one-hot gates: fixed
    shapes, no host sync, so a CUDA graph captures it.  ``"ragged"`` sorts
    the routed slots by expert and runs each expert on its contiguous
    group; the group sizes are read on the host, so it raises under a
    CUDA graph capture.  ``"local"`` is the reference's expert-local
    ``shard_map`` on one device: each expert takes at most ``cap`` of its
    slots, the last ones in slot order, and the shared expert joins its
    f32 sum."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    xt = x.reshape(B * S, D)
    probs = torch.softmax(mm(xt, lp["router"]).float(), dim=-1)
    topv, topi = torch.topk(probs, K, dim=-1)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    if impl == "local":
        return _moe_local(cfg, lp, xt, topi, topv).reshape(B, S, D)
    if impl == "ragged":
        y = _moe_ragged(cfg, lp, xt, topi, topv)
    elif impl == "dense":
        gates = torch.zeros((xt.shape[0], E), dtype=torch.float32,
                            device=x.device).scatter_(1, topi, topv)
        y = _moe_dense(cfg, lp, xt, gates)
    else:
        raise ValueError(f"moe_impl must be 'dense', 'ragged' or 'local', "
                         f"got {impl!r}")
    if cfg.num_shared_experts:
        y = y + mlp(cfg, xt, lp["ws_g"], lp["ws_u"], lp["ws_d"])
    return y.reshape(B, S, D)


def _moe_dense(cfg, lp, xt, gates):
    hg = torch.einsum("td,edf->tef", xt, dense_w(lp["we_g"]))
    hu = torch.einsum("td,edf->tef", xt, dense_w(lp["we_u"]))
    hh = act_fn(hg, cfg.act) * hu
    hh = hh * gates.to(hh.dtype)[:, :, None]
    return torch.einsum("tef,efd->td", hh, dense_w(lp["we_d"]))


def _expert(cfg, xe, wg, wu, wd):
    return (act_fn(xe @ wg, cfg.act) * (xe @ wu)) @ wd


def _moe_ragged(cfg, lp, xt, topi, topv):
    """Routed slots sorted by expert (stably, as ``jnp.argsort``), one
    product per expert over its contiguous group, the gated rows summed
    back onto their tokens."""
    if xt.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "moe_impl='ragged' reads its group sizes on the host and cannot "
            "run inside a CUDA graph capture; serve with 'dense'")
    T = xt.shape[0]
    K = cfg.num_experts_per_tok
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    tok_of = order // K
    xs = xt[tok_of]
    sizes = torch.bincount(flat_e, minlength=cfg.num_experts).tolist()
    wg, wu, wd = (dense_w(lp[n]) for n in ("we_g", "we_u", "we_d"))
    ys = torch.cat([_expert(cfg, seg, wg[e], wu[e], wd[e])
                    for e, seg in enumerate(torch.split(xs, sizes))
                    if seg.shape[0]])
    ys = ys * topv.reshape(-1)[order][:, None].to(ys.dtype)
    return torch.zeros((T, xt.shape[1]), dtype=ys.dtype,
                       device=xt.device).index_add_(0, tok_of, ys)


def _moe_local(cfg, lp, xt, topi, topv):
    """The reference's ``_moe_local`` on one device (one data shard, every
    expert local): per expert, the ``cap`` highest matching slot ids
    (``topk`` over the slot ids, -1 where the slot went elsewhere), its
    product over their tokens, gated and added in f32; the shared expert
    on every token; the sum cast back to the activations' type."""
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    cap = min(max(32, int(2.0 * T * K / E)), T * K)
    slots_e, slots_v = topi.reshape(-1), topv.reshape(-1)
    slot = torch.arange(T * K, device=xt.device)
    slot_tok = slot // K
    wg, wu, wd = (dense_w(lp[n]) for n in ("we_g", "we_u", "we_d"))
    out = torch.zeros((T, D), dtype=torch.float32, device=xt.device)
    for j in range(E):
        sel = torch.topk(torch.where(slots_e == j, slot, -1), cap).values
        valid = sel >= 0
        idx = sel.clamp_min(0)
        tok = torch.where(valid, slot_tok[idx], 0)
        gate = torch.where(valid, slots_v[idx], 0.0)
        ye = _expert(cfg, xt[tok], wg[j], wu[j], wd[j]).float()
        out.index_add_(0, tok, torch.where(valid[:, None],
                                           ye * gate[:, None], 0.0))
    if cfg.num_shared_experts:
        out = out + _expert(cfg, xt, *(dense_w(lp[n]) for n in
                                       ("ws_g", "ws_u", "ws_d"))).float()
    return out.to(xt.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) branch
# ---------------------------------------------------------------------------
def _ssm_dims(cfg: ModelConfig, hybrid: bool):
    di = cfg.d_model if hybrid else cfg.ssm_d_inner
    nh = di // cfg.ssm_head_dim
    return di, nh


def _gated_norm(cfg: ModelConfig, lp: dict, y: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    return rms_norm(y * F.silu(z.float()).to(y.dtype), lp["ssm_gnorm"],
                    cfg.norm_eps)


def ssm_prefill(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
                hybrid: bool = False, init_state=None, init_conv=None,
                return_state: bool = False):
    """x: (B, S, D) input-normed.  Returns y (B, S, di) before the out
    projection [+ (ssm_state, conv_tail)]."""
    B, S, _ = x.shape
    di, nh = _ssm_dims(cfg, hybrid)
    G, N, W = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv_width
    zxbcdt = mm(x, lp["ssm_in"])
    z = zxbcdt[..., :di]
    xbc_pre = zxbcdt[..., di: 2 * di + 2 * G * N]
    dt_raw = zxbcdt[..., 2 * di + 2 * G * N:]
    xbc = ops.causal_conv1d(xbc_pre, lp["conv_w"], lp["conv_b"],
                            init=init_conv)
    # Column slices of xbc: the scan reads them in place (row-strided).
    xs = xbc[..., :di]
    Bm = xbc[..., di: di + G * N].reshape(B, S, G, N)
    Cm = xbc[..., di + G * N:].reshape(B, S, G, N)
    dt = softplus(dt_raw.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    xh = xs.reshape(B, S, nh, cfg.ssm_head_dim)
    out = ops.ssd_scan(xh, dt.to(xh.dtype), A, Bm, Cm, lp["D_skip"],
                       init_state=init_state, return_state=return_state,
                       chunk=cfg.ssm_chunk)
    y, state = out if return_state else (out, None)
    y = _gated_norm(cfg, lp, y.reshape(B, S, di), z)
    if return_state:
        return y, state, _conv_tail(xbc_pre, init_conv, W)
    return y


def _conv_tail(xbc_pre_conv: torch.Tensor, init, W: int) -> torch.Tensor:
    """Last W-1 pre-activation conv inputs — the decode rolling buffer
    (zeros in front of a prompt shorter than W-1)."""
    B, S, C = xbc_pre_conv.shape
    if init is None:
        init = torch.zeros((B, W - 1, C), dtype=xbc_pre_conv.dtype,
                           device=xbc_pre_conv.device)
    dtype = torch.promote_types(init.dtype, xbc_pre_conv.dtype)
    full = torch.cat([init.to(dtype), xbc_pre_conv.to(dtype)], dim=1)
    return full[:, -(W - 1):, :]


def ssm_decode(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               state: torch.Tensor, conv_buf: torch.Tensor, *,
               hybrid: bool = False):
    """Single-token SSD step.  x: (B, 1, D) input-normed; state (B, nh,
    hd, N); conv_buf (B, W-1, convd).  Returns (y (B, 1, di), new_state,
    new_conv); the caller stores them (the conv buffer comes back in the
    promoted type of the buffer and the token's activations)."""
    B = x.shape[0]
    di, nh = _ssm_dims(cfg, hybrid)
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    zxbcdt = mm(x[:, 0, :], lp["ssm_in"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * G * N]
    dt_raw = zxbcdt[..., 2 * di + 2 * G * N:]
    xbc_act, new_conv = ops.causal_conv1d_step(
        xbc, lp["conv_w"], lp["conv_b"], conv_buf)
    xs = xbc_act[..., :di]
    Bm = xbc_act[..., di: di + G * N].reshape(B, G, N)
    Cm = xbc_act[..., di + G * N:].reshape(B, G, N)
    dt = softplus(dt_raw.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    xh = xs.reshape(B, nh, cfg.ssm_head_dim)
    y, new_state = ops.ssd_step(xh, dt, A, Bm, Cm, lp["D_skip"], state)
    y = _gated_norm(cfg, lp, y.reshape(B, di), z)
    return y[:, None, :], new_state, new_conv
