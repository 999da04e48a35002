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

A tenant placed across ranks passes ``DTensor`` parameters through the
same functions: ``hint`` places activations where the reference's hints
do, the kernel wrappers run each rank's block (:mod:`repro_torch.kernels.
placed`), and a handful of helpers here keep the placed path to the
process group's own collectives (:func:`replicated`, :func:`embed_rows`,
:func:`kv_for_ranks`, :func:`write_rows`, ``mm``'s
:func:`repro_torch.kernels.placed.matmul`).  On plain tensors each is the
computation it always was.

A tensor-parallel training step passes each rank's plain blocks instead
(the model axis installed, :mod:`repro_torch.distributed.tensor_parallel`
as ``TP``): head counts come from the local weights, each rank-local use
of a whole tensor goes through ``TP.copy_in``, and a row-parallel product
leaves partial sums that the block reduces once
(:func:`repro_torch.models.transformer._tp_out`).  Without an installed
axis every ``TP`` helper is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.ctx import get_ctx, hint
from repro_torch.distributed.sharding import is_placed
from repro_torch.kernels import ops, placed
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
    if is_placed(w):
        return placed.matmul(x, w)
    return x @ w


def embed_rows(table: torch.Tensor, ids: torch.Tensor,
               rows: int = 0) -> torch.Tensor:
    """``table[ids]``.  A placed table split on its rows (the vocabulary)
    is read as Megatron's vocabulary-parallel embedding does: each rank
    looks up the ids in its own rows, zeros for the others, and the
    result is their partial sum (``DTensor`` reduces it where it is
    read), so the table is never gathered.  A plain table of fewer than
    ``rows`` rows is a rank's block of a table split over the installed
    model axis: :func:`~repro_torch.distributed.tensor_parallel.
    vocab_lookup`."""
    if not is_placed(table):
        if rows and TP.is_split(table.shape[0], rows):
            return TP.vocab_lookup(table, ids)
        return table[ids.long()]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    split = [p.is_shard(0) for p in table.placements]
    rows = table.shape[0]
    lo = 0
    for i, s in enumerate(split):
        if s:
            rows //= mesh.size(i)
            lo += mesh.get_coordinate()[i] * rows

    def local(t):
        j = ids.long() - lo
        ok = (j >= 0) & (j < t.shape[0])
        out = t[j.clamp(0, t.shape[0] - 1)]
        return torch.where(ok[..., None], out, torch.zeros_like(out))

    out = [Partial() if s else p for s, p in zip(split, table.placements)]
    return local_map(local, out_placements=out,
                     in_placements=(table.placements,),
                     device_mesh=mesh)(table)


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A placed activation made whole on every rank (kept a ``DTensor``,
    replicated but for a batch split): a split gathered, where its parts
    are read across the split, and a row-parallel product's partial sums
    added (an all-reduce, where the reference's partitioner puts one), so
    that the residual stream stays replicated.  A plain tensor comes back
    as it is."""
    return hint(t, "dp", *([None] * (t.ndim - 1)))


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
    """Projected, normed and rotated q, k, v: (B, S, H|KV, hd), the heads
    the weights hold (a rank's, under tensor parallelism).  Where the
    model axis has more ranks than KV heads, a rank's k and v columns cut
    a head: k and v are gathered whole, normed and rotated, and each rank
    takes the KV head its query heads read (:func:`_own_kv_head`).  Where
    the axis does not divide the query heads, a rank's q columns cut a
    head too: q is gathered whole and the rank takes its heads
    (``TP.head_range``), and k and v, gathered whole, are repeated to the
    KV head of each of them (:func:`_repeat_kv`), as the reference
    repeats k and v before its sharded attention."""
    hd = cfg.resolved_head_dim
    H, KV, m = cfg.num_heads, cfg.num_kv_heads, TP.size()
    x = TP.copy_in(x)
    q = mm(x, lp["wq"])
    uneven = TP.is_split(q.shape[-1], H * hd) and H % m != 0
    if uneven:
        a, b = TP.head_range(H)
        q = TP.copy_in(TP.gather_last(q))[..., a * hd:b * hd]
    q = _split_heads(q, hd)
    k, v = mm(x, lp["wk"]), mm(x, lp["wv"])
    whole_kv = (TP.is_split(k.shape[-1], KV * hd)
                and (KV % m != 0 or uneven))
    if whole_kv:
        k, v = TP.gather_last(k), TP.gather_last(v)
    k, v = _split_heads(k, hd), _split_heads(v, hd)
    if cfg.qk_norm:
        q = rms_norm(q, TP.copy_in(lp["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"] if whole_kv
                     else TP.copy_in(lp["k_norm"]), cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if whole_kv and (uneven or m % KV):
        return q, _repeat_kv(k, H), _repeat_kv(v, H)
    if whole_kv:
        return q, _own_kv_head(k), _own_kv_head(v)
    return q, kv_for_ranks(k), kv_for_ranks(v)


def _split_heads(t: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd), split on the heads over the model
    axis where it is placed.  A placed projection whose heads do not
    divide the axis is gathered first: ``DTensor`` splits no head."""
    B, S, w = t.shape
    n = w // hd
    if is_placed(t) and n % get_ctx().model_size:
        t = hint(t, "dp", None, None)
    return hint(t.reshape(B, S, n, hd), "dp", None, "model", None)


def _own_kv_head(k: torch.Tensor) -> torch.Tensor:
    """Of k or v (B, S, KV, hd), whole on every rank of a model axis of
    more ranks than KV heads, the one head this rank's query heads read
    (B, S, 1, hd), taken in (``TP.copy_in``) and contiguous, as the
    attention kernels take it."""
    j = TP.rank() * k.shape[2] // TP.size()
    return TP.copy_in(k)[:, :, j:j + 1].contiguous()


def _repeat_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    """Of k or v (B, S, KV, hd), whole on every rank, the KV head of each
    of this rank's query heads (``TP.head_range(heads)``), (B, S, b - a,
    hd): a rank's heads may read two KV heads (llama4-scout's rank 1 holds
    heads 3 to 5 of groups of 5).  Taken in (``TP.copy_in``) and
    contiguous, as the attention kernels take it."""
    a, b = TP.head_range(heads)
    idx = torch.arange(a, b, device=k.device) // (heads // k.shape[2])
    return TP.copy_in(k).index_select(2, idx)


def kv_for_ranks(k):
    """k or v (B, S, KV, hd) of a tenant placed across ranks, split on
    its KV heads over the model axis, each rank the KV heads its own query
    heads read.  Where the axis has more ranks than there are KV heads,
    each head is first repeated up to the axis' size, as the reference
    repeats k and v before its sharded attention; the decode cache then
    holds that many heads (:func:`repro_torch.models.transformer.
    placed_cache`).  A plain tensor comes back as it is."""
    if not is_placed(k):
        return k
    m, KV = get_ctx().model_size, k.shape[2]
    if m > KV:
        if m % KV:
            raise NotImplementedError(
                f"{KV} KV heads over a model axis of {m} ranks")
        B, S, _, hd = k.shape
        k = k.unsqueeze(3).expand(B, S, KV, m // KV, hd).reshape(
            B, S, m, hd)
    return hint(k, "dp", None, "model", None)


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
    return _own_rows(cfg, out.reshape(B, S, -1)), k, v


def _own_rows(cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """The attention output ``out`` (B, S, the rank's heads x hd) for the
    output projection's rows this rank holds.  Where the model axis does
    not divide the query heads, the rank's heads are not its rows of
    ``wo`` (those cut a head): the ranks' heads are gathered whole
    (``TP.gather_blocks``, taken in) and the rank takes its columns."""
    H, m, hd = cfg.num_heads, TP.size(), cfg.resolved_head_dim
    if H % m == 0:
        return out
    widths = [hd * (b - a) for a, b in (TP.head_range(H, r)
                                        for r in range(m))]
    n = H * hd // m
    whole = TP.copy_in(TP.gather_blocks(out, widths))
    return whole[..., TP.rank() * n:(TP.rank() + 1) * n]


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
    write_rows((k_cache, v_cache), (k[:, 0], v[:, 0]), lengths)
    out = ops.decode_attention(
        q[:, 0].contiguous(), k_cache, v_cache, lengths + 1, window=window,
        softcap=cfg.attn_logit_softcap, scale=cfg.attn_scale, prefix=prefix)
    return out.reshape(B, 1, -1)


def write_rows(caches, fresh, lengths: torch.Tensor) -> None:
    """Write each row's ``fresh`` (B, ...) into each of ``caches``
    (B, T, ...) at its own ``lengths`` position, in the cache's type, in
    place.  A placed cache (split on its heads, as ``fresh`` is by then)
    is written through each rank's block: ``DTensor`` takes no indexed
    write."""
    rows = (torch.arange(lengths.shape[0], device=lengths.device),
            lengths.long())
    for cache, f in zip(caches, fresh):
        if is_placed(cache):
            cache, f = cache.to_local(), f.to_local()
        cache[rows] = f.to(cache.dtype)


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
    """The gated MLP's hidden activations, before its down projection.
    Under tensor parallelism ``wg`` and ``wu`` are a rank's columns and
    ``x`` is taken in by the caller (``TP.copy_in``); :func:`mlp`'s down
    projection is then the rank's rows, a partial sum."""
    h = act_fn(mm(x, wg), cfg.act) * mm(x, wu)
    return hint(h, *(["dp"] + [None] * (h.ndim - 2) + ["model"]))


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
    CUDA graph capture (on ``meta`` they are an even split,
    :func:`_group_sizes`).  ``"local"`` is the reference's expert-local
    ``shard_map``: each expert takes at most ``cap`` of its slots, the
    last ones in slot order, and the shared expert joins its f32 sum.

    Under tensor parallelism (every ``impl``) the weights are a rank's:
    the router's expert columns, E / m experts, the shared expert's
    columns and rows.  The tokens are taken in once (``TP.copy_in``) for
    all of them; the router's logits are gathered whole, so every rank
    routes alike; the gates a rank reads are taken in (``dense``: its
    columns of the (T, E) gates; ``ragged`` and ``local``: the (T, K)
    top-K weights, so the router's gradient is summed over the ranks);
    the rank runs its own experts only (``ragged``: its contiguous run of
    the sorted slots; ``local``: expert ``rank * E / m + j`` on its local
    weights ``j``, the capacity from the rank's own rows); and the result
    is the rank's partial sum, which the block reduces once
    (:func:`repro_torch.models.transformer._tp_out`)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    xt = x.reshape(B * S, D)
    tp = TP.size() > 1
    if tp:
        xt = TP.copy_in(xt)
    logits = mm(xt, lp["router"])
    if tp:
        logits = TP.gather_last(logits)
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.topk(probs, K, dim=-1)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    if impl == "local":
        return _moe_local(cfg, lp, xt, topi, TP.copy_in(topv)).reshape(
            B, S, D)
    if impl == "ragged":
        y = _moe_ragged(cfg, lp, xt, topi, TP.copy_in(topv))
    elif impl == "dense":
        gates = torch.zeros((xt.shape[0], E), dtype=torch.float32,
                            device=x.device).scatter_(1, topi, topv)
        if tp:
            gates = TP.own_cols(gates)
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


def _first_expert(cfg, w) -> int:
    """The expert id of this rank's first expert: its E / m experts ``w``
    (the leading dim of an expert leaf) are ``[rank * E / m, (rank + 1) *
    E / m)`` under a model axis that splits them, 0 otherwise."""
    return TP.rank() * w.shape[0] if TP.is_split(w.shape[0],
                                                 cfg.num_experts) else 0


def _moe_ragged(cfg, lp, xt, topi, topv):
    """Routed slots sorted by expert (stably, as ``jnp.argsort``), one
    product per expert over its contiguous group, the gated rows summed
    back onto their tokens.  A rank of a model axis runs its experts on
    their run of the sorted slots only (its bounds from the group sizes)
    and returns its partial sum; a rank whose experts receive no slot
    returns zeros, its products at zero rows keeping every weight and the
    gates in the graph, so it issues the same collectives as the others.
    Every expert's product runs, an empty group at zero rows."""
    if xt.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "moe_impl='ragged' reads its group sizes on the host and cannot "
            "run inside a CUDA graph capture; serve with 'dense'")
    K = cfg.num_experts_per_tok
    wg, wu, wd = (dense_w(lp[n]) for n in ("we_g", "we_u", "we_d"))
    first = _first_expert(cfg, wg)
    flat_e = topi.reshape(-1)
    sizes = _group_sizes(flat_e, cfg.num_experts)
    mine = sizes[first:first + wg.shape[0]]
    lo = sum(sizes[:first])
    order = torch.argsort(flat_e, stable=True)[lo:lo + sum(mine)]
    tok_of = order // K
    ys = torch.cat([_expert(cfg, seg, wg[j], wu[j], wd[j])
                    for j, seg in enumerate(torch.split(xt[tok_of], mine))])
    ys = ys * topv.reshape(-1)[order][:, None].to(ys.dtype)
    return torch.zeros((xt.shape[0], xt.shape[1]), dtype=ys.dtype,
                       device=xt.device).index_add_(0, tok_of, ys)


def _group_sizes(flat_e: torch.Tensor, E: int) -> list:
    """Routed slots a expert, read on the host (``bincount``).  A ``meta``
    routing has no values (the launch dry-run, which compiles no graph as
    the reference's ``ragged_dot`` does over traced sizes): its slots are
    split evenly over the experts, the first ``n % E`` one more: the
    balanced routing.  The sizes sum to the slots either way, so each
    expert product's FLOPs over all experts, 2 * slots * D * F, are exact
    whatever the split; a rank of a model axis of m that divides E gets
    about slots / m of them, exactly where E divides the slots, as a
    balanced router gives it (a real router's ranks get more or fewer)."""
    if flat_e.device.type == "meta":
        n = flat_e.numel()
        return [n // E + (e < n % E) for e in range(E)]
    return torch.bincount(flat_e, minlength=E).tolist()


def _moe_local(cfg, lp, xt, topi, topv):
    """The reference's ``_moe_local`` (its ``shard_map`` body): for each of
    this rank's experts (every expert without a model axis), the ``cap``
    highest matching slot ids (``topk`` over the slot ids, -1 where the
    slot went elsewhere), its product over their tokens, gated and added
    in f32; the shared expert (the rank's columns and rows) on every token
    inside the same sum; the sum cast back to the activations' type, the
    rank's partial sum that the block reduces once.  The capacity comes
    from the rows given (a data rank's own, as the reference's ``t_loc``)."""
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    cap = min(max(32, int(2.0 * T * K / E)), T * K)
    slots_e, slots_v = topi.reshape(-1), topv.reshape(-1)
    slot = torch.arange(T * K, device=xt.device)
    slot_tok = slot // K
    wg, wu, wd = (dense_w(lp[n]) for n in ("we_g", "we_u", "we_d"))
    first = _first_expert(cfg, wg)
    out = torch.zeros((T, D), dtype=torch.float32, device=xt.device)
    for j in range(wg.shape[0]):
        sel = torch.topk(torch.where(slots_e == first + j, slot, -1),
                         cap).values
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
    # Placed: the projection's sections are of unequal widths, so it is
    # gathered whole; the conv runs on each rank's channels, and the
    # scan on its heads.
    zxbcdt = replicated(mm(x, lp["ssm_in"]))
    z = zxbcdt[..., :di]
    xbc_pre = zxbcdt[..., di: 2 * di + 2 * G * N]
    dt_raw = zxbcdt[..., 2 * di + 2 * G * N:]
    xbc = replicated(ops.causal_conv1d(xbc_pre, lp["conv_w"],
                                       lp["conv_b"], init=init_conv))
    # Column slices of xbc: the scan reads them in place (row-strided).
    xs = xbc[..., :di]
    Bm = xbc[..., di: di + G * N].reshape(B, S, G, N)
    Cm = xbc[..., di + G * N:].reshape(B, S, G, N)
    dt = softplus(dt_raw.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    xh = hint(xs.reshape(B, S, nh, cfg.ssm_head_dim),
              "dp", None, "model", None)
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
    # Placed: as in the prefill; the depthwise step on each rank's
    # channels, as the cache's conv buffer is split.
    zxbcdt = replicated(mm(x[:, 0, :], lp["ssm_in"]))
    z = zxbcdt[..., :di]
    xbc = hint(zxbcdt[..., di: 2 * di + 2 * G * N], "dp", "model")
    dt_raw = zxbcdt[..., 2 * di + 2 * G * N:]
    xbc_act, new_conv = ops.causal_conv1d_step(
        xbc, hint(lp["conv_w"], None, "model"), lp["conv_b"],
        hint(conv_buf, "dp", None, "model"))
    xbc_act = replicated(xbc_act)
    xs = xbc_act[..., :di]
    Bm = xbc_act[..., di: di + G * N].reshape(B, G, N)
    Cm = xbc_act[..., di + G * N:].reshape(B, G, N)
    dt = softplus(dt_raw.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    xh = xs.reshape(B, nh, cfg.ssm_head_dim)
    # Placed: on each rank's heads, as the cache's state is split.
    y, new_state = ops.ssd_step(hint(xh, "dp", "model", None), dt, A, Bm,
                                Cm, lp["D_skip"], state)
    y = _gated_norm(cfg, lp, y.reshape(B, di), z)
    return y[:, None, :], new_state, new_conv
