"""Building-block layers of the attention families (dense subset).

Port of :mod:`repro.models.layers`: pure functions over explicit parameter
dicts.  Per-layer parameters arrive as one slice of the stacked ``(L, ...)``
leaves.  Attention runs through the port's kernels: prefill through
``ops.flash_attention``, decode through ``ops.decode_attention``.  The SSM
and MoE branches are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
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
                     lengths: torch.Tensor, window: int, prefix: int = 0):
    """One token per sequence.  x: (B, 1, D) input-normed; k/v cache:
    (B, T, KV, hd); lengths: (B,) int32, the new token's index.

    Unlike the reference, which returns updated copies of the caches,
    the new token's k/v are written into ``k_cache``/``v_cache`` in place
    (one row per sequence); returns attn_out (B, 1, H*hd)."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, lp, x, lengths[:, None])
    bidx = torch.arange(B, device=x.device)
    pos = lengths.long()
    k_cache[bidx, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos] = v[:, 0].to(v_cache.dtype)
    out = ops.decode_attention(
        q[:, 0].contiguous(), k_cache, v_cache, lengths + 1, window=window,
        softcap=cfg.attn_logit_softcap, scale=cfg.attn_scale, prefix=prefix)
    return out.reshape(B, 1, -1)


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------
def mlp(cfg: ModelConfig, x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    return mm(act_fn(mm(x, wg), cfg.act) * mm(x, wu), wd)
