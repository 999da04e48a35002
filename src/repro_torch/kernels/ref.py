"""Plain PyTorch versions of the kernels the port runs on its main path.

These mirror :mod:`repro.kernels.ref` operation for operation and are the
port's oracles: the CPU path of every kernel wrapper computes with them,
and ``chip_smoke.py`` holds each Hopper kernel against them on the card.
Scores, softmax and products run in float32; outputs are cast back to the
query's (or ``out_dtype``'s) type, as in the reference.
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38  # close to bf16 min; avoids NaN from (-inf) - (-inf)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    *,
    causal: bool = True,
    window: int = 0,  # 0 = unbounded
    softcap: float = 0.0,
    scale: float = 0.0,
    q_offset: int = 0,  # absolute position of q[0] (prefill continuation)
    prefix: int = 0,  # positions < prefix always visible (meta tokens)
) -> torch.Tensor:
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale == 0.0:
        scale = D ** -0.5
    qg = (q.float() * scale).reshape(B, S, KV, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())  # (B, KV, G, S, T)
    if softcap:
        s = _softcap(s, softcap)
    q_pos = q_offset + torch.arange(S, device=q.device)[:, None]
    kv_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= (kv_pos > q_pos - window) | (kv_pos < prefix)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, H, D) — one new token per sequence
    k_cache: torch.Tensor,  # (B, T, KV, D)
    v_cache: torch.Tensor,  # (B, T, KV, D)
    lengths: torch.Tensor,  # (B,) int32 — valid prefix length per sequence
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float = 0.0,
    prefix: int = 0,
) -> torch.Tensor:
    B, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if scale == 0.0:
        scale = D ** -0.5
    qf = q.float().reshape(B, KV, G, D) * scale
    s = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.float())  # (B, KV, G, T)
    if softcap:
        s = _softcap(s, softcap)
    kv_pos = torch.arange(T, device=q.device)[None, :]
    lens = lengths.to(q.device, torch.int64)[:, None]
    valid = kv_pos < lens
    if window:
        valid &= (kv_pos >= lens - window) | (kv_pos < prefix)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def quant_matmul(
    x: torch.Tensor,  # (..., K)
    w_q: torch.Tensor,  # (K, N) int8 (int4 values in [-8, 7] use int8 storage)
    scales: torch.Tensor,  # (K // group, N) float
    *,
    out_dtype=None,
) -> torch.Tensor:
    K, N = w_q.shape
    G = scales.shape[0]
    group = K // G
    out_dtype = out_dtype or x.dtype
    w = w_q.float().reshape(G, group, N) * scales.float()[:, None, :]
    y = x.float() @ w.reshape(K, N)
    return y.to(out_dtype)


def quantize_weights(
    w: torch.Tensor, *, bits: int = 8, group: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(group, column) absmax quantization. w: (..., K, N),
    each trailing (K, N) slice on its own (the reference takes one slice).

    Bit-exact with the reference: the division runs in float32 and
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    *lead, K, N = w.shape
    if K % group:
        group = K  # degenerate single group
    G = K // group
    wg = w.float().reshape(*lead, G, group, N)
    qmax = float(2 ** (bits - 1) - 1)
    absmax = wg.abs().amax(dim=-2)  # (..., G, N)
    scales = torch.clamp_min(absmax / qmax, 1e-8)
    q = torch.clamp(torch.round(wg / scales[..., None, :]), -qmax - 1, qmax)
    return q.reshape(*lead, K, N).to(torch.int8), scales.float()
