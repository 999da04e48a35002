"""Plain PyTorch versions of the kernels the port runs on its main path.

These mirror :mod:`repro.kernels.ref` operation for operation and are the
port's oracles: the CPU path of every kernel wrapper computes with them,
and ``chip_smoke.py`` holds each Hopper kernel against them on the card.
``paged_decode_attention`` gathers the pages that ``paginate_kv``
(:mod:`repro_torch.kernels.decode_attention`) lays out.
``decode_attention_splits`` and its paged counterpart model the decode
kernel's split-key passes for the tests; nothing else calls them.
Scores, softmax and products run in float32; outputs are cast back to the
query's (or ``out_dtype``'s) type, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def paged_decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (P, KV, page_size, D)
    v_pages: torch.Tensor,  # (P, KV, page_size, D)
    page_table: torch.Tensor,  # (B, NP) int32
    lengths: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float = 0.0,
    prefix: int = 0,
) -> torch.Tensor:
    """Gather each sequence's pages back into a dense cache, then run the
    dense version.  Table entries past ``lengths`` may point anywhere
    (they are masked)."""
    B, NP = page_table.shape
    _, KV, ps, D = k_pages.shape
    idx = page_table.long()
    # (B, NP, KV, ps, D) -> (B, NP, ps, KV, D) -> (B, NP*ps, KV, D)
    k = k_pages[idx].transpose(2, 3).reshape(B, NP * ps, KV, D)
    v = v_pages[idx].transpose(2, 3).reshape(B, NP * ps, KV, D)
    return decode_attention(q, k, v, lengths, window=window, softcap=softcap,
                            scale=scale, prefix=prefix)


def decode_attention_splits(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, T, KV, D)
    v_cache: torch.Tensor,  # (B, T, KV, D)
    lengths: torch.Tensor,  # (B,) int32
    *,
    split: int,
    window: int = 0,
    softcap: float = 0.0,
    scale: float = 0.0,
    prefix: int = 0,
) -> torch.Tensor:
    """A plain model of the two passes of the split-key decode kernel
    (``csrc/decode_attention.cu``): each split of ``split`` keys gives a
    partial (m, l, acc) over its visible keys, and the partials are folded
    in split order, empty ones skipped; a row with no visible key gets the
    mean of v over all T rows.  Equal to :func:`decode_attention` up to
    rounding.  Only the tests call it."""
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
    vf = v_cache.float()
    m = torch.full((B, KV, G), NEG_INF, device=q.device)
    den = torch.zeros((B, KV, G), device=q.device)
    acc = torch.zeros((B, KV, G, D), device=q.device)
    for lo in range(0, T, split):
        vis = valid[:, None, None, lo:lo + split]
        sv = torch.where(vis, s[..., lo:lo + split], float("-inf"))
        m_s = sv.amax(-1)  # -inf for an empty split
        p = torch.where(vis, torch.exp(sv - m_s[..., None]), 0.0)
        acc_s = torch.einsum("bkgt,btkd->bkgd", p, vf[:, lo:lo + split])
        keep = vis.any(-1)  # (B, 1, 1): the split holds a visible key
        m_new = torch.where(keep, torch.maximum(m, m_s), m)
        a = torch.exp(m - m_new)
        w = torch.where(keep, torch.exp(m_s - m_new), 0.0)
        den = den * a + p.sum(-1) * w
        acc = acc * a[..., None] + acc_s * w[..., None]
        m = m_new
    out = acc / den.clamp_min(1e-30)[..., None]
    mean = vf.mean(1)[:, :, None, :]  # (B, KV, 1, D)
    out = torch.where((den == 0)[..., None], mean, out)
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention_splits(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (P, KV, page_size, D)
    v_pages: torch.Tensor,  # (P, KV, page_size, D)
    page_table: torch.Tensor,  # (B, NP) int32
    lengths: torch.Tensor,  # (B,) int32
    *,
    split: int,
    window: int = 0,
    softcap: float = 0.0,
    scale: float = 0.0,
    prefix: int = 0,
) -> torch.Tensor:
    """:func:`decode_attention_splits` over the gathered pages (NP *
    page_size logical rows, split at the same positions as the dense
    cache).  Only the tests call it."""
    B, NP = page_table.shape
    _, KV, ps, D = k_pages.shape
    idx = page_table.long()
    k = k_pages[idx].transpose(2, 3).reshape(B, NP * ps, KV, D)
    v = v_pages[idx].transpose(2, 3).reshape(B, NP * ps, KV, D)
    return decode_attention_splits(q, k, v, lengths, split=split,
                                   window=window, softcap=softcap,
                                   scale=scale, prefix=prefix)


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


def quant_matmul_splits(
    x: torch.Tensor,  # (..., K)
    w_q: torch.Tensor,  # (K, N) int8
    scales: torch.Tensor,  # (K // group, N) float
    *,
    splits: int,
    rows: int,
    out_dtype=None,
) -> torch.Tensor:
    """A plain model of the split-K reduction of the ``quant_matmul``
    kernel (``csrc/quant_matmul.cu``): split s takes rows [s * rows,
    (s + 1) * rows) of K (the last may be short or empty) and gives an f32
    partial; the partials are added in split order, as rank r of the
    cluster adds ranks 0..S-1.  Equal to :func:`quant_matmul` up to
    rounding.  Only the tests call it."""
    K, N = w_q.shape
    G = scales.shape[0]
    group = K // G
    out_dtype = out_dtype or x.dtype
    w = (w_q.float().reshape(G, group, N) * scales.float()[:, None, :]
         ).reshape(K, N)
    xf = x.float()
    y = None
    for s in range(splits):
        lo, hi = min(K, s * rows), min(K, (s + 1) * rows)
        part = xf[..., lo:hi] @ w[lo:hi]
        y = part if y is None else y + part
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


# ---------------------------------------------------------------------------
# ssd_scan: Mamba-2 state-space-duality scan (sequential oracle).
#   h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)
#   y_t = C_t · h_t + D ⊙ x_t
# ---------------------------------------------------------------------------
def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) — post-softplus, positive
    A: torch.Tensor,  # (H,) — negative decay rates
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    D: torch.Tensor,  # (H,)
    *,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    return_state: bool = False,
):
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf = x.float()
    dtf = dt.float()
    Bf = Bm.float().repeat_interleave(rep, dim=2)  # (B, S, H, N)
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    Af = A.float()
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])  # (B, H)
        dBx = torch.einsum("bh,bhn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        h = decay[:, :, None, None] * h + dBx
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def ssd_scan_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    D: torch.Tensor,  # (H,)
    *,
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Chunked SSD (the Mamba-2 algorithm): a quadratic intra-chunk term
    plus a linear inter-chunk state recurrence.  Equal to :func:`ssd_scan`
    up to rounding; the CPU path of ``ops.ssd_scan``."""
    Bb, S0, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S0)
    if S0 % Q:
        # Pad the tail with dt=0 steps: decay=exp(0)=1 and the dt factor
        # zeroes the padded contributions, so the result is exact.
        pad = Q - S0 % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    S = x.shape[1]
    nc = S // Q
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dtf = dt.float().reshape(Bb, nc, Q, H)
    Bf = Bm.float().repeat_interleave(rep, dim=2).reshape(Bb, nc, Q, H, N)
    Cf = Cm.float().repeat_interleave(rep, dim=2).reshape(Bb, nc, Q, H, N)
    Af = A.float()

    a = dtf * Af[None, None, None, :]  # (B, nc, Q, H) — log decay per step
    a_cum = torch.cumsum(a, dim=2)  # inclusive within-chunk cumulative decay
    # Intra-chunk ("diagonal block") term.  exp(seg) overflows above the
    # diagonal; the select (not a product) keeps it out of the result.
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    iq = torch.arange(Q, device=x.device)
    tri = iq[:, None] >= iq[None, :]
    Ldec = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                       torch.zeros((), device=x.device))
    cb = torch.einsum("bcqhn,bckhn->bcqkh", Cf, Bf)
    M = cb * Ldec * dtf[:, :, None, :, :]  # weight by dt at the key position
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", M, xf)
    # Chunk-final states.
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (B, nc, Q, H)
    S_c = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_to_end * dtf, Bf, xf)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (B, nc, H)
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_prev = []  # the state at each chunk's START
    for c in range(nc):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B, nc, H, P, N)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cf, h_prev,
                         torch.exp(a_cum))
    y = (y_diag + y_off).reshape(Bb, S, H, P)[:, :S0]
    y = y + x.float()[:, :S0] * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def ssd_step(
    x: torch.Tensor,  # (B, H, P) — one token
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, G, N)
    Cm: torch.Tensor,  # (B, G, N)
    D: torch.Tensor,  # (H,)
    state: torch.Tensor,  # (B, H, P, N)
):
    """Single decode step of the SSD recurrence. Returns (y, new_state)."""
    H = x.shape[1]
    G = Bm.shape[1]
    rep = H // G
    xf = x.float()
    dtf = dt.float()
    Bf = Bm.float().repeat_interleave(rep, dim=1)
    Cf = Cm.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(dtf * A.float()[None, :])
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dtf, Bf, xf)
    new_state = decay[:, :, None, None] * state.float() + dBx
    y = torch.einsum("bhn,bhpn->bhp", Cf, new_state)
    y = y + xf * D.float()[None, :, None]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Depthwise causal conv (Mamba-2 front conv) — oracle + single-step update.
# ---------------------------------------------------------------------------
def causal_conv1d(
    x: torch.Tensor,  # (B, S, C)
    w: torch.Tensor,  # (W, C) depthwise taps
    b: torch.Tensor,  # (C,)
    *,
    init: Optional[torch.Tensor] = None,  # (B, W-1, C) left context
) -> torch.Tensor:
    B, S, C = x.shape
    W = w.shape[0]
    if init is None:
        init = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([init.float(), x.float()], dim=1)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i: i + S, :] * w[i].float()[None, None, :]
    out = out + b.float()[None, None, :]
    return F.silu(out).to(x.dtype)


def causal_conv1d_step(
    x: torch.Tensor,  # (B, C) — one token
    w: torch.Tensor,  # (W, C)
    b: torch.Tensor,  # (C,)
    buf: torch.Tensor,  # (B, W-1, C) rolling context
):
    """Returns (y, new_buf).  The buffer is concatenated in the promoted
    type of ``buf`` and ``x``, as the reference's ``concatenate`` does."""
    dtype = torch.promote_types(buf.dtype, x.dtype)
    full = torch.cat([buf.to(dtype), x[:, None, :].to(dtype)], dim=1)
    y = torch.einsum("bwc,wc->bc", full.float(), w.float())
    y = F.silu(y + b.float()[None, :]).to(x.dtype)
    return y, full[:, 1:, :]
