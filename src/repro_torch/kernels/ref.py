"""Plain PyTorch versions of the kernels the port runs on its main path.

These mirror :mod:`repro.kernels.ref` operation for operation and are the
port's oracles: the CPU and ``meta`` paths of every kernel wrapper compute
with them,
and ``chip_smoke.py`` holds each Hopper kernel against them on the card.
``paged_decode_attention`` gathers the pages that ``paginate_kv``
(:mod:`repro_torch.kernels.decode_attention`) lays out.
``decode_attention_splits`` and its paged counterpart model the decode
kernel's split-key passes, ``quant_matmul_splits`` the cluster's split-K
sum, ``ssd_scan_sliced`` the scan's chunks and slices and
``flash_attention_tiles`` the prefill kernel's key tiles and
``flash_attention_bwd_tiles`` its backward's two passes,
``ssd_scan_bwd_tiles`` the scan backward's passes, for the tests;
nothing else calls them.  ``flash_attention_bwd`` (autograd through
``flash_attention``) and ``ssd_scan_bwd`` (autograd through
``ssd_scan_chunked``) are the backward kernels' oracles.
Scores, softmax and products run in float32; outputs are cast back to the
query's (or ``out_dtype``'s) type, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves

# The devices whose tensors the kernel wrappers hand to these plain
# versions: the CPU, and ``meta`` (shapes and types only, as the launch
# dry-run runs the model; nothing is built or launched).
PLAIN_DEVICES = ("cpu", "meta")


class _KernelIO:
    """How a byte count of the plain graph (the launch dry-run's) sees a
    call that is one kernel on the card: inside one (``depth`` > 0) it
    counts none of the plain version's operations, and ``bytes`` gains
    the call's tensor arguments and results once each, as the kernel
    reads and writes them."""

    depth = 0
    bytes = 0


KERNEL_IO = _KernelIO()


def as_kernel(fn, *args, extra_bytes: int = 0, **kw):
    """``fn(*args, **kw)``, a kernel's plain version, counted in
    :data:`KERNEL_IO` as the kernel: ``extra_bytes`` are what the kernel
    also reads or writes and the plain version does not take or return
    (the attention's row log-sum-exp)."""
    KERNEL_IO.depth += 1
    try:
        out = fn(*args, **kw)
    finally:
        KERNEL_IO.depth -= 1
    if not KERNEL_IO.depth:
        KERNEL_IO.bytes += extra_bytes + sum(
            t.numel() * t.element_size() for t in tree_leaves((args, kw, out))
            if isinstance(t, torch.Tensor))
    return out

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


def flash_attention_tiles(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    *,
    bq: int,
    bk: int,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: float = 0.0,
    q_offset: int = 0,
    prefix: int = 0,
) -> torch.Tensor:
    """A plain model of the ``flash_attention`` kernel's arithmetic order
    (``csrc/flash_attention.cu``): query positions in tiles of ``bq``,
    all G query heads of a KV head together; keys in tiles of ``bk`` over
    the range a tile's rows can see (the prefix before the window's
    range, then the range); per key tile the row max and sum taken once
    and the accumulator rescaled once; a row with no visible key in a tile
    keeps its max and sum; a row with none at all gets the mean of v over
    all T.  Equal to :func:`flash_attention` up to rounding.  Only the
    tests call it."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale == 0.0:
        scale = D ** -0.5
    dev = q.device
    qf = (q.float() * scale).reshape(B, S, KV, G, D)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, KV, G, D), device=dev)
    for q0 in range(0, S, bq):
        q1 = min(S, q0 + bq)
        nq = q1 - q0
        pos = q_offset + torch.arange(q0, q1, device=dev)[:, None]
        hi = min(T, q_offset + q1) if causal else T
        lo = max(0, q_offset + q0 - window + 1) if window else 0
        a_end = min(prefix, lo, hi) if window else 0
        tiles = [(t, min(t + bk, a_end)) for t in range(0, a_end, bk)]
        tiles += [(t, min(t + bk, hi)) for t in range(lo, hi, bk)]
        m = torch.full((B, KV, G, nq), float("-inf"), device=dev)
        den = torch.zeros((B, KV, G, nq), device=dev)
        acc = torch.zeros((B, KV, G, nq, D), device=dev)
        for t0, t1 in tiles:
            s = torch.einsum("bqkgd,btkd->bkgqt", qf[:, q0:q1], kf[:, t0:t1])
            if softcap:
                s = _softcap(s, softcap)
            tk = torch.arange(t0, t1, device=dev)[None, :]
            vis = torch.ones((nq, t1 - t0), dtype=torch.bool, device=dev)
            if causal:
                vis &= tk <= pos
            if window:
                vis &= (tk > pos - window) | (tk < prefix)
            s = torch.where(vis, s, float("-inf"))
            mt = s.amax(-1)
            seen = mt > float("-inf")
            m_new = torch.where(seen, torch.maximum(m, mt), m)
            alpha = torch.where(seen, torch.exp(m - m_new), 1.0)
            p = torch.where(seen[..., None], torch.exp(s - m_new[..., None]),
                            0.0)
            den = den * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p, vf[:, t0:t1])
            m = m_new
        o = acc / den.clamp_min(1e-30)[..., None]
        mean = vf.mean(1)[:, :, None, None, :]  # (B, KV, 1, 1, D)
        o = torch.where((den == 0)[..., None], mean, o)
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, H, D).to(q.dtype)


def _visible(pos: torch.Tensor, tk: torch.Tensor, causal: bool, window: int,
             prefix: int) -> torch.Tensor:
    """(query, key) pairs the prefill attention lets through."""
    vis = torch.ones(pos.shape[0], tk.shape[1], dtype=torch.bool,
                     device=pos.device)
    if causal:
        vis &= tk <= pos
    if window:
        vis &= (tk > pos - window) | (tk < prefix)
    return vis


def flash_attention_lse(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=0.0, q_offset=0, prefix=0):
    """(:func:`flash_attention`, lse): each row's log-sum-exp (B, H, S)
    float32 of its capped, masked scores, -inf for a row that sees no key
    (the ``flash_attention`` kernel's training output)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst",
                     (q.float() * (scale or D ** -0.5)).reshape(
                         B, S, KV, H // KV, D), k.float())
    if softcap:
        s = _softcap(s, softcap)
    pos = q_offset + torch.arange(S, device=q.device)[:, None]
    vis = _visible(pos, torch.arange(T, device=q.device)[None, :], causal,
                   window, prefix)
    lse = torch.logsumexp(torch.where(vis, s, float("-inf")), dim=-1)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap, scale=scale, q_offset=q_offset,
                          prefix=prefix)
    return out, lse.reshape(B, H, S)


def flash_attention_bwd(q, k, v, dout, **kw):
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``dout``: autograd through the plain version, the backward kernel's
    oracle."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = flash_attention(qq, kk, vv, **kw)
        return torch.autograd.grad(o, (qq, kk, vv), dout.to(o.dtype))


def flash_attention_bwd_tiles(q, k, v, o, dout, lse, *, big: int,
                              small: int, splits: int = 1, causal=True,
                              window=0, softcap=0.0, scale=0.0, q_offset=0,
                              prefix=0):
    """A plain model of the backward kernel's two passes
    (``csrc/flash_attention_bwd.cu``), in float32: Delta = rowsum(dO o);
    dQ by tiles of ``big`` query rows of one head over the key tiles of
    ``small`` keys they can see (as the forward walks them); dK and dV by
    tiles of ``big`` keys of one KV head, whose G query heads are cut
    into ``splits`` runs of G / splits (the bf16 path's head split, one
    block each), each run over its heads and the rows, ``small`` at a
    time, that can see a key of the tile, the runs' sums then added in
    run order; P recomputed from ``lse``; a row that sees no key (lse =
    -inf) adds dO / T to every key's dV.  Equal to
    :func:`flash_attention_bwd` up to rounding.  Only the tests call
    it."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale or D ** -0.5
    dev = q.device
    qf = q.float() * scale
    kf, vf, do = k.float(), v.float(), dout.float()
    delta = (do * o.float()).sum(-1)  # (B, S, H)
    lse_ = lse.permute(0, 2, 1)  # (B, S, H)

    def grads(r0, r1, t0, t1, h):
        kvh = h // G
        s = torch.einsum("bqd,btd->bqt", qf[:, r0:r1, h], kf[:, t0:t1, kvh])
        dp = torch.einsum("bqd,btd->bqt", do[:, r0:r1, h], vf[:, t0:t1, kvh])
        pos = q_offset + torch.arange(r0, r1, device=dev)[:, None]
        tk = torch.arange(t0, t1, device=dev)[None, :]
        lrow = lse_[:, r0:r1, h, None]
        ok = _visible(pos, tk, causal, window, prefix)[None] & (
            lrow > float("-inf"))
        th = torch.tanh(s / softcap) if softcap else None
        t = th * softcap if softcap else s
        p = torch.exp(torch.where(ok, t - lrow, float("-inf")))
        ds = p * (dp - delta[:, r0:r1, h, None])
        if softcap:
            ds = ds * (1 - th * th)
        return p, ds

    dq = torch.zeros((B, S, H, D), device=dev)
    for h in range(H):
        for r0 in range(0, S, big):
            r1 = min(S, r0 + big)
            last = q_offset + r1 - 1
            hi = min(T, last + 1) if causal else T
            lo = max(0, q_offset + r0 - window + 1) if window else 0
            a_end = min(prefix, lo, hi) if window else 0
            tiles = [(t, min(t + small, a_end)) for t in range(0, a_end, small)]
            tiles += [(t, min(t + small, hi)) for t in range(lo, hi, small)]
            for t0, t1 in tiles:
                _, ds = grads(r0, r1, t0, t1, h)
                dq[:, r0:r1, h] += torch.einsum("bqt,btd->bqd", ds,
                                                kf[:, t0:t1, h // G])
    dq = dq * scale
    dk = torch.zeros((B, T, KV, D), device=dev)
    dv = torch.zeros((B, T, KV, D), device=dev)
    empty = torch.isneginf(lse_)  # (B, S, H)
    gs = G // splits
    for kvh in range(KV):
        for n0 in range(0, T, big):
            n1 = min(T, n0 + big)
            p_lo = n0 if causal else 0
            p_hi = (n1 - 2 + window if window and n0 >= prefix
                    else q_offset + S)
            r_lo, r_end = max(0, p_lo - q_offset), min(S, p_hi - q_offset + 1)
            for sp in range(splits):
                heads = range(kvh * G + sp * gs, kvh * G + (sp + 1) * gs)
                pk = torch.zeros((B, n1 - n0, D), device=dev)
                pv = torch.zeros((B, n1 - n0, D), device=dev)
                for h in heads:
                    for r0 in range(r_lo, r_end, small):
                        r1 = min(S, r0 + small)
                        p, ds = grads(r0, r1, n0, n1, h)
                        pv += torch.einsum("bqt,bqd->btd", p, do[:, r0:r1, h])
                        pk += torch.einsum("bqt,bqd->btd", ds,
                                           qf[:, r0:r1, h])
                hs = slice(heads.start, heads.stop)
                pv += (torch.einsum("bsh,bshd->bd", empty[:, :, hs].float(),
                                    do[:, :, hs]) / T)[:, None]
                dk[:, n0:n1, kvh] += pk
                dv[:, n0:n1, kvh] += pv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    up to rounding; the CPU path of ``ops.ssd_scan``.  Computes in float32,
    or in float64 for float64 inputs; each input is widened once, so
    autograd rounds each gradient to a bf16 input's type once."""
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
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct).reshape(Bb, nc, Q, H, P)
    dtf = dt.to(ct).reshape(Bb, nc, Q, H)
    Bf = Bm.to(ct).repeat_interleave(rep, dim=2).reshape(Bb, nc, Q, H, N)
    Cf = Cm.to(ct).repeat_interleave(rep, dim=2).reshape(Bb, nc, Q, H, N)
    Af = A.to(ct)

    a = dtf * Af[None, None, None, :]  # (B, nc, Q, H) — log decay per step
    a_cum = torch.cumsum(a, dim=2)  # inclusive within-chunk cumulative decay
    # Intra-chunk ("diagonal block") term.  exp(seg) overflows above the
    # diagonal; the select (not a product) keeps it out of the result.  It
    # selects the exponent's argument (-inf above the diagonal, exp 0), not
    # exp(seg) itself: the values are the same, and autograd's gradient
    # stays finite (through a select of exp(seg), a zero cotangent meets
    # the overflowed exp and gives 0 * inf = NaN).
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    iq = torch.arange(Q, device=x.device)
    tri = iq[:, None] >= iq[None, :]
    Ldec = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                 float("-inf")))
    cb = torch.einsum("bcqhn,bckhn->bcqkh", Cf, Bf)
    M = cb * Ldec * dtf[:, :, None, :, :]  # weight by dt at the key position
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", M, xf)
    # Chunk-final states.
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (B, nc, Q, H)
    S_c = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_to_end * dtf, Bf, xf)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (B, nc, H)
    h = (torch.zeros((Bb, H, P, N), dtype=ct, device=x.device)
         if init_state is None else init_state.to(ct))
    h_prev = []  # the state at each chunk's START
    for c in range(nc):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B, nc, H, P, N)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cf, h_prev,
                         torch.exp(a_cum))
    y = (y_diag + y_off).reshape(Bb, S, H, P)[:, :S0]
    y = y + xf.reshape(Bb, S, H, P)[:, :S0] * D.to(ct)[None, None, :, None]
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def ssd_scan_sliced(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    D: torch.Tensor,  # (H,)
    *,
    kq: int,
    ps: int = 16,
    init_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """A plain model of the ``ssd_scan`` kernel's decomposition
    (``csrc/ssd_scan.cu``): chunks of ``kq`` rows, the last one ragged;
    each chunk's decay block M built in row blocks of kq / CS, one per
    cluster rank (CS = 1, 2 or 4 slices of ``ps`` columns of P); each
    slice's y columns and rows of the state from its own x columns; no
    C . state term while the state is known to be zero (the first chunk
    without ``init_state``), whose update is then the state itself.  Equal
    to :func:`ssd_scan` up to rounding.  Only the tests call it."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    cs = 1 if P <= ps else 2 if P <= 2 * ps else 4
    xf = x.float()
    dtf = dt.float()
    Bf = Bm.float().repeat_interleave(rep, dim=2)  # (B, S, H, N)
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    Af = A.float()
    Df = D.float()[None, None, :, None]
    h = None if init_state is None else init_state.float().clone()
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, kq):
        nq = min(kq, S - c0)
        sl = slice(c0, c0 + nq)
        a_cum = torch.cumsum(dtf[:, sl] * Af, dim=1)  # (B, q, H)
        a_end = a_cum[:, -1]  # (B, H)
        blocks = []
        for r in range(cs):  # rank r's rows of M
            lo, hi = r * kq // cs, min(nq, (r + 1) * kq // cs)
            if lo >= hi:
                break
            cb = torch.einsum("bihn,bjhn->bhij", Cf[:, c0 + lo:c0 + hi],
                              Bf[:, sl])
            seg = (a_cum[:, lo:hi, None, :] - a_cum[:, None, :, :]
                   ).permute(0, 3, 1, 2)  # (B, H, i, j)
            i = torch.arange(lo, hi, device=x.device)[:, None]
            j = torch.arange(nq, device=x.device)[None, :]
            L = torch.where(i >= j, torch.exp(seg),
                            torch.zeros((), device=x.device))
            blocks.append(cb * L * dtf[:, sl].permute(0, 2, 1)[:, :, None])
        M = torch.cat(blocks, dim=2)  # (B, H, q, q)
        w = torch.exp(a_end[:, None] - a_cum) * dtf[:, sl]  # (B, q, H)
        for p0 in range(0, P, ps):
            cols = slice(p0, min(P, p0 + ps))
            xs = xf[:, sl, :, cols]
            yc = torch.einsum("bhij,bjhp->bihp", M, xs)
            if h is not None:
                yc = yc + torch.exp(a_cum)[..., None] * torch.einsum(
                    "bihn,bhpn->bihp", Cf[:, sl], h[:, :, cols])
            y[:, sl, :, cols] = yc + xs * Df
        upd = torch.einsum("bjh,bjhp,bjhn->bhpn", w, xf[:, sl], Bf[:, sl])
        h = upd if h is None else (
            torch.exp(a_end)[:, :, None, None] * h + upd)
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy, *, init_state=None, dstate=None,
                 chunk: int = 256):
    """(dx, ddt, dA, dBm, dCm, dD, d init_state) of :func:`ssd_scan_chunked`
    at ``chunk`` for the output gradient ``dy`` and the final state's
    ``dstate`` (either None: zero): autograd through the plain version,
    the backward kernel's oracle.  Each gradient in its input's type; the
    last is None without ``init_state``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
        init = (None if init_state is None
                else init_state.detach().requires_grad_())
        y, h = ssd_scan_chunked(*leaves, chunk=chunk, init_state=init,
                                return_state=True)
        outs, cots = [], []
        if dy is not None:
            outs.append(y)
            cots.append(dy.to(y.dtype))
        if dstate is not None:
            outs.append(h)
            cots.append(dstate.to(h.dtype))
        wrt = leaves + ([init] if init is not None else [])
        grads = (torch.autograd.grad(outs, wrt, cots, allow_unused=True)
                 if outs else [None] * len(wrt))
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(wrt, grads)]
    return (*grads[:6], grads[6] if init is not None else None)


def ssd_scan_bwd_tiles(x, dt, A, Bm, Cm, D, dy, *, kq: int,
                       cluster: int = 1, init_state=None, dstate=None):
    """A plain model of the backward kernels' decomposition
    (``csrc/ssd_scan_bwd.cu``), in float32: chunks of ``kq`` rows, the
    last one ragged.  (1) Each chunk's own states, S_c = sum_j w_j x_j ⊗
    B_j and T_c = sum_i e^{a_i} dy_i ⊗ C_i, and a_end.  (2) The two scans
    over the chunks: h_{c+1} = e^{a_end} h_c + S_c from the initial state
    and g_c = e^{a_end} g_{c+1} + T_c from the final state's cotangent;
    g_0 is the initial state's gradient.  (3) Each chunk's gradients from
    h_c and g_{c+1} alone, in any order: the decay block's M, W and F,
    dx, per-head dB and dC, d(a) per row and its reverse cumulative sum
    into ddt, and the chunk's dA (term by term, as the kernel takes it)
    and dD partials.  (4) The per-head dB and
    dC summed over clusters of ``cluster`` heads (it divides H/G) in rank
    order, then over each group's clusters in order; dA and dD over the
    sequences and chunks in order.  Equal to :func:`ssd_scan_bwd` up to
    rounding.  Only the tests call it."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    if rep % cluster:
        raise ValueError(f"cluster {cluster} does not divide H/G = {rep}")
    dev = x.device
    xf, dtf = x.float(), dt.float()
    dyf = (torch.zeros((Bb, S, H, P), device=dev) if dy is None
           else dy.float())
    Bf = Bm.float().repeat_interleave(rep, dim=2)  # (B, S, H, N)
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    Af, Df = A.float(), D.float()
    chunks = [(c0, min(kq, S - c0)) for c0 in range(0, S, kq)]

    def decays(c0, nq):  # a, e^a, e^(a_end - a), w: (B, q, H); a_end (B, H)
        a = torch.cumsum(dtf[:, c0:c0 + nq] * Af, dim=1)
        ed = torch.exp(a[:, -1:] - a)
        return a, torch.exp(a), ed, ed * dtf[:, c0:c0 + nq], a[:, -1]

    # (1) the chunks' own states.
    own_s, own_t, ends = [], [], []
    for c0, nq in chunks:
        sl = slice(c0, c0 + nq)
        _, ea, _, w, a_end = decays(c0, nq)
        own_s.append(torch.einsum("bjh,bjhp,bjhn->bhpn", w, xf[:, sl],
                                  Bf[:, sl]))
        own_t.append(torch.einsum("bih,bihp,bihn->bhpn", ea, dyf[:, sl],
                                  Cf[:, sl]))
        ends.append(torch.exp(a_end)[..., None, None])
    # (2) the two scans: hs[c] = h_c, gs[c] = g_{c+1}.
    h = (torch.zeros((Bb, H, P, N), device=dev) if init_state is None
         else init_state.float())
    hs = []
    for c in range(len(chunks)):
        hs.append(h)
        h = ends[c] * h + own_s[c]
    g = (torch.zeros((Bb, H, P, N), device=dev) if dstate is None
         else dstate.float())
    gs = [None] * len(chunks)
    for c in reversed(range(len(chunks))):
        gs[c] = g
        g = ends[c] * g + own_t[c]
    # (3) each chunk's gradients.
    dx = torch.empty((Bb, S, H, P), device=dev)
    ddt = torch.empty((Bb, S, H), device=dev)
    dBp = torch.empty((Bb, S, H, N), device=dev)
    dCp = torch.empty((Bb, S, H, N), device=dev)
    dAp = torch.empty((Bb, H, len(chunks)), device=dev)
    dDp = torch.empty((Bb, H, len(chunks)), device=dev)
    for c, (c0, nq) in enumerate(chunks):
        sl = slice(c0, c0 + nq)
        hc, gc = hs[c], gs[c]
        xc, dyc, bc, cc, dtc = (xf[:, sl], dyf[:, sl], Bf[:, sl], Cf[:, sl],
                                dtf[:, sl])
        a, ea, ed, w, a_end = decays(c0, nq)
        i = torch.arange(nq, device=dev)
        tri = (i[:, None] >= i[None, :])[None, None]
        ah = a.permute(0, 2, 1)  # (B, H, q)
        L = torch.where(tri, torch.exp(ah[..., :, None] - ah[..., None, :]),
                        torch.zeros((), device=dev))
        cb = torch.einsum("bihn,bjhn->bhij", cc, bc)
        dm = torch.einsum("bihp,bjhp->bhij", dyc, xc)
        dtj = dtc.permute(0, 2, 1)[:, :, None, :]
        M, W, F_ = cb * L * dtj, dm * L * dtj, dm * cb * L
        gB = torch.einsum("bhpn,bjhn->bjhp", gc, bc)
        Z = torch.einsum("bihp,bhpn->bihn", dyc, hc)
        Xg = torch.einsum("bjhp,bhpn->bjhn", xc, gc)
        zc = (cc * Z).sum(-1)  # (B, q, H)
        xgb = (xc * gB).sum(-1)
        dx[:, sl] = (w[..., None] * gB
                     + torch.einsum("bhij,bihp->bjhp", M, dyc)
                     + Df[:, None] * dyc)
        dCp[:, sl] = (ea[..., None] * Z
                      + torch.einsum("bhij,bjhn->bihn", W, bc))
        dBp[:, sl] = (w[..., None] * Xg
                      + torch.einsum("bhij,bihn->bjhn", W, cc))
        rowe = (F_ * dtj).sum(-1).permute(0, 2, 1)  # (B, q, H)
        colf = F_.sum(-2).permute(0, 2, 1)
        gh = (gc * hc).sum((-1, -2))  # (B, H)
        u = w * xgb
        da = rowe - dtc * colf + ea * zc - u
        da[:, nq - 1] += u.sum(1) + torch.exp(a_end) * gh
        R = torch.flip(torch.cumsum(torch.flip(da, (1,)), 1), (1,))
        ddt[:, sl] = colf + ed * xgb + Af * R
        # dA = sum_m dt_m R_m = sum_i d(a)_i c_i (c = cumsum(dt)), term by
        # term: F's share as sum_{j <= i} F_ij dt_j (c_i - c_j), not as the
        # difference of its row and column sums, which cancels.
        cdt = torch.cumsum(dtc, 1)  # (B, q, H)
        ch = cdt.permute(0, 2, 1)
        cl = cdt[:, -1]
        dAp[:, :, c] = ((F_ * dtj * (ch[..., :, None] - ch[..., None, :]))
                        .sum((-1, -2))
                        + (ea * zc * cdt + u * (cl[:, None] - cdt)).sum(1)
                        + cl * torch.exp(a_end) * gh)
        dDp[:, :, c] = torch.diagonal(dm, dim1=-2, dim2=-1).sum(-1)
    # (4) the fixed-order sums.
    dBc = torch.zeros((Bb, S, H // cluster, N), device=dev)
    dCc = torch.zeros((Bb, S, H // cluster, N), device=dev)
    for r in range(cluster):  # the heads of a cluster, in rank order
        dBc += dBp.reshape(Bb, S, H // cluster, cluster, N)[:, :, :, r]
        dCc += dCp.reshape(Bb, S, H // cluster, cluster, N)[:, :, :, r]
    per = rep // cluster
    dB = torch.zeros((Bb, S, G, N), device=dev)
    dC = torch.zeros((Bb, S, G, N), device=dev)
    for k in range(per):  # the clusters of a group, in order
        dB += dBc.reshape(Bb, S, G, per, N)[:, :, :, k]
        dC += dCc.reshape(Bb, S, G, per, N)[:, :, :, k]
    dA = torch.zeros((H,), device=dev)
    dD = torch.zeros((H,), device=dev)
    for b in range(Bb):  # the sequences, then the chunks, in order
        for c in range(len(chunks)):
            dA += dAp[b, :, c]
            dD += dDp[b, :, c]
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype), dD.to(D.dtype),
            g if init_state is not None else None)


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
