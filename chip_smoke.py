#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (sm_90).

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   port's Hopper kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all in parallel; the dense and the paged decode share
   ``decode_attention.cu``).
2. Holds each kernel against its plain PyTorch version on the card, at the
   sweep shapes of ``tests/test_kernels.py`` and at the main path's
   shapes (every projection of the three tenants; tinyllama's and
   gemma2's attention, D=256 with window and softcap for gemma2, at the
   serving prefill and at the replay's prompts of 4 x 1024 and 2 x 4200
   tokens; mamba2's scan at a serving prefill in f32 and bf16 and at a
   2048-token prompt), and times kernel (event and device time, each
   call's plan beside it), plain version, the bound (bytes over 3.35 TB/s
   or operations over the peak rate of their type; the scan's operations
   are the least any form of it needs, whatever chunk its plan runs) and,
   for attention, the device time of ``scaled_dot_product_attention`` as
   a yardstick.  A long prefill's attention is also held to its plain
   version by relative l2 error, over the rows past the window where a
   window bites.  ``quant_matmul`` is
   timed over one decode step's and one prefill step's projections (device
   time beside the bound, and the 16-bit variant's bf16 ``torch.matmul``
   over the same shapes as a yardstick of another function), prints each
   shape's plan, holds two calls bit-equal, and times the replay's
   prefill projections.  The paged decode's
   sweep runs every q/pool dtype pair and masking mode, rows with
   nothing visible, and holds it to the dense kernel too.
3. Serves the serving benchmark's three tenants, tinyllama-1.1b,
   mamba2-780m and gemma2-2b, at full width (random weights from seeds)
   through ``EdgeServer.build(ServingConfig(executor="real"))``:
   eighteen requests alternating across the tenants through the Batcher,
   prompts of 4-12 tokens, 8 new tokens each.  Contention forces an 8-bit
   variant onto the card.  The kernels' launch counts are zeroed just
   before and read just after; each must be above zero.
4. Checks each served model: the card's prefill logits (and, for the
   8-bit variants, greedy tokens) against the plain versions on the host,
   and profiles one ``generate`` per tenant and variant.
5. The paged decode's path, over real decode caches: tinyllama-1.1b
   (8-bit, 4 prompts of 1024 tokens) and gemma2-2b (16-bit, 2 prompts of
   4200, past its 4096-token window) prefill on the card and take
   REPLAY_STEPS greedy steps densely, then again with every layer's
   decode read through ``paginate_kv`` pages (16 and 128 rows) and
   ``paged_decode_attention``: every layer's output equal to the dense
   kernel's bit for bit, equal greedy ids.  Its launch count is zeroed
   just before and read just after.  Times one layer's call (dense,
   paged, SDPA; device time, share of the bound, the split plan) and one
   decode step on the bf16 cache against the int8 cache.
6. The int8 KV cache and the ``uniform_pos`` decode of both attention
   tenants at the serving batch, on the card against the host's plain
   run from the same inputs, by step 4's rules.
7. Prints the kernels as one JSON line, the card, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA device, or without
the repository's ``src/repro_torch`` beside this file, it exits non-zero
before printing any result.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense FLOP/s
TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}  # tests/test_kernels.py
# A prefill row over thousands of keys averages them to outputs near 3e-2
# (about sqrt(e / keys) for N(0, 1) inputs), so the bf16 tolerance above
# cannot fail a wrong kernel there: every attention row is also held to
# this l2 error relative to the plain output.
FLASH_REL_TOL = 1e-2
QMM_TOL = 2e-4

# The sweeps of tests/test_kernels.py.
FLASH_SWEEP = [(1, 64, 4, 4, 32), (2, 160, 8, 4, 64), (1, 257, 6, 2, 128),
               (2, 128, 25, 5, 64)]
FLASH_MODES = [{}, dict(window=32), dict(softcap=20.0),
               dict(window=16, prefix=8),
               dict(window=32, softcap=50.0, prefix=4), dict(q_offset=64)]
DECODE_SWEEP = [(2, 300, 8, 4, 64), (1, 64, 4, 4, 32), (3, 1000, 14, 2, 64)]
DECODE_MODES = [{}, dict(window=64), dict(softcap=30.0),
                dict(window=32, prefix=8)]
PAGED_SWEEP = [(2, 300, 8, 4, 64, 128), (3, 96, 4, 2, 32, 16),
               (1, 64, 4, 4, 32, 64)]  # tests/test_kernels.py
DTYPE_PAIRS = [(torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32)]
QMM_SWEEP = [(64, 256, 128, 128, 8), (100, 384, 200, 128, 8),
             (32, 128, 64, 32, 4), (8, 512, 512, 512, 8)]
SSD_SWEEP = [(1, 64, 2, 16, 1, 8), (2, 96, 4, 32, 2, 16),
             (1, 50, 2, 16, 1, 8), (2, 128, 48, 64, 1, 128)]
SSD_TOL = 2e-4  # tests/test_kernels.py's chunked-vs-sequential tolerance

# The main path: the serving benchmark's three tenants, batches of up to
# 4, prompts up to 12 tokens, 8 new tokens.
ARCHS = ("tinyllama-1.1b", "mamba2-780m", "gemma2-2b")
MAX_BATCH, MAX_PROMPT, MAX_NEW, REQUESTS = 4, 12, 8, 18
GENERATE_RUNS = 5  # unprofiled generate walls per tenant and variant
LONG_PROMPT = 2048  # a long mamba2 prefill: the scan bound by operations

# The paged decode's path: real decode caches of the two attention
# tenants, (arch, variant bits, batch, prompt length); gemma2's prompt
# runs past its local layers' 4096-token window.
REPLAY = (("tinyllama-1.1b", 8, 4, 1024), ("gemma2-2b", 16, 2, 4200))
REPLAY_STEPS = 3
PAGE_SIZES = (16, 128)
# The int8 KV cache and the deferred (uniform_pos) write: (arch, bits).
CACHE_LAYOUTS = (("tinyllama-1.1b", 8), ("gemma2-2b", 16))


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(what: str, got, want, rtol: float, atol: float) -> float:
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max "
                             f"abs err {float(err.max()):.3g}")
    return float(err.max())


def rand(g, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def plan_text(plan) -> str:
    """A decode call's split plan (``ops.split_plan``) in words."""
    return (f"splits of {plan.split} rows x {plan.splits}, tiles of "
            f"{plan.tile}, {plan.blocks} blocks"
            + (" + combine" if plan.splits > 1 else ""))


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def attn_main_shapes(cfgs):
    """(label, H, KV, D, kwargs) of each attention tenant's main path."""
    out = []
    for cfg in cfgs:
        if not cfg.uses_attention:
            continue
        kw = {}
        if cfg.sliding_window:
            kw["window"] = cfg.sliding_window
        if cfg.attn_logit_softcap:
            kw["softcap"] = cfg.attn_logit_softcap
        out.append((cfg.name, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim, kw))
    return out


def check_flash(ops, ref, g, cfgs) -> dict:
    worst = 0.0
    n = 0
    for (B, S, H, KV, D) in FLASH_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (rand(g, B, S, n_, D, dtype=dt) for n_ in (H, KV, KV))
            for kw in FLASH_MODES:
                worst = max(worst, compare(
                    f"flash_attention {B, S, H, KV, D} {dt} {kw}",
                    ops.flash_attention(q, k, v, **kw),
                    ref.flash_attention(q, k, v, **kw), TOL[dt], TOL[dt]))
                n += 1
    # Main path.  SDPA has neither softcap nor window: it times the same
    # shapes causal, a yardstick of a nearby function.
    first = f"main {cfgs[0].name}", torch.float32
    for what, B, S, H, KV, D, dt, kw in flash_main_rows(cfgs):
        iters = dict(iters=5, plain_iters=1) if S > MAX_PROMPT else {}
        r = flash_row(ops, ref, g, what, B, S, H, KV, D, dt, kw, **iters)
        if (what, dt) == first:
            row = r
        n += 1
        torch.cuda.empty_cache()
    print(f"flash_attention: {n} cases within tolerance (f32 "
          f"{TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}); sweep max abs "
          f"err {worst:.3g}")
    return row


def flash_main_rows(cfgs) -> list:
    """(what, B, S, H, KV, D, dtype, kwargs) of the main path's prefill
    attention: a full batch of the longest prompts, bf16 (16-bit variant)
    and f32 (8-bit), for each attention tenant (gemma2: D=256 with its
    window and softcap); then the replay's long prefills, a windowed
    model's local and global layers.  ``cfgs`` in the order of ARCHS."""
    out = [(f"main {label}", MAX_BATCH, MAX_PROMPT, H, KV, D, dt, kw)
           for label, H, KV, D, kw in attn_main_shapes(cfgs)
           for dt in (torch.bfloat16, torch.float32)]
    for arch, bits, B, S in REPLAY:
        cfg = cfgs[ARCHS.index(arch)]
        dt = torch.float32 if bits == 8 else torch.bfloat16
        cap = dict(softcap=cfg.attn_logit_softcap) \
            if cfg.attn_logit_softcap else {}
        kws = [dict(cap, window=cfg.sliding_window), cap] \
            if cfg.sliding_window else [cap]
        out += [(f"replay prefill {arch} {bits}-bit", B, S, cfg.num_heads,
                 cfg.num_kv_heads, cfg.resolved_head_dim, dt, kw)
                for kw in kws]
    return out


def visible_pairs(S: int, T: int, window: int) -> int:
    """(query, key) pairs a causal prefill reads: key t <= position p, and
    inside the window when there is one."""
    p = np.arange(S)
    lo = np.maximum(0, p - window + 1) if window else np.zeros_like(p)
    return int(np.sum(np.minimum(p + 1, T) - np.minimum(lo, T)))


def flash_row(ops, ref, g, what, B, S, H, KV, D, dt, kw, iters=50,
              plain_iters=50) -> dict:
    """One prefill call held to the plain version (element-wise and by
    relative l2 error) and timed: the kernel's event and device time, the
    plain version's, SDPA's device time (causal, no softcap or window),
    and the bound (bytes of q, k, v and out; 4 D operations a visible
    (query, key) pair at the peak of dt)."""
    q, k, v = (rand(g, B, S, n_, D, dtype=dt) for n_ in (H, KV, KV))
    got = ops.flash_attention(q, k, v, **kw).float()
    want = ref.flash_attention(q, k, v, **kw).float()
    err = compare(f"flash_attention {what} {dt} {kw}", got, want, TOL[dt],
                  TOL[dt])
    rel = past = rel_l2(got, want)
    w = kw.get("window", 0)
    windowed = bool(w) and S > w
    if windowed:
        # Only the rows past the window see it: the check there must fail
        # the plain version without the window, as it would a kernel that
        # ignored it.
        past = rel_l2(got[:, w:], want[:, w:])
        blind = ref.flash_attention(q, k, v, **{a: b for a, b in kw.items()
                                                if a != "window"}).float()
        if rel_l2(blind[:, w:], want[:, w:]) <= FLASH_REL_TOL:
            raise AssertionError(f"flash_attention {what} {dt} {kw}: the "
                                 "rows past the window cannot tell it")
        del blind
    if max(rel, past) > FLASH_REL_TOL:
        raise AssertionError(f"flash_attention {what} {dt} {kw}: relative "
                             f"l2 err {rel:.3g}, past the window {past:.3g}"
                             f" (tol {FLASH_REL_TOL})")
    del got, want
    esz = q.element_size()
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * esz
    ops_ = 4 * B * H * D * visible_pairs(S, S, kw.get("window", 0))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    row = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw), iters=iters),
        plain_ms=time_ms(lambda: ref.flash_attention(q, k, v, **kw),
                         iters=plain_iters, warmup=1),
        library_ms=kernel_ms(sdpa), **bound(nbytes, ops_, dt))
    row["device_ms"] = kernel_ms(lambda: ops.flash_attention(q, k, v, **kw))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = ops.flash_plan(B, S, S, H, KV, D, dt, sms)
    print(f"  {what} ({B}, {S}, {H}/{KV} heads, D={D}"
          f"{', ' + str(kw) if kw else ''}) {dt}: kernel {row['ms']:.4f} ms "
          f"(event), device {row['device_ms']:.4f} ms "
          f"({row['bound_ms'] / row['device_ms']:.1%} of the bound), plain "
          f"{row['plain_ms']:.4f} ms, sdpa device {row['library_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}), max abs "
          f"err {err:.3g}, relative l2 err {rel:.3g}"
          f"{f' ({past:.3g} past the window)' if windowed else ''}"
          f"; plan: {p.bq} positions x {p.heads} head(s) a "
          f"block, tiles of {p.bk} keys, {p.stages} stage(s), {p.blocks} "
          f"blocks, {p.smem} B shared, {p.sm_blocks} an SM")
    return row


def check_decode(ops, ref, g, cfgs) -> dict:
    worst = 0.0
    n = 0
    for (B, T, H, KV, D) in DECODE_SWEEP:
        for qdt, kvdt in DTYPE_PAIRS:
            q = rand(g, B, H, D, dtype=qdt)
            k, v = rand(g, B, T, KV, D, dtype=kvdt), rand(g, B, T, KV, D,
                                                          dtype=kvdt)
            lens = torch.randint(1, T, (B,), generator=g, device="cuda",
                                 dtype=torch.int32)
            tol = TOL[torch.bfloat16 if torch.bfloat16 in (qdt, kvdt)
                      else torch.float32]
            for kw in DECODE_MODES:
                worst = max(worst, compare(
                    f"decode_attention {B, T, H, KV, D} {qdt}/{kvdt} {kw}",
                    ops.decode_attention(q, k, v, lens, **kw),
                    ref.decode_attention(q, k, v, lens, **kw), tol, tol))
                n += 1
    # Main path: the last decode step of a full batch, f32 query (8-bit
    # variant) and bf16 query (16-bit) against the bf16 cache; lengths as
    # a batch of ragged prompts leaves them.  For each attention tenant.
    B = MAX_BATCH
    T = MAX_PROMPT + MAX_NEW
    lens = torch.tensor([T, T - 3, T - 5, T - 8], dtype=torch.int32,
                        device="cuda")
    rows = {}
    print_rows = []
    for label, H, KV, D, kw in attn_main_shapes(cfgs):
        k = rand(g, B, T, KV, D, dtype=torch.bfloat16)
        v = rand(g, B, T, KV, D, dtype=torch.bfloat16)
        for qdt in (torch.bfloat16, torch.float32):
            q = rand(g, B, H, D, dtype=qdt)
            tol = TOL[torch.bfloat16]  # the cache is bf16
            err = compare(f"decode_attention main {label} {qdt}/bf16",
                          ops.decode_attention(q, k, v, lens, **kw),
                          ref.decode_attention(q, k, v, lens, **kw), tol, tol)
            n += 1
            visible = int(lens.sum())
            nbytes = (2 * q.numel() * q.element_size()
                      + 2 * visible * KV * D * k.element_size() + 4 * B)
            ops_ = 4 * visible * (H // KV) * KV * D
            # SDPA takes one dtype: the query cast to the cache's, a key
            # mask (and no softcap).
            mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None]
                    )[:, None, None, :]
            q4, kt, vt = q.to(k.dtype)[:, :, None, :], k.transpose(1, 2), \
                v.transpose(1, 2)
            row = dict(
                max_abs_err=err,
                ms=time_ms(lambda: ops.decode_attention(q, k, v, lens, **kw)),
                plain_ms=time_ms(lambda: ref.decode_attention(q, k, v, lens,
                                                              **kw)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q4, kt, vt, attn_mask=mask, enable_gqa=True)),
                **bound(nbytes, ops_, qdt))
            rows[label, qdt] = row
            dev = kernel_ms(lambda: ops.decode_attention(q, k, v, lens, **kw))
            print_rows.append((f"{label} B={B} T={T} H={H} KV={KV} D={D}"
                               f"{' ' + str(kw) if kw else ''} q {qdt}/cache "
                               "bf16", row, dev,
                               ops.split_plan(B, H, KV, D, k.dtype, T)))
    print(f"decode_attention: {n} cases within tolerance; sweep max abs err "
          f"{worst:.3g}")
    for what, r, dev, plan in print_rows:
        print(f"  main {what}: kernel {r['ms']:.4f} ms (device {dev:.4f} ms, "
              f"{r['bound_ms'] / dev:.1%} of the bound; {plan_text(plan)}), "
              f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), max abs err "
              f"{r['max_abs_err']:.3g}")
    return rows[cfgs[0].name, torch.float32]


def check_paged(ops, ref, g) -> None:
    """The paged decode on test_kernels.py's sweep, every q/pool dtype
    pair and masking mode: against its plain version, and against the
    dense kernel on the same logical cache (the largest difference is
    recorded; one body serves both layouts).  Then rows with nothing
    visible (lengths == 0), against the plain version only (it averages
    the gathered rows, which are not the dense cache's)."""
    worst = worst_dense = 0.0
    n = 0
    for (B, T, H, KV, D, ps) in PAGED_SWEEP:
        for qdt, kvdt in DTYPE_PAIRS:
            q = rand(g, B, H, D, dtype=qdt)
            k, v = (rand(g, B, T, KV, D, dtype=kvdt) for _ in range(2))
            lens = torch.randint(1, T, (B,), generator=g, device="cuda",
                                 dtype=torch.int32)
            pages = ops.paginate_kv(k, v, lens, ps)
            tol = TOL[torch.bfloat16 if torch.bfloat16 in (qdt, kvdt)
                      else torch.float32]
            for kw in DECODE_MODES:
                what = f"paged_decode_attention {B, T, H, KV, D, ps} " \
                       f"{qdt}/{kvdt} {kw}"
                got = ops.paged_decode_attention(q, *pages, lens, **kw)
                worst = max(worst, compare(
                    what, got, ref.paged_decode_attention(q, *pages, lens,
                                                          **kw), tol, tol))
                worst_dense = max(worst_dense, compare(
                    what + " vs dense kernel", got,
                    ops.decode_attention(q, k, v, lens, **kw), tol, tol))
                n += 1
            empty = torch.zeros_like(lens)
            empty[1:] = lens[1:]
            epages = ops.paginate_kv(k, v, empty, ps)
            worst = max(worst, compare(
                f"paged_decode_attention {B, T, H, KV, D, ps} {qdt}/{kvdt} "
                "lengths[0] == 0",
                ops.paged_decode_attention(q, *epages, empty),
                ref.paged_decode_attention(q, *epages, empty), tol, tol))
            n += 1
    # The serving decode's shape (tinyllama's last step, f32 query, bf16
    # cache, 16-row pages), paged against dense.
    B, T, H, KV, D = MAX_BATCH, MAX_PROMPT + MAX_NEW, 32, 4, 64
    q = rand(g, B, H, D)
    k, v = (rand(g, B, T, KV, D, dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor([T, T - 3, T - 5, T - 8], dtype=torch.int32,
                        device="cuda")
    pages = ops.paginate_kv(k, v, lens, 16)
    paged = time_ms(lambda: ops.paged_decode_attention(q, *pages, lens))
    dense = time_ms(lambda: ops.decode_attention(q, k, v, lens))
    print(f"paged_decode_attention: {n} cases within tolerance (f32 "
          f"{TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}); sweep max abs "
          f"err {worst:.3g}; max abs diff from the dense kernel on the same "
          f"cache {worst_dense:.3g}; at the serving decode shape (B={B}, "
          f"T={T}, H={H}, KV={KV}, D={D}, page size 16): paged {paged:.4f} ms"
          f", dense {dense:.4f} ms")


def visible(lens, T: int, window: int, prefix: int) -> np.ndarray:
    """(B, T) mask of the keys a decode reads: before each row's length,
    inside the window or the prefix."""
    t = np.arange(T)[None, :]
    lens = np.asarray(lens)[:, None]
    vis = t < lens
    if window:
        vis &= (t >= lens - window) | (t < prefix)
    return vis


def ssd_inputs(g, B, S, H, P, G, N, dtype):
    """x, dt (positive), A (negative), Bm, Cm, D and an initial state,
    drawn as tests/test_kernels.py draws them."""
    x = rand(g, B, S, H, P, scale=0.5).to(dtype)
    dt = F.softplus(rand(g, B, S, H)).to(dtype)
    A = -torch.exp(rand(g, H, scale=0.5))
    Bm = rand(g, B, S, G, N, scale=0.3).to(dtype)
    Cm = rand(g, B, S, G, N, scale=0.3).to(dtype)
    D = rand(g, H)
    init = rand(g, B, H, P, N, scale=0.5)
    return x, dt, A, Bm, Cm, D, init


def ssd_work(B, S, H, P, G, N, esz, with_init):
    """(bytes, operations) of one scan: x, dt, B, C read and y written
    once, the state written (and read, with an initial state); and the
    least arithmetic any form of the scan needs, whatever its chunk: per
    (token, head) the state's update by x B^T and its read-out by C, P N
    multiply-adds each, and the skip term D x, P of them (2 operations a
    multiply-add).  A chunked form adds its q^2 terms to this."""
    nbytes = (2 * B * S * H * P + B * S * H + 2 * B * S * G * N) * esz \
        + 4 * B * H * P * N * (2 if with_init else 1)
    return nbytes, B * S * H * (4 * P * N + 2 * P)


def check_ssd(ops, ref, g, cfg) -> dict:
    """The scan against the sequential oracle: the sweeps in f32 and bf16,
    with and without an initial state, y and the final state; then the
    main path's shapes, timed (the plain version is the chunked form at
    the model's chunk, the CPU path of ``ops.ssd_scan``)."""
    worst_y = worst_s = 0.0
    n = 0

    def one(what, shape, dt, with_init):
        x, dt_, A, Bm, Cm, D, init = ssd_inputs(g, *shape, dt)
        init = init if with_init else None
        y, state = ops.ssd_scan(x, dt_, A, Bm, Cm, D, init_state=init,
                                return_state=True)
        y_only = ops.ssd_scan(x, dt_, A, Bm, Cm, D, init_state=init)
        want_y, want_s = ref.ssd_scan(x, dt_, A, Bm, Cm, D, init_state=init,
                                      return_state=True)
        tol = SSD_TOL if dt == torch.float32 else TOL[dt]
        ey = compare(f"ssd_scan {what} {shape} {dt} init={with_init} y", y,
                     want_y, tol, tol)
        es = compare(f"ssd_scan {what} {shape} {dt} init={with_init} state",
                     state, want_s, SSD_TOL, SSD_TOL)
        if not torch.equal(y_only, y):
            raise AssertionError(f"ssd_scan {shape}: y differs without "
                                 "return_state")
        return ey, es, (x, dt_, A, Bm, Cm, D)

    for shape in SSD_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            for with_init in (False, True):
                ey, es, _ = one("sweep", shape, dt, with_init)
                worst_y, worst_s = max(worst_y, ey), max(worst_s, es)
                n += 1
    rows = {}
    for label, shape, dt in ssd_main_rows(cfg):
        ey, es, args = one("main", shape, dt, False)
        n += 1
        nbytes, ops_ = ssd_work(*shape, args[0].element_size(), False)
        rows[label, dt] = r = dict(
            max_abs_err=ey, state_err=es,
            ms=time_ms(lambda: ops.ssd_scan(*args, return_state=True),
                       iters=20),
            plain_ms=time_ms(lambda: ref.ssd_scan_chunked(
                *args, chunk=cfg.ssm_chunk, return_state=True), iters=5),
            library_ms=None,
            **bound(nbytes, ops_, torch.float32))  # f32 arithmetic
        r["device_ms"] = kernel_ms(
            lambda: ops.ssd_scan(*args, return_state=True))
        plan = ops.ssd_plan(*shape, dt)
        print(f"  main {label} {shape} {dt}: kernel {r['ms']:.4f} ms "
              f"(event), device {r['device_ms']:.4f} ms "
              f"({r['bound_ms'] / r['device_ms']:.1%} of the bound), "
              f"plain (chunked, chunk {cfg.ssm_chunk}) "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}; {nbytes / 1e6:.2f} MB, "
              f"{ops_ / 1e9:.3f} GFLOP, the recurrence's), max abs err y "
              f"{ey:.3g} state {es:.3g}; plan: "
              f"chunk {plan.kq}, clusters of {plan.cluster}, "
              f"{plan.stages} stage(s), {plan.blocks} blocks, "
              f"{plan.smem} B shared, {plan.sm_blocks} an SM")
    print(f"ssd_scan: {n} cases within tolerance (y: f32 {SSD_TOL}, bf16 "
          f"{TOL[torch.bfloat16]}; state {SSD_TOL}); sweep max abs err y "
          f"{worst_y:.3g}, state {worst_s:.3g}")
    row = dict(rows["serving prefill", torch.float32])
    del row["state_err"]
    return row


def ssd_main_rows(cfg) -> list:
    """(label, (B, S, H, P, G, N), dtype) of the main path's scans, for
    the SSM model ``cfg``: a serving prefill in f32 and bf16, and a
    LONG_PROMPT-token prompt in f32."""
    def shape(B, S):
        return (B, S, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                cfg.ssm_state)
    return [("serving prefill", shape(MAX_BATCH, MAX_PROMPT), torch.float32),
            ("serving prefill", shape(MAX_BATCH, MAX_PROMPT), torch.bfloat16),
            ("long prefill", shape(1, LONG_PROMPT), torch.float32)]


def layer_shapes(cfg):
    """name -> (K, N) of every per-layer projection of ``cfg``."""
    D = cfg.d_model
    if cfg.uses_ssm:
        di, GN = cfg.ssm_d_inner, cfg.ssm_ngroups * cfg.ssm_state
        return {"ssm_in": (D, 2 * di + 2 * GN + cfg.ssm_nheads),
                "ssm_out": (di, D)}
    F_, hd = cfg.d_ff, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    return {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
            "wo": (H * hd, D), "wg": (D, F_), "wu": (D, F_), "wd": (F_, D)}


def check_qmm(ops, ref, g, cfgs) -> dict:
    from repro_torch.kernels.quant_matmul import qmm_plan

    worst = 0.0
    n = 0
    for (M, K, N, group, bits) in QMM_SWEEP:
        wq, sc = ops.quantize_weights(rand(g, K, N), bits=bits, group=group)
        for dt in (torch.float32, torch.bfloat16):
            x = rand(g, M, K, dtype=dt)
            tol = QMM_TOL if dt == torch.float32 else TOL[dt]
            worst = max(worst, compare(
                f"quant_matmul {M, K, N, group, bits} {dt}",
                ops.quant_matmul(x, wq, sc), ref.quant_matmul(x, wq, sc),
                tol, tol))
            n += 1
    rows = {}
    for cfg in cfgs:
        # Main path: every projection of every layer at full width, int8
        # at group 32 as the 8-bit variant holds them (0.7-2.1 GB: no
        # decode step finds its weights in the 50 MB L2), and the same
        # weights in bf16 as the 16-bit variant holds them (the yardstick).
        shapes = layer_shapes(cfg)
        weights, w16 = [], []
        for _ in range(cfg.num_layers):
            for name, (K, N) in shapes.items():
                w = rand(g, K, N, scale=K ** -0.5)
                weights.append(ops.quantize_weights(w, bits=8, group=32))
                w16.append(w.bfloat16())
                del w
        main_err = 0.0
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for (K, N) in sorted(set(shapes.values())):
            wq, sc = next(w for w in weights if w[0].shape == (K, N))
            for M in (MAX_BATCH, MAX_BATCH * MAX_PROMPT):  # decode, prefill
                for dt in (torch.float32, torch.bfloat16):
                    x = rand(g, M, K, dtype=dt)
                    tol = QMM_TOL if dt == torch.float32 else TOL[dt]
                    got = ops.quant_matmul(x, wq, sc)
                    err = compare(f"quant_matmul main {cfg.name} {M, K, N} "
                                  f"{dt}", got, ref.quant_matmul(x, wq, sc),
                                  tol, tol)
                    if not torch.equal(got, ops.quant_matmul(x, wq, sc)):
                        raise AssertionError(
                            f"quant_matmul main {cfg.name} {M, K, N} {dt}: "
                            "two calls differ")
                    worst = max(worst, err)
                    if M == MAX_BATCH and dt == torch.float32:  # decode
                        main_err = max(main_err, err)
                    n += 1
                p = qmm_plan(M, K, N, 32, sms)
                blocks = (math.ceil(N / p.bn) * p.cluster
                          * math.ceil(M / p.m_chunk))
                print(f"  plan {cfg.name} {M, K, N}: BN {p.bn}, cluster "
                      f"{p.cluster}, rows {p.rows}, M chunk {p.m_chunk}, "
                      f"{p.threads} threads, {blocks} blocks; two calls "
                      "bit-equal")
        for M, what in ((MAX_BATCH, "decode"),
                        (MAX_BATCH * MAX_PROMPT, "prefill")):
            row = qmm_step(ops, ref, g, cfg, weights, w16, shapes, M, what,
                           main_err if what == "decode" else None)
            rows[cfg.name, what] = row
        del weights, w16
        torch.cuda.empty_cache()
    replay_prefill_qmm(ops, g, cfgs[0])
    print(f"quant_matmul: {n} cases within tolerance (f32 {QMM_TOL}, bf16 "
          f"{TOL[torch.bfloat16]}), two calls bit-equal at every main "
          f"shape; max abs err {worst:.3g} (bf16 outputs of magnitude ~10)")
    return rows[cfgs[0].name, "decode"]


def qmm_step(ops, ref, g, cfg, weights, w16, shapes, M, what, err) -> dict:
    """Times one step's projections (every layer's, f32 x of M rows)
    through the kernel, its plain version and, as a yardstick of another
    function (bf16 weights, twice the bytes), the 16-bit variant's
    ``torch.matmul``.  Prints the row and returns it."""
    xs = {K: rand(g, M, K) for K, _ in shapes.values()}
    xb = {K: v.bfloat16() for K, v in xs.items()}

    def step(fn):
        for wq, sc in weights:
            fn(xs[wq.shape[0]], wq, sc)

    def step16():
        for w in w16:
            torch.matmul(xb[w.shape[0]], w)

    nbytes = sum(wq.numel() + sc.numel() * 4 + 4 * M * (K + N)
                 for wq, sc in weights for K, N in [wq.shape])
    ops_ = sum(2 * M * wq.numel() for wq, _ in weights)
    if err is None:
        x, (wq, sc) = xs[weights[0][0].shape[0]], weights[0]
        err = compare(f"quant_matmul {what} {cfg.name}", ops.quant_matmul(
            x, wq, sc), ref.quant_matmul(x, wq, sc), QMM_TOL, QMM_TOL)
    iters = 20 if what == "decode" else 5
    row = dict(max_abs_err=err,
               ms=time_ms(lambda: step(ops.quant_matmul), iters=iters),
               plain_ms=time_ms(lambda: step(ref.quant_matmul), iters=3),
               library_ms=None, **bound(nbytes, ops_, torch.float32))
    before = ops.quant_matmul.launches
    wall, kern, counts = device_kernels(lambda: step(ops.quant_matmul))
    calls = (ops.quant_matmul.launches - before) // 2  # warm-up and run
    row["device_ms"] = sum(t for k, t in kern.items() if "qmm_" in k)
    # Kernels on the card in the profiled step: one qmm_ kernel a call and
    # nothing else (no reduction kernel, no copy, no memset).
    row["kernels_per_step"] = sum(counts.values())
    if (calls != len(weights) or row["kernels_per_step"] != len(weights)
            or any("qmm_" not in k for k in counts)):
        raise AssertionError(
            f"quant_matmul {what} {cfg.name}: {calls} calls of "
            f"{len(weights)} launched {dict(counts)}")
    row["host_us_per_call"] = host_us(lambda: step(ops.quant_matmul),
                                      len(weights))
    _, kern16, _ = device_kernels(step16)
    row["bf16_matmul_ms"] = sum(kern16.values())
    print(f"  main {cfg.name}: one {what} step's {len(weights)} projections "
          f"(M={M}, f32 x, int8 group 32, {nbytes / 1e9:.3f} GB, "
          f"{ops_ / 1e9:.1f} GFLOP): kernel {row['ms']:.4f} ms (event), "
          f"device {row['device_ms']:.4f} ms, plain {row['plain_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; device at "
          f"{100 * row['bound_ms'] / row['device_ms']:.1f}% of it); "
          f"profiled step wall {wall:.3f} ms, {row['kernels_per_step']} "
          f"kernels on the card; host {row['host_us_per_call']:.2f} us a "
          f"call; yardstick, a different "
          f"function: bf16 x @ bf16 weights (torch.matmul, twice the weight "
          f"bytes) {row['bf16_matmul_ms']:.4f} ms device; max abs err "
          f"{err:.3g}")
    return row


def replay_prefill_qmm(ops, g, cfg) -> None:
    """Device time of one tinyllama layer's projections at the replay's
    prefill (4 prompts of 1024 tokens, f32 x, int8 group 32)."""
    M = REPLAY[0][2] * REPLAY[0][3]
    layer = []
    for K, N in layer_shapes(cfg).values():
        wq, sc = ops.quantize_weights(rand(g, K, N, scale=K ** -0.5),
                                      bits=8, group=32)
        layer.append((rand(g, M, K), wq, sc))
    _, kern, _ = device_kernels(
        lambda: [ops.quant_matmul(*a) for a in layer])
    dev = sum(t for k, t in kern.items() if "qmm_" in k)
    ops_ = sum(2 * M * wq.numel() for _, wq, _ in layer)
    print(f"  replay prefill {cfg.name} (M={M}), one layer's "
          f"{len(layer)} projections: device {dev:.4f} ms, f32 operations "
          f"bound {ops_ / PEAK_OPS[torch.float32] * 1e3:.4f} ms "
          f"({ops_ / 1e9:.1f} GFLOP)")


def kernel_ms(fn, reps: int = 9) -> float:
    """Device time of one call of ``fn`` (one kernel launch): CUDA events
    around the call, with a spin kernel queued just before, so that the
    call is enqueued while the card spins and the card never waits for
    the host between the two events.  The median of ``reps`` calls.  (The
    profiler recorded these single ctypes launches only now and then.)"""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, calls: int, reps: int = 9) -> float:
    """Host microseconds a launch of one call of ``fn`` (which makes
    ``calls`` launches) takes: the wall of ``fn`` alone, without waiting
    for the card, the median of ``reps`` runs, each begun on an idle
    card (the queue never fills, so no launch waits on the card)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return float(np.median(times))


def device_kernels(fn):
    """(wall ms, {kernel name: device ms}, {kernel name: count}) of one
    call of ``fn``, from the profiler's CUDA activity (kernels of every
    runtime in the process, the port's ctypes-loaded ones included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern = {e.key: e.self_device_time_total / 1e3 for e in dev}
    return wall, kern, {e.key: e.count for e in dev}


def rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm())


def bound(nbytes: float, ops_: float, dtype) -> dict:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops_ / PEAK_OPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
def serve(kernels) -> tuple:
    from repro_torch.serving import Batcher, Request
    from repro_torch.serving.api import (BatchingSpec, EdgeServer,
                                         ServingConfig, TenantSpec)

    t0 = time.perf_counter()
    srv = EdgeServer.build(ServingConfig(
        executor="real",
        tenants=tuple(TenantSpec(a, reduced=False) for a in ARCHS),
        kv_headroom_shape=(MAX_BATCH, 32),
        batching=BatchingSpec(max_batch=MAX_BATCH)), device="cuda")
    print(f"main path: built {len(ARCHS)} full-width tenants in "
          f"{time.perf_counter() - t0:.1f} s; budget {srv.budget_mb:.1f} MB; "
          + "; ".join(f"{n}: " + ", ".join(f"{v.bits}b={v.size_mb:.1f}MB"
                                          for v in t.zoo.variants)
                      for n, t in srv.tenants.items()))
    names = list(srv.tenants)
    rng = np.random.default_rng(0)
    batcher = Batcher(max_batch=MAX_BATCH)
    results = []
    for fn in kernels.values():
        fn.launches = 0
    now = 0.0
    for i in range(REQUESTS):
        name = names[i % len(names)]
        vocab = srv.tenants[name].cfg.vocab_size
        plen = int(rng.integers(4, MAX_PROMPT + 1))
        batcher.submit(Request(
            app=name, prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new=MAX_NEW, arrival_ms=now))
        now += float(rng.exponential(500.0))
        if batcher.pending() >= 6 or i == REQUESTS - 1:
            while (b := batcher.next_batch()) is not None:
                srv.predict_and_preload(now)
                r = srv.serve(b.app, b.prompts, b.max_new, now_ms=now)
                results.append((b, r))
    launches = {name: fn.launches for name, fn in kernels.items()}
    srv.engine.check_event_invariant()
    for b, r in results:
        print(f"  batch {b.app} x{len(b.requests)} prompt {b.prompts.shape[1]}"
              f": bits={r.bits} {'warm' if r.warm else 'cold'}"
              f"{' FAILED' if r.failed else ''} latency "
              f"{r.latency_s * 1e3:.1f} ms")
    stats = srv.stats()
    tokens = sum(len(b.requests) * b.max_new for b, r in results)
    busy = sum(r.latency_s for _, r in results)
    print(f"main path: {stats.requests} requests, warm ratio "
          f"{stats.warm_ratio:.3f}, fail ratio {stats.fail_ratio:.3f}, "
          f"{tokens} tokens in {busy:.3f} s of service = "
          f"{tokens / busy:.1f} tokens/s; launches {launches}")
    if stats.requests != REQUESTS or any(r.failed for _, r in results):
        raise AssertionError("not every request was served")
    if {b.app for b, _ in results} != set(names):
        raise AssertionError("a tenant served no batch")
    if not any(r.bits == 8 for _, r in results):
        raise AssertionError("no batch ran at 8 bits")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    for name in names:
        t0 = time.perf_counter()
        check_outputs(srv.tenants[name])
        print(f"checked {name} in {time.perf_counter() - t0:.1f} s")
    return launches, srv


def check_outputs(tr) -> None:
    """The served model on the card against the plain versions on the
    host, for a small prompt batch: prefill logits (relative L2 error) and,
    for the 8-bit variant, greedy tokens; then one profiled ``generate``
    of a full batch per variant."""
    from repro_torch.models import transformer as T
    from repro_torch.quant.quantize import tree_map
    from repro_torch.serving.server import _generate_tokens

    cfg = tr.cfg
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    for bits, rel_tol in ((8, QMM_TOL), (16, TOL[torch.bfloat16])):
        tr.set_variant(tr.zoo.by_bits(bits))
        dev_tok = torch.from_numpy(prompts).cuda()
        with torch.inference_mode():
            got, _ = T.prefill(cfg, tr.device_params, {"tokens": dev_tok},
                               max_len=12)
            want, _ = T.prefill(cfg, tr.host[bits],
                                {"tokens": torch.from_numpy(prompts)},
                                max_len=12)
            got = got.cpu()
            if not torch.isfinite(got).all() or got.shape != want.shape:
                raise AssertionError(f"{cfg.name} {bits}-bit logits "
                                     "malformed")
            rel = rel_l2(got, want)
            line = (f"check {cfg.name} {bits}-bit: prefill logits "
                    f"{tuple(got.shape)} rel L2 err {rel:.3g} (tol {rel_tol})")
            if rel > rel_tol and bits == 16:
                # bf16 rounds at other points on the card than on the host
                # (cuBLAS against the CPU's products, the kernels' sums),
                # and a deep stack can carry that further than the bf16
                # tolerance.  Then hold the card to the plain version's own
                # error: both against the same weights evaluated in f32.
                exact, _ = T.prefill(
                    cfg, tree_map(lambda _, t: t.float() if
                                  t.is_floating_point() else t, tr.host[16]),
                    {"tokens": torch.from_numpy(prompts)}, max_len=12)
                card_err, plain_err = rel_l2(got, exact), rel_l2(want, exact)
                line += (f"; against the f32 evaluation: card {card_err:.3g},"
                         f" plain {plain_err:.3g} (tol 2x plain)")
                if card_err > 2 * plain_err:
                    raise AssertionError(line)
            elif rel > rel_tol:
                raise AssertionError(line)
            if bits == 8:
                ids = _generate_tokens(cfg, tr.device_params, dev_tok,
                                       max_new=4, max_len=12).cpu()
                ids_ref = _generate_tokens(cfg, tr.host[bits],
                                           torch.from_numpy(prompts),
                                           max_new=4, max_len=12)
                if not torch.equal(ids, ids_ref):
                    raise AssertionError(f"{cfg.name}: greedy ids differ: "
                                         f"{ids.tolist()} vs "
                                         f"{ids_ref.tolist()}")
                line += f"; greedy ids {ids.tolist()} equal"
        print(line)
        batch = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (MAX_BATCH, MAX_PROMPT)).astype(np.int32)
        wall, kern, counts = device_kernels(
            lambda: tr.generate(batch, MAX_NEW))
        launched = sum(counts.values())
        busy = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        print(f"profile {cfg.name} {bits}-bit generate ({MAX_BATCH}x"
              f"{MAX_PROMPT} prompt, {MAX_NEW} new): wall {wall:.1f} ms, "
              f"device busy {busy:.1f} ms (idle share {1 - busy / wall:.3f}), "
              f"{launched} kernels launched; top kernels: "
              + "; ".join(f"{k[:50]} {t:.2f} ms" for k, t in top))
        walls = []
        for _ in range(GENERATE_RUNS):  # unprofiled
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.generate(batch, MAX_NEW)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"  {cfg.name} {bits}-bit generate wall, {GENERATE_RUNS} runs "
              f"unprofiled: median {np.median(walls):.1f} ms ("
              + ", ".join(f"{w:.1f}" for w in walls) + ")")
    tr.set_variant(None)


# ---------------------------------------------------------------------------
# Phase 5: the paged decode over real decode caches
# ---------------------------------------------------------------------------
def pages_read(vis: np.ndarray, ps: int) -> int:
    """Table entries the paged kernel reads: the pages holding visible
    keys (``vis`` from :func:`visible`), over all rows."""
    B, T = vis.shape
    NP = -(-T // ps)
    vis = np.pad(vis, ((0, 0), (0, NP * ps - T)))
    return int(vis.reshape(B, NP, ps).any(-1).sum())


def time_paged(ops, ref, arch, q, k, v, lens, kw) -> dict:
    """One layer's call at a tenant's last replay step: the paged kernel
    at each page size (event and device time), the dense kernel, the
    plain version, SDPA over the dense layout, and the bound."""
    B, H, D = q.shape
    _, T, KV, _ = k.shape
    window, prefix = kw.get("window", 0), kw.get("prefix", 0)
    vis = visible(lens.cpu().numpy(), T, window, prefix)
    n_vis = int(vis.sum())
    # SDPA takes one dtype: the query cast to the cache's, a key mask
    # (lengths and window; no softcap).
    t = torch.arange(T, device="cuda")[None, :]
    mask = t < lens[:, None]
    if window:
        mask &= (t >= lens[:, None] - window) | (t < prefix)
    q4, kt, vt = q.to(k.dtype)[:, :, None, :], k.transpose(1, 2), \
        v.transpose(1, 2)
    def sdpa():
        return F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask[:, None, None, :], enable_gqa=True)

    row = dict(
        dense_ms=time_ms(lambda: ops.decode_attention(q, k, v, lens, **kw)),
        library_ms=time_ms(sdpa), library_device_ms=kernel_ms(sdpa),
        dense_plan=ops.split_plan(B, H, KV, D, k.dtype, T))
    row["dense_device_ms"] = kernel_ms(
        lambda: ops.decode_attention(q, k, v, lens, **kw))
    dense = ops.decode_attention(q, k, v, lens, **kw)
    if not torch.equal(dense, ops.decode_attention(q, k, v, lens, **kw)):
        raise AssertionError(f"replay {arch}: two dense calls differ")
    for ps in PAGE_SIZES:
        pages = ops.paginate_kv(k, v, lens, ps)
        got = ops.paged_decode_attention(q, *pages, lens, **kw)
        if not (torch.equal(got, dense) and torch.equal(
                got, ops.paged_decode_attention(q, *pages, lens, **kw))):
            raise AssertionError(f"replay {arch}, page size {ps}: the paged "
                                 "call differs from the dense one or from "
                                 "itself")
        err = compare(f"replay {arch} paged vs plain, page size {ps}", got,
                      ref.paged_decode_attention(q, *pages, lens, **kw),
                      TOL[torch.bfloat16], TOL[torch.bfloat16])
        nbytes = (2 * n_vis * KV * D * k.element_size()
                  + 2 * q.numel() * q.element_size() + 4 * B
                  + 4 * pages_read(vis, ps))
        row[ps] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: ops.paged_decode_attention(q, *pages, lens,
                                                          **kw)),
            device_ms=kernel_ms(lambda: ops.paged_decode_attention(
                q, *pages, lens, **kw)),
            plain_ms=time_ms(lambda: ref.paged_decode_attention(
                q, *pages, lens, **kw), iters=10),
            plan=ops.split_plan(B, H, KV, D, k.dtype, pages[2].shape[1] * ps),
            **bound(nbytes, 4 * n_vis * H * D, q.dtype))
    return row


def step_time(fn) -> tuple:
    """(wall ms over 3 synchronized calls, device busy ms of one profiled
    call, its top kernels as text) of one decode step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 3
    _, kern, _ = device_kernels(fn)
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
    return wall, sum(kern.values()), "; ".join(
        f"{k[:50]} {t:.2f} ms" for k, t in top)


def replay(srv, ops, ref) -> tuple:
    """Each attention tenant's real decode cache, read through pages.

    Full width, the tenants' own weights: prefill a long batch on the
    card, then REPLAY_STEPS greedy decode steps twice from the same
    cache, once dense and once with a hook on ``ops.decode_attention``
    that pages every layer's cache with ``paginate_kv`` at each page
    size, runs ``ops.paged_decode_attention``, holds it to the dense
    kernel bit for bit and passes the paged result on down the layer.
    The greedy ids must be equal and the logits within the decode
    kernel's bf16 tolerance.  Then times one layer's call (with its split
    plan, its device time and its share of the bound), and one decode
    step on the bf16 cache against one on the same cache quantized to
    int8."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dense_fn = ops.decode_attention
    tol = TOL[torch.bfloat16]  # the caches are bf16
    rows = {}
    launches = 0
    for arch, bits, B, S in REPLAY:
        tr = srv.tenants[arch]
        cfg = tr.cfg
        tr.set_variant(tr.zoo.by_bits(bits))
        params = tr.device_params
        prompts = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits0, cache0 = T.prefill(cfg, params, {"tokens": prompts},
                                        max_len=S + REPLAY_STEPS + 1)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        calls = {}
        equal = [0]

        def hook(q, k_cache, v_cache, lengths, **kw):
            want = dense_fn(q, k_cache, v_cache, lengths, **kw)
            for ps in PAGE_SIZES:
                pages = ops.paginate_kv(k_cache, v_cache, lengths, ps)
                got = ops.paged_decode_attention(q, *pages, lengths, **kw)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"replay {arch} page size {ps}: paged differs from "
                        "dense by up to "
                        f"{float((got.float() - want.float()).abs().max())}")
                equal[0] += 1
            calls[kw.get("window", 0)] = (q, k_cache, v_cache, lengths, kw)
            return got

        def run(fn):
            cache = {n: t.clone() for n, t in cache0.items()}
            logits, out, ids = logits0, [], []
            ops.decode_attention = fn
            try:
                with torch.inference_mode():
                    for _ in range(REPLAY_STEPS):
                        ids.append(T.greedy_token(cfg, logits))
                        logits, cache = T.decode_step(cfg, params, cache,
                                                      ids[-1])
                        out.append(logits)
            finally:
                ops.decode_attention = dense_fn
            return torch.stack(out), torch.stack(ids), cache

        t0 = time.perf_counter()
        dense_logits, dense_ids, cache = run(dense_fn)
        ops.paged_decode_attention.launches = 0
        paged_logits, paged_ids, _ = run(hook)
        launches += ops.paged_decode_attention.launches
        torch.cuda.synchronize()
        t_steps = time.perf_counter() - t0
        if not torch.equal(dense_ids, paged_ids):
            raise AssertionError(f"replay {arch}: greedy ids differ: "
                                 f"{dense_ids.tolist()} vs "
                                 f"{paged_ids.tolist()}")
        logit_diff = compare(f"replay {arch} step logits", paged_logits,
                             dense_logits, tol, tol)
        row = {w: time_paged(ops, ref, arch, *c) for w, c in calls.items()}
        # One decode step at this context: the bf16 cache, and the same
        # cache quantized to int8 (the plain-PyTorch int8 path).
        tok = T.greedy_token(cfg, dense_logits[-1])
        qcache = {"lengths": cache["lengths"]}
        for n in ("k", "v"):
            qcache[n], qcache[n + "_scale"] = L.quantize_kv(cache[n])
        with torch.inference_mode():
            bf16_step = step_time(lambda: T.decode_step(cfg, params, cache,
                                                        tok))
            int8_step = step_time(lambda: T.decode_step(cfg, params, qcache,
                                                        tok))
        rows[arch] = row
        print(f"replay {arch} {bits}-bit, {B} x {S} prompt, "
              f"{REPLAY_STEPS} steps: prefill {t_prefill:.2f} s, dense and "
              f"paged steps {t_steps:.2f} s; greedy ids {dense_ids.tolist()} "
              f"equal; paged vs dense: layer outputs bit-equal in all "
              f"{equal[0]} paged calls, step logits max abs diff "
              f"{logit_diff:.3g}")
        for w, r in row.items():
            q, k = calls[w][0], calls[w][1]
            bnd = r[PAGE_SIZES[0]]["bound_ms"]
            print(f"  last step, layer with window {w} (B={B}, T="
                  f"{k.shape[1]}, H={q.shape[1]}, KV={k.shape[2]}, D="
                  f"{q.shape[2]}, q {q.dtype}/cache {k.dtype}): dense kernel "
                  f"{r['dense_ms']:.4f} ms (device {r['dense_device_ms']:.4f}"
                  f", {bnd / r['dense_device_ms']:.1%} of the bound; "
                  f"{plan_text(r['dense_plan'])}), sdpa "
                  f"{r['library_ms']:.4f} ms (device "
                  f"{r['library_device_ms']:.4f}); " + "; ".join(
                      f"paged ps {ps}: {r[ps]['ms']:.4f} ms (device "
                      f"{r[ps]['device_ms']:.4f}, "
                      f"{r[ps]['bound_ms'] / r[ps]['device_ms']:.1%} of the "
                      f"bound; {plan_text(r[ps]['plan'])}), plain "
                      f"{r[ps]['plain_ms']:.4f} ms, bound "
                      f"{r[ps]['bound_ms']:.6f} ms "
                      f"({r[ps]['bound_by']}), max abs err "
                      f"{r[ps]['max_abs_err']:.3g}" for ps in PAGE_SIZES))
        print(f"  one decode step at {S + REPLAY_STEPS} tokens: bf16 cache "
              f"wall {bf16_step[0]:.2f} ms (device busy {bf16_step[1]:.2f}"
              f" ms; top kernels: {bf16_step[2]}), int8 cache wall "
              f"{int8_step[0]:.2f} ms (device busy {int8_step[1]:.2f} ms; "
              f"top kernels: {int8_step[2]})")
        del cache0, cache, qcache, calls
        tr.set_variant(None)
        torch.cuda.empty_cache()
    want = REPLAY_STEPS * len(PAGE_SIZES) * sum(
        srv.tenants[a].cfg.num_layers for a, *_ in REPLAY)
    if launches != want:
        raise AssertionError(f"paged_decode_attention launched {launches} "
                             f"times in the replay, not {want}")
    first = rows[REPLAY[0][0]][0][PAGE_SIZES[0]]
    r = rows[REPLAY[0][0]][0]
    return launches, dict(max_abs_err=first["max_abs_err"], ms=first["ms"],
                          plain_ms=first["plain_ms"],
                          bound_ms=first["bound_ms"],
                          bound_by=first["bound_by"],
                          library_ms=r["library_ms"])


# ---------------------------------------------------------------------------
# Phase 6: the int8 KV cache and the deferred write, card against host
# ---------------------------------------------------------------------------
def card_decode(cfg, params, prompts, *, prefill_kw, step_kw):
    """Prefill and MAX_NEW greedy decode steps on the card: the logits and
    the greedy id of every step, and a host copy of the cache before each
    step and after the last."""
    from repro_torch.models import transformer as T

    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, {"tokens": prompts},
                                  max_len=MAX_PROMPT + MAX_NEW, **prefill_kw)
        out, ids = [logits], [T.greedy_token(cfg, logits)]
        states = []
        for _ in range(MAX_NEW):
            states.append({n: t.to("cpu", copy=True)
                           for n, t in cache.items()})
            logits, cache = T.decode_step(cfg, params, cache, ids[-1],
                                          **step_kw)
            out.append(logits)
            ids.append(T.greedy_token(cfg, logits))
        states.append({n: t.to("cpu", copy=True) for n, t in cache.items()})
    return torch.stack(out).cpu(), torch.stack(ids).cpu(), states


def host_decode(cfg, params, prompts, ids, states, *, prefill_kw, step_kw):
    """The host's plain run on the card's inputs: its prefill, then every
    decode step from the card's cache before that step and the card's
    token.  The steps do not depend on each other, so they run as one
    batch of MAX_NEW x B rows.  Returns the logits and greedy ids of every
    step, the host's cache after the prefill, and each step's written
    token's cache entries (``{name: (L, B, ...)}``; the deferred write of
    the stacked batch puts every row's token at the first step's
    position)."""
    from repro_torch.models import transformer as T

    B = prompts.shape[0]
    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, {"tokens": prompts},
                                  max_len=MAX_PROMPT + MAX_NEW, **prefill_kw)
        stacked = {n: torch.cat([st[n] for st in states[:MAX_NEW]],
                                dim=0 if n == "lengths" else 1)
                   for n in states[0]}
        tokens = ids[:MAX_NEW].reshape(MAX_NEW * B, *ids.shape[2:])
        steps, after = T.decode_step(cfg, params, stacked, tokens, **step_kw)
    out = torch.cat([logits[None], steps.reshape(MAX_NEW, B,
                                                 *steps.shape[1:])])
    pos = int(states[0]["lengths"][0])
    written = [{n: t[:, i * B:(i + 1) * B, pos] for n, t in after.items()
                if n != "lengths"} for i in range(MAX_NEW)]
    return out, torch.stack([T.greedy_token(cfg, t) for t in out]), cache, \
        written


def cache_gap(card, host, bits: int) -> tuple:
    """Hold the cache the card wrote to the host's.  At 8 bits (f32
    activations): int8 k/v within one quantization step (a value near a
    rounding boundary may round either way), scales within 2e-4, a bf16
    cache within the bf16 tolerance.  At 16 bits the activations round at
    other points on the two sides, so the dequantized (or bf16) cache and
    the scales are held as relative L2 errors at the bf16 tolerance."""
    flips = total = 0
    worst = 0.0
    for n in ("k", "v"):
        got, want = card[n].float(), host[n].float()
        scaled = n + "_scale" in host
        if scaled:
            gs, ws = card[n + "_scale"], host[n + "_scale"]
            flips += int((card[n] != host[n]).sum())
            total += got.numel()
            if bits == 8:
                compare(f"{n} scales", gs, ws, QMM_TOL, QMM_TOL)
                err = (got * gs[..., None] - want * ws[..., None]).abs()
                if (err > ws[..., None] * 1.001 + 1e-12).any():
                    raise AssertionError(f"{n}: int8 cache beyond one "
                                         "quantization step of the host's")
                continue
            worst = max(worst, rel_l2(gs, ws))
            got, want = got * gs[..., None], want * ws[..., None]
        if bits == 8:
            compare(f"{n} cache", got, want, TOL[torch.bfloat16],
                    TOL[torch.bfloat16])
        else:
            worst = max(worst, rel_l2(got, want))
    if worst > TOL[torch.bfloat16]:
        raise AssertionError(f"cache rel L2 err {worst:.3g} past the bf16 "
                             "tolerance")
    return flips, total, worst


def gap_text(gaps, bits: int) -> str:
    flips, total = sum(g[0] for g in gaps), sum(g[1] for g in gaps)
    out = (f"{flips} of {total} int8 values differ from the host's"
           if total else "bf16")
    return out + (f", rel L2 err max {max(g[2] for g in gaps):.3g}"
                  if bits == 16 else ", each by one step at most" if total
                  else ", within 3e-2")


CACHE_MODES = (("int8 cache", dict(prefill_kw=dict(quantize_cache=True),
                                   step_kw={})),
               ("uniform_pos", dict(prefill_kw={},
                                    step_kw=dict(uniform_pos=True))))


def check_cache_layouts(srv) -> None:
    """For each attention tenant at the serving batch: the int8 KV cache
    (``prefill(quantize_cache=True)`` and MAX_NEW greedy steps), then the
    bf16 cache through ``decode_step(uniform_pos=True)``, on the card
    against the host's plain run from the same inputs (each step from the
    card's cache and token).  check_outputs's rules per step: 8-bit weights
    within 2e-4 relative L2 with equal greedy ids; 16-bit within 3e-2, or
    past that no further from the f32 evaluation of the same weights than
    twice the plain run.  The uniform_pos path rounds its softmax weights
    to the bf16 cache's type (as the reference does), so a weight on a
    rounding boundary may round the other way on the two sides: at 8 bits
    its logits are held to one bf16 step, 2^-8, not 2e-4.  The caches the
    two write are held to each other by ``cache_gap``."""
    for arch, bits in CACHE_LAYOUTS:
        tr = srv.tenants[arch]
        cfg = tr.cfg
        tr.set_variant(tr.zoo.by_bits(bits))
        prompts = torch.from_numpy(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (MAX_BATCH, MAX_PROMPT)).astype(np.int32))
        for mode, kw in CACHE_MODES:
            check_cache_layout(tr, bits, mode, kw, prompts)
        tr.set_variant(None)
    torch.cuda.empty_cache()


def check_cache_layout(tr, bits: int, mode: str, kw: dict,
                       prompts) -> None:
    """One tenant and cache layout of :func:`check_cache_layouts`."""
    from repro_torch.quant.quantize import tree_map

    cfg = tr.cfg
    t0 = time.perf_counter()
    got, ids, states = card_decode(cfg, tr.device_params, prompts.cuda(),
                                   **kw)
    t_card = time.perf_counter() - t0
    if not torch.isfinite(got).all():
        raise AssertionError(f"{cfg.name} {mode}: non-finite logits")
    t0 = time.perf_counter()
    want, host_ids, cache, written = host_decode(
        cfg, tr.host[bits], prompts, ids, states, **kw)
    t_host = time.perf_counter() - t0
    # The prefill's whole cache, then the token each step wrote (the
    # card's at the step's own position).
    pos = int(states[0]["lengths"][0])
    gaps = [cache_gap(states[0], cache, bits)] + [
        cache_gap({n: states[i + 1][n][:, :, pos + i] for n in w}, w,
                  bits) for i, w in enumerate(written)]
    rel = [rel_l2(g, w) for g, w in zip(got, want)]
    line = (f"check {cfg.name} {bits}-bit {mode}: prefill + {MAX_NEW} "
            f"steps on the card in {t_card:.2f} s, on the host in "
            f"{t_host:.1f} s; logits rel L2 err per step max "
            f"{max(rel):.3g}; prefill's cache: {gap_text(gaps[:1], bits)};"
            f" the tokens the steps wrote: {gap_text(gaps[1:], bits)}")
    if bits == 8:
        tol = QMM_TOL if mode == "int8 cache" else 2.0 ** -8
        line += f" (tol {tol:.3g})"
        if max(rel) > tol or not torch.equal(ids, host_ids):
            raise AssertionError(f"{line}; greedy ids {ids.tolist()} vs "
                                 f"{host_ids.tolist()}")
        line += "; greedy ids equal"
    elif max(rel) > TOL[torch.bfloat16]:
        # As check_outputs does: where a step is past the bf16
        # tolerance, card and plain run against the same weights
        # evaluated in f32 on the host.
        exact, *_ = host_decode(
            cfg, tree_map(lambda _, t: t.float() if
                          t.is_floating_point() else t, tr.host[16]),
            prompts, ids, states, **kw)
        card_err = [rel_l2(g, e) for g, e in zip(got, exact)]
        plain_err = [rel_l2(w, e) for w, e in zip(want, exact)]
        line += (f" (tol {TOL[torch.bfloat16]}); against the f32 "
                 f"evaluation: card max {max(card_err):.3g}, plain "
                 f"max {max(plain_err):.3g} (tol 2x plain at each "
                 "step past the bf16 tolerance)")
        if any(r > TOL[torch.bfloat16] and c > 2 * p
               for r, c, p in zip(rel, card_err, plain_err)):
            raise AssertionError(line)
    else:
        line += f" (tol {TOL[torch.bfloat16]})"
    print(line)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products reduce in f32 (cuBLAS's split-K may otherwise reduce
    # in bf16), as the host's plain versions do.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    name = card()
    print(f"card: {name}")
    print(f"kernels built in {build.build_all():.1f} s "
          f"({', '.join(build.KERNELS)})")

    g = torch.Generator(device="cuda").manual_seed(0)
    cfgs = [get_config(a) for a in ARCHS]
    t0 = time.perf_counter()
    rows = {"quant_matmul": check_qmm(ops, ref, g, cfgs),
            "decode_attention": check_decode(ops, ref, g, cfgs),
            "flash_attention": check_flash(ops, ref, g, cfgs),
            "ssd_scan": check_ssd(ops, ref, g, cfgs[1])}
    check_paged(ops, ref, g)
    torch.cuda.empty_cache()
    print(f"kernel checks took {time.perf_counter() - t0:.1f} s")

    kernels = {"quant_matmul": ops.quant_matmul,
               "decode_attention": ops.decode_attention,
               "flash_attention": ops.flash_attention,
               "ssd_scan": ops.ssd_scan}
    launches, srv = serve(kernels)
    t0 = time.perf_counter()
    launches["paged_decode_attention"], rows["paged_decode_attention"] = \
        replay(srv, ops, ref)
    print(f"replay took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_cache_layouts(srv)
    print(f"cache layout checks took {time.perf_counter() - t0:.1f} s")
    srv.close()

    replaces = {
        "quant_matmul": "src/repro/kernels/quant_matmul.py:102",
        "decode_attention": "src/repro/kernels/decode_attention.py:122",
        "flash_attention": "src/repro/kernels/flash_attention.py:124",
        "ssd_scan": "src/repro/kernels/ssd_scan.py:137",
        "paged_decode_attention": "src/repro/kernels/decode_attention.py:191"}
    out = [dict(name=k, route="cuda", source="src/repro_torch/csrc/"
                f"{'decode_attention' if k.startswith('paged') else k}.cu",
                replaces=replaces[k], launches=launches[k], **rows[k])
           for k in replaces]
    print(json.dumps({"kernels": out}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
