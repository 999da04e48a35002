#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (sm_90).

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   port's four Hopper kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   each, in parallel).
2. Holds each kernel against its plain PyTorch version on the card, at the
   sweep shapes of ``tests/test_kernels.py`` and at the main path's
   shapes (every projection of the three tenants; tinyllama's and
   gemma2's attention, D=256 with window and softcap for gemma2; mamba2's
   scan at a serving prefill and at a 2048-token prompt), and times
   kernel, plain version, the bound (bytes over 3.35 TB/s or operations
   over the peak rate of their type) and, for attention,
   ``scaled_dot_product_attention`` as a yardstick.
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
5. Prints the kernels as one JSON line, the card, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA device, or without
the repository's ``src/repro_torch`` beside this file, it exits non-zero
before printing any result.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
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
QMM_SWEEP = [(64, 256, 128, 128, 8), (100, 384, 200, 128, 8),
             (32, 128, 64, 32, 4), (8, 512, 512, 512, 8)]
SSD_SWEEP = [(1, 64, 2, 16, 1, 8), (2, 96, 4, 32, 2, 16),
             (1, 50, 2, 16, 1, 8), (2, 128, 48, 64, 1, 128)]
SSD_TOL = 2e-4  # tests/test_kernels.py's chunked-vs-sequential tolerance
SSD_CHUNK = 64  # the kernel's chunk (kQ in csrc/ssd_scan.cu)

# The main path: the serving benchmark's three tenants, batches of up to
# 4, prompts up to 12 tokens, 8 new tokens.
ARCHS = ("tinyllama-1.1b", "mamba2-780m", "gemma2-2b")
MAX_BATCH, MAX_PROMPT, MAX_NEW, REQUESTS = 4, 12, 8, 18
LONG_PROMPT = 2048  # a long mamba2 prefill: the scan bound by operations


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
    # Main path: prefill of a full batch of the longest prompts, f32
    # (8-bit variant) and bf16 (16-bit variant), for each attention tenant
    # (gemma2: D=256 with its window and softcap).  SDPA has no softcap:
    # for gemma2 it times the same shapes without it.
    rows = {}
    print_rows = []
    for label, H, KV, D, kw in attn_main_shapes(cfgs):
        B, S = MAX_BATCH, MAX_PROMPT
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (rand(g, B, S, n_, D, dtype=dt) for n_ in (H, KV, KV))
            err = compare(f"flash_attention main {label} {dt}",
                          ops.flash_attention(q, k, v, **kw),
                          ref.flash_attention(q, k, v, **kw), TOL[dt],
                          TOL[dt])
            n += 1
            esz = q.element_size()
            nbytes = (q.numel() * 2 + k.numel() + v.numel()) * esz
            pairs = B * H * S * (S + 1) // 2  # causal (query, key) pairs
            ops_ = 4 * pairs * D
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row = dict(
                max_abs_err=err,
                ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                plain_ms=time_ms(lambda: ref.flash_attention(q, k, v, **kw)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                **bound(nbytes, ops_, dt))
            rows[label, dt] = row
            print_rows.append((f"{label} ({B}, {S}, {H}/{KV} heads, D={D}"
                               f"{', ' + str(kw) if kw else ''}) {dt}", row))
    print(f"flash_attention: {n} cases within tolerance (f32 "
          f"{TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}); sweep max abs "
          f"err {worst:.3g}")
    for what, r in print_rows:
        print(f"  main {what}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), max abs err "
              f"{r['max_abs_err']:.3g}")
    return rows[cfgs[0].name, torch.float32]


def check_decode(ops, ref, g, cfgs) -> dict:
    worst = 0.0
    n = 0
    combos = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
    for (B, T, H, KV, D) in DECODE_SWEEP:
        for qdt, kvdt in combos:
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
            print_rows.append((f"{label} B={B} T={T} H={H} KV={KV} D={D}"
                               f"{' ' + str(kw) if kw else ''} q {qdt}/cache "
                               "bf16", row))
    print(f"decode_attention: {n} cases within tolerance; sweep max abs err "
          f"{worst:.3g}")
    for what, r in print_rows:
        print(f"  main {what}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), max abs err "
              f"{r['max_abs_err']:.3g}")
    return rows[cfgs[0].name, torch.float32]


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
    once, the state written (and read, with an initial state); the chunked
    form's 2q^2 N per (sequence, group, chunk) plus 2q^2 P + 4qPN per
    (sequence, head, chunk), over the kernel's chunks of q tokens."""
    nbytes = (2 * B * S * H * P + B * S * H + 2 * B * S * G * N) * esz \
        + 4 * B * H * P * N * (2 if with_init else 1)
    ops_ = 0
    for c0 in range(0, S, SSD_CHUNK):
        q = min(SSD_CHUNK, S - c0)
        ops_ += B * (2 * q * q * N * G + (2 * q * q * P + 4 * q * P * N) * H)
    return nbytes, ops_


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
    H, P, G, N = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                  cfg.ssm_state)
    rows = {}
    for label, B, S, dts in (("serving prefill", MAX_BATCH, MAX_PROMPT,
                              (torch.float32, torch.bfloat16)),
                             ("long prefill", 1, LONG_PROMPT,
                              (torch.float32,))):
        for dt in dts:
            shape = (B, S, H, P, G, N)
            ey, es, args = one("main", shape, dt, False)
            n += 1
            nbytes, ops_ = ssd_work(*shape, args[0].element_size(), False)
            rows[label, dt] = dict(
                max_abs_err=ey, state_err=es,
                ms=time_ms(lambda: ops.ssd_scan(*args, return_state=True),
                           iters=20),
                plain_ms=time_ms(lambda: ref.ssd_scan_chunked(
                    *args, chunk=cfg.ssm_chunk, return_state=True), iters=5),
                library_ms=None,
                **bound(nbytes, ops_, torch.float32))  # f32 arithmetic
            _, kern, _ = device_kernels(
                lambda: ops.ssd_scan(*args, return_state=True))
            dev = sum(t for k, t in kern.items() if "ssd_chunked" in k)
            print_shape = f"{label} {shape} {dt}"
            r = rows[label, dt]
            print(f"  main {print_shape}: kernel {r['ms']:.4f} ms (device "
                  f"{dev:.4f} ms in one profiled call), plain "
                  f"(chunked, chunk {cfg.ssm_chunk}) {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}; "
                  f"{nbytes / 1e6:.2f} MB, {ops_ / 1e9:.3f} GFLOP), max abs "
                  f"err y {ey:.3g} state {es:.3g}")
    print(f"ssd_scan: {n} cases within tolerance (y: f32 {SSD_TOL}, bf16 "
          f"{TOL[torch.bfloat16]}; state {SSD_TOL}); sweep max abs err y "
          f"{worst_y:.3g}, state {worst_s:.3g}")
    row = dict(rows["serving prefill", torch.float32])
    del row["state_err"]
    return row


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
        # decode step finds its weights in the 50 MB L2).
        shapes = layer_shapes(cfg)
        weights = []
        for _ in range(cfg.num_layers):
            for name, (K, N) in shapes.items():
                w = rand(g, K, N, scale=K ** -0.5)
                weights.append(ops.quantize_weights(w, bits=8, group=32))
        main_err = 0.0
        for (K, N) in set(shapes.values()):
            wq, sc = next(w for w in weights if w[0].shape == (K, N))
            for M in (MAX_BATCH, MAX_BATCH * MAX_PROMPT):  # decode, prefill
                for dt in (torch.float32, torch.bfloat16):
                    x = rand(g, M, K, dtype=dt)
                    tol = QMM_TOL if dt == torch.float32 else TOL[dt]
                    err = compare(f"quant_matmul main {cfg.name} {M, K, N} "
                                  f"{dt}", ops.quant_matmul(x, wq, sc),
                                  ref.quant_matmul(x, wq, sc), tol, tol)
                    worst = max(worst, err)
                    if M == MAX_BATCH and dt == torch.float32:  # decode
                        main_err = max(main_err, err)
                    n += 1
        xs = {K: rand(g, MAX_BATCH, K) for K, _ in shapes.values()}

        def step(fn):
            for wq, sc in weights:
                fn(xs[wq.shape[0]], wq, sc)

        nbytes = sum(wq.numel() + sc.numel() * 4 + 4 * MAX_BATCH * (K + N)
                     for wq, sc in weights for K, N in [wq.shape])
        ops_ = sum(2 * MAX_BATCH * wq.numel() for wq, _ in weights)
        row = dict(max_abs_err=main_err,
                   ms=time_ms(lambda: step(ops.quant_matmul), iters=20),
                   plain_ms=time_ms(lambda: step(ref.quant_matmul), iters=5),
                   library_ms=None, **bound(nbytes, ops_, torch.float32))
        wall, kern, _ = device_kernels(lambda: step(ops.quant_matmul))
        dev = sum(t for k, t in kern.items() if "qmm_" in k)
        rows[cfg.name] = row
        print(f"  main {cfg.name}: one decode step's {len(weights)} "
              f"projections (M={MAX_BATCH}, f32 x, int8 group 32, "
              f"{nbytes / 1e9:.3f} GB): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); profiled step: wall {wall:.3f} ms, qmm "
              f"kernels on the device {dev:.4f} ms; max abs err {main_err:.3g}"
              " at the decode shapes in f32")
        del weights
    print(f"quant_matmul: {n} cases within tolerance (f32 {QMM_TOL}, bf16 "
          f"{TOL[torch.bfloat16]}); max abs err {worst:.3g} (bf16 outputs "
          f"of magnitude ~10)")
    return rows[cfgs[0].name]


def device_kernels(fn):
    """(wall ms, {kernel name: device ms}, kernels launched) of one call
    of ``fn``, from the profiler's CUDA activity (kernels of every
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
    return wall, kern, sum(e.count for e in dev)


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
def serve(kernels) -> dict:
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
    srv.close()
    return launches


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
        wall, kern, launched = device_kernels(
            lambda: tr.generate(batch, MAX_NEW))
        busy = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        print(f"profile {cfg.name} {bits}-bit generate ({MAX_BATCH}x"
              f"{MAX_PROMPT} prompt, {MAX_NEW} new): wall {wall:.1f} ms, "
              f"device busy {busy:.1f} ms (idle share {1 - busy / wall:.3f}), "
              f"{launched} kernels launched; top kernels: "
              + "; ".join(f"{k[:50]} {t:.2f} ms" for k, t in top))
    tr.set_variant(None)


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
    torch.cuda.empty_cache()
    print(f"kernel checks took {time.perf_counter() - t0:.1f} s")

    kernels = {"quant_matmul": ops.quant_matmul,
               "decode_attention": ops.decode_attention,
               "flash_attention": ops.flash_attention,
               "ssd_scan": ops.ssd_scan}
    launches = serve(kernels)

    replaces = {
        "quant_matmul": "src/repro/kernels/quant_matmul.py:102",
        "decode_attention": "src/repro/kernels/decode_attention.py:122",
        "flash_attention": "src/repro/kernels/flash_attention.py:124",
        "ssd_scan": "src/repro/kernels/ssd_scan.py:137"}
    out = [dict(name=k, route="cuda", source=f"src/repro_torch/csrc/{k}.cu",
                replaces=replaces[k], launches=launches[k], **rows[k])
           for k in kernels]
    print(json.dumps({"kernels": out}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
