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
   variant onto the card.  A batch's key runs eagerly at its first call,
   as a CUDA graph captured at its second and replayed after (each
   batch's latency is marked so); each capture's graph pool is charged
   to its tenant, and the budget must hold at every event with the pools
   counted.  The wrappers' counts (zeroed just before, read just after)
   count eager calls and captures, each above zero; the kernels'
   launches, replays included, are counted by ``torch.profiler`` over
   the whole run.  Then every tenant is evicted through the loader: each
   pool's charge must have equalled the pool, and every pool, charge and
   ``used_mb`` must be back at 0.
4. Checks each served model: the card's prefill logits (and, for the
   8-bit variants, greedy tokens) against the plain versions on the host;
   then per variant one ``generate`` of a full batch eagerly
   (``_generate_tokens``) and as a graph: equal greedy ids, the ms of the
   first call of two keys (eager) and of their second (capture, replay),
   and for each a profiled run (its idle share; the replay's kernels on
   the card with no wrapper call, so all from the graph) and five
   unprofiled walls.
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
7. The full-sequence forward of each tenant at 16 and 8 bits on a
   FORWARD_BATCH of prompts, through ``quant_matmul`` (8 bits),
   ``flash_attention`` and ``ssd_scan``: all its logits against the
   plain versions' ``forward`` on the host, by step 4's rules, and its
   last position against the card's ``prefill`` logits (relative l2
   within 2e-4 at 8 bits, 3e-2 at 16); and ``fidelity`` of the 8-bit variant against the
   16-bit one (top-1 agreement, logit MSE), recorded, not gated.
8. The hybrid and MoE families: hymba-1.5b and olmoe-1b-7b at full width
   and depth (zoo (16, 8) at group 32) served together under their
   contended budget, each tenant's batches in turn with prompt lengths
   that repeat (eager first calls, captures, replays), the kernels'
   launches counted by the profiler; the pools charged and given back as
   in step 3; each tenant's prefill and decode-step logits held to the
   host's by step 4's rules, and step 4's ``generate`` check; hymba's
   2048-token prompt (2176 rows with its meta tokens) through
   ``forward``, every row and the rows past the window held to the host
   within 2e-4 at 8 bits, where a forward blind to the meta tokens'
   prefix must miss.  Then, at full width and cut in depth: llama4-scout
   (2 of 48 layers; top-1 routing and the shared expert) at 8 bits,
   prefill and three greedy steps held to the host's run from the card's
   caches; yi-6b, granite-3-2b, musicgen-large and internvl2-1b (2
   layers each; internvl2 with its patch embeddings) at 8 and 16 bits,
   prefill and ``forward`` logits held to the host's.
9. The elastic mesh's chip faults at full width: the serving
   benchmark's elastic A/B (``_run_elastic``: tinyllama-1.1b and
   mamba2-780m at full width and depth, iws-bfe, batches of up to 4, a
   (4,) logical mesh on the one card, 30 Poisson requests a tenant)
   served through ``EdgeServer.build`` with the real executor, once with
   chip 3 down at 3000 ms and up at 9000 ms on the engine clock, once
   without the fault, at the same budget (the derived one, raised by 5%
   at a time, at most twice, until the drain downgrades a tenant and the
   repromotion restores it, and printed with the reason).  Every
   request served in both runs; the budget held at every event with the
   pools counted, and per logical chip; one chip lost and recovered;
   ``chip_down``, ``drain`` and ``chip_up`` in the audit trail; at every
   event each runtime holds on the card the variant the ledger says is
   loaded; a tenant the drain downgrades drops its graphs and its pool
   charge, its first batch after the drain equals an eager run at its new
   variant, no batch of it overlaps its drain, and the repromotion after
   ``chip_up`` restores its variant.  Prints both warm ratios and service
   times, the drain's ``set_variant`` wall ms and the drain counters, and
   counts the runs' kernel launches with the profiler.
10. Training on the card: the backward kernel of ``flash_attention``
   (``csrc/flash_attention_bwd.cu``: bf16 calls on its tensor-core
   kernels, calls with an f32 operand on its CUDA-core ones; first the
   bf16 kernels' registers and spills from ``python -m
   repro_torch.kernels.resources``, where a spill fails the phase) held
   to autograd through the plain version at the sweep (every mask mode,
   f32 and bf16) and at the training shapes (tinyllama 4 x 1024; gemma2's
   local and global layers at 1 x 4200 with both softcaps), and timed
   there (forward with its log-sum-exp, backward, the plain backward,
   SDPA's backward, the bound; the path and plan each row took).  The
   backward kernels of ``ssd_scan`` (``csrc/ssd_scan_bwd.cu``; first their
   registers and spills, where a spill fails the phase) held to autograd
   through the plain chunked form at the kernel's own chunk, evaluated in
   float64, element-wise, at the scan's sweep (f32 and bf16, with and
   without an initial state and a final-state cotangent; f32 2e-4, bf16
   3e-2 and 1e-2 relative l2) and at the training shapes (mamba2-780m 4 x
   1024, hymba-1.5b's branch 1 x 2176, bf16), and timed there (backward,
   forward, the plain backward at the model's chunk, the bound at the bf16
   peak, and beside it the chunked form's operations and the scratch it
   moves; each row's plan: chunk, head cluster, blocks, scratch).  Then tinyllama-1.1b and mamba2-780m at full width and depth each train
   8 AdamW steps (f32 master, bf16 compute, remat, z-loss; the last two
   with grad_accum=2) on the synthetic stream at 4 x 1024 tokens: losses
   finite and falling, every parameter moved; step ms, tokens/s, the
   share of 989 TFLOP/s (of ``model_flops``'s count, with the inline
   6 N T count and its share beside it), one profiled step's idle share
   and kernels,
   peak memory, and the model's forward and backward kernels' launches
   (zeroed just before, read just after; the backward once a layer and
   micro-step).  Depth cuts at full width (tinyllama 2 layers; mamba2 2
   layers; hymba 2 layers, one full and one windowed, 1 x 2048 behind its
   meta tokens; gemma2 2 layers, 1 x 4200) take one step on the card and
   on the host from the same weights: loss, gradient norm, gradients and
   params held to PERF.md section 2's bf16 rule (the host's steps run in
   a child process started before phase 2, beside the card's phases).  A
   child process runs the cut tinyllama through ``run_supervised`` with a
   failure at step 3 under deterministic algorithms: its final state
   bit-equal to an unbroken run's.
11. The production train cell's per-device step on the card: for
   tinyllama-1.1b and mamba2-780m, the ``train_4k`` cell on the 16 x 16
   production mesh (pure data parallelism: every mesh axis a data axis,
   the f32 state ZeRO-sharded), first its dry-run on ``meta`` tensors
   (``repro_torch.launch.dryrun.run_cell``: FLOPs, bytes and the
   roofline a device, the argument bytes a device from the spec trees),
   then ``build_cell``'s own step function on the card at one device's
   share of the batch (256 rows / 256 devices = 1 x 4096 tokens;
   ``pick_grad_accum`` gives 1), full width and depth, from
   ``init_state``'s state on the card and the synthetic stream's batch:
   one untimed step and CELL_STEPS timed.  Losses finite, every
   parameter moved, the forward and backward kernels launched once a
   layer and step; prints the step ms and tokens/s, ``model_flops`` / 256
   over the step as a share of 989 TFLOP/s, the dry-run's compute_s,
   memory_s and bound_s and the step's multiple of bound_s, the useful
   ratio, and the peak memory beside the cell's argument bytes a device.
12. Prints the kernels as one JSON line (launches summed over the main
   path's, the families' and the elastic A/B's serving runs, the
   training runs and the train cell, and by path), the card, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA device, or without
the repository's ``src/repro_torch`` beside this file, it exits non-zero
before printing any result.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

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
PROFILE_TRIES = 3  # profiles of a step, until none of its kernels is lost
LONG_PROMPT = 2048  # a long mamba2 prefill: the scan bound by operations

# The paged decode's path: real decode caches of the two attention
# tenants, (arch, variant bits, batch, prompt length); gemma2's prompt
# runs past its local layers' 4096-token window.
REPLAY = (("tinyllama-1.1b", 8, 4, 1024), ("gemma2-2b", 16, 2, 4200))
REPLAY_STEPS = 3
PAGE_SIZES = (16, 128)
# The int8 KV cache and the deferred (uniform_pos) write: (arch, bits).
CACHE_LAYOUTS = (("tinyllama-1.1b", 8), ("gemma2-2b", 16))
FORWARD_BATCH = (2, 64)  # the full-sequence forward and fidelity's prompts
MB = 1024 * 1024
# Phase 8: the hybrid and MoE families at full width and depth, served
# together; each tenant's batches (batch size, prompt length) in turn, so
# that a key's first call runs eagerly, its second captures, its third
# replays.
FAMILY_ARCHS = ("hymba-1.5b", "olmoe-1b-7b")
FAMILY_BATCHES = ((2, 8), (2, 8), (2, 6), (2, 8))
HYMBA_LONG = 2048  # hymba's long prompt: its 1024-token window bites
# Depth cuts at full width: llama4-scout (2 of 48 layers: 107.8 B
# parameters hold no zoo variant in 80 GB) and the dense families.
LLAMA4 = ("llama4-scout-17b-a16e", 2)
LLAMA4_STEPS = 3
DENSE_CUTS = (("yi-6b", 2), ("granite-3-2b", 2), ("musicgen-large", 2),
              ("internvl2-1b", 2))
# Phase 9: the serving benchmark's elastic A/B
# (benchmarks/serving_throughput.py:238 ``_run_elastic``): its tenants
# (:171), its fault schedule (:176), its trace's requests a tenant; at
# most ELASTIC_TRIES budgets from the derived one, each ELASTIC_STEP times
# the last, until the drain downgrades a tenant and the repromotion after
# the chip's return restores it.  The trace is never cut: half its
# requests end before the chip returns at 9000 ms.
ELASTIC_ARCHS = ("tinyllama-1.1b", "mamba2-780m")
ELASTIC_FAULT = ((3000.0, 3, "down"), (9000.0, 3, "up"))
ELASTIC_REQUESTS = 30
ELASTIC_TRIES = 3
ELASTIC_STEP = 1.05
ELASTIC_KERNELS = ("quant_matmul", "decode_attention", "flash_attention",
                   "ssd_scan")
# Phase 10: training on the card.  The main training path: TRAIN_ARCH at
# full width and depth, TRAIN_STEPS AdamW steps (the last two with
# grad_accum=2) at TRAIN_BATCH x TRAIN_SEQ tokens, lr warmup_cosine(peak,
# warmup, total).  Depth cuts at full width held to the host: TRAIN_ARCH
# at CUT_LAYERS layers on the same batch, and gemma2-2b at 2 layers (one
# local, one global) over (B, S) = (1, 4200), past its 4096-token window.
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
TRAIN_LR = (3e-4, 2, 8)
TRAIN_Z = 1e-4
CUT_LAYERS = 2
GEMMA_CUT = ("gemma2-2b", 2, 1, 4200)
RECOVERY_STEPS = 4  # the supervised runs of the recovery check
# The SSM tenant trains at full width and depth by the same recipe, through
# the scan's backward kernel; it and hymba-1.5b (2 layers: one full, one
# windowed; 2048 tokens behind its 128 meta tokens) are also cut in depth
# and held to the host.  hymba stays cut: at about 48 bytes a parameter
# (the training run's peak) its 1.5 B parameters would not fit 80 GB.
SSM_TRAIN_ARCH = "mamba2-780m"
SSM_CUT = (SSM_TRAIN_ARCH, CUT_LAYERS, TRAIN_BATCH, TRAIN_SEQ)
HYMBA_CUT = ("hymba-1.5b", 2, 1, 2048)
HOST_CUTS = ((TRAIN_ARCH, CUT_LAYERS, TRAIN_BATCH, TRAIN_SEQ), SSM_CUT,
             HYMBA_CUT, GEMMA_CUT)
# The scan backward's training shapes: (arch, batch, rows a sequence).
SSD_BWD_ROWS = ((SSM_TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ),
                ("hymba-1.5b", 1, 2048 + 128))
# Phase 11: the production train cell's per-device step (pure data
# parallelism on the 16 x 16 mesh: one row of 4096 tokens a device).
CELL_ARCHS = (TRAIN_ARCH, SSM_TRAIN_ARCH)
CELL_SHAPE = "train_4k"
CELL_STEPS = 3  # timed, after one untimed
HOST_THREADS = 4  # of the card machine's 8 cores: the host's cut steps

# The main path's kernels by the profiler's names: the substrings of each
# wrapper's kernel (the decode kernels' split pass, dense or paged).
KERNEL_NAMES = {"quant_matmul": ("qmm_cluster",),
                "flash_attention_bwd": ("flash_bwd",),
                "ssd_scan_bwd": ("ssd_bwd",),
                "decode_attention": ("decode_split", "Dense"),
                "flash_attention": ("flash_tiles",),
                "ssd_scan": ("ssd_cluster",),
                "paged_decode_attention": ("decode_split", "Paged")}


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
    # The profiler now and then drops some of a step's kernels (147 of
    # 182 seen once): a profile that saw fewer kernels than the step made
    # calls is taken again, up to PROFILE_TRIES times in all.
    for _ in range(PROFILE_TRIES):
        before = ops.quant_matmul.launches
        wall, kern, counts = device_kernels(lambda: step(ops.quant_matmul))
        calls = (ops.quant_matmul.launches - before) // 2  # warm-up, run
        if sum(counts.values()) >= calls:
            break
        print(f"  (profile of the {what} step saw {sum(counts.values())} "
              f"kernels for {calls} calls: taken again)")
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
          f"bound {ops_ / peak_ops(torch.float32) * 1e3:.4f} ms "
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


def card_activity(prof) -> tuple:
    """({name: device ms}, {name: count}) of the card's activity in a
    finished profile, read off the profiler's raw events: for a serving
    run that takes seconds, where building its event tree
    (``key_averages``) took over a minute."""
    from torch.autograd import DeviceType

    ms, counts = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            k = e.name()
            ms[k] = ms.get(k, 0.0) + e.duration_ns() / 1e6
            counts[k] = counts.get(k, 0) + 1
    return ms, counts


def device_kernels(fn):
    """(wall ms, {kernel name: device ms}, {kernel name: count}) of one
    call of ``fn``, from the profiler's CUDA activity (kernels of every
    runtime in the process, the port's ctypes-loaded ones and those a
    CUDA graph replays included).  The profiler traces the host too: with
    the card's activity alone it missed a sixth of a decode step's
    ``quant_matmul`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return (wall, *card_activity(prof))


def rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm())


def peak_ops(dtype) -> float:
    """The card's dense FLOP/s for operands of ``dtype``: bf16 on the
    tensor cores, f32 on the CUDA cores (``repro_torch.launch.mesh``)."""
    from repro_torch.launch import mesh

    return {torch.float32: mesh.PEAK_FLOPS_F32,
            torch.bfloat16: mesh.PEAK_FLOPS_BF16}[dtype]


def bound(nbytes: float, ops_: float, dtype) -> dict:
    """The least time for ``nbytes`` moved at the card's HBM rate and
    ``ops_`` operations at its peak for operands of ``dtype``."""
    from repro_torch.launch.mesh import HBM_BW

    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops_ / peak_ops(dtype) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
def family(name: str) -> str:
    """The main-path kernel (KERNEL_NAMES) that a profiler kernel name
    belongs to, else "cuBLAS" or "other PyTorch" (elementwise,
    reductions, copies)."""
    return next((k for k, parts in KERNEL_NAMES.items()
                 if all(part in name for part in parts)),
                "cuBLAS" if any(b in name for b in ("nvjet", "gemm", "gemv"))
                else "other PyTorch")


def kernel_launches(counts: dict) -> dict:
    """Launches of each main-path kernel in ``counts`` ({profiler kernel
    name: count})."""
    out = dict.fromkeys(KERNEL_NAMES, 0)
    for name, n in counts.items():
        k = family(name)
        if k in out:
            out[k] += n
    return out


def families(ms: dict, counts: dict) -> str:
    """Device ms and launches of a profile by kernel family."""
    fam = {}
    for name, t in ms.items():
        t0, n0 = fam.get(family(name), (0.0, 0))
        fam[family(name)] = (t0 + t, n0 + counts[name])
    return ", ".join(f"{k} {t:.2f} ms / {n}" for k, (t, n) in
                     sorted(fam.items(), key=lambda kv: -kv[1][0]))


def build_server():
    """The main path's server: the three tenants at full width on the
    card, contended budget, batches of up to MAX_BATCH."""
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
    return srv


def serve_trace(srv) -> list:
    """Serves the main path's trace on ``srv``: REQUESTS requests
    alternating across the tenants, prompts of 4 to MAX_PROMPT tokens and
    MAX_NEW new tokens, exponential gaps of 500 ms on the engine's clock,
    through the Batcher in rounds of six.  Returns (batch, result, graphs
    captured, graphs replayed) for each batch served (the counts are 0 on
    a tree whose ``generate`` runs eagerly, which
    ``tools/torch_serve_ab.py`` also serves)."""
    from repro_torch.serving import Batcher, Request

    names = list(srv.tenants)
    rng = np.random.default_rng(0)
    batcher = Batcher(max_batch=MAX_BATCH)
    results = []
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
                tr = srv.tenants[b.app]
                caps, reps = (getattr(tr, "captures", 0),
                              getattr(tr, "replays", 0))
                r = srv.serve(b.app, b.prompts, b.max_new, now_ms=now)
                results.append((b, r, getattr(tr, "captures", 0) - caps,
                                getattr(tr, "replays", 0) - reps))
    torch.cuda.synchronize()
    return results


def serve(kernels) -> tuple:
    from torch.profiler import ProfilerActivity, profile

    srv = build_server()
    names = list(srv.tenants)
    for fn in kernels.values():
        fn.launches = 0
    # The kernels of eager warm-ups and of graph replays alike (host and
    # card traced, as device_kernels does).
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        results = serve_trace(srv)
    calls = {name: fn.launches for name, fn in kernels.items()}
    t0 = time.perf_counter()
    ms, counts = card_activity(prof)
    launches = {k: n for k, n in kernel_launches(counts).items()
                if k in kernels}
    t_prof = time.perf_counter() - t0
    srv.engine.check_event_invariant()
    for b, r, caps, reps in results:
        print(f"  batch {b.app} x{len(b.requests)} prompt {b.prompts.shape[1]}"
              f": bits={r.bits} {'warm' if r.warm else 'cold'}"
              f"{' FAILED' if r.failed else ''}, {how_served(caps, reps)}, "
              f"latency {r.latency_s * 1e3:.1f} ms")
    stats = srv.stats()
    tokens = sum(len(b.requests) * b.max_new for b, *_ in results)
    busy = sum(r.latency_s for _, r, *_ in results)
    print(f"main path: {stats.requests} requests, warm ratio "
          f"{stats.warm_ratio:.3f}, fail ratio {stats.fail_ratio:.3f}, "
          f"{tokens} tokens in {busy:.3f} s of service = "
          f"{tokens / busy:.1f} tokens/s; {len(results)} batches, "
          f"{sum(c for *_, c, _ in results)} captured, "
          f"{sum(not r for *_, r in results)} eager; kernel launches "
          f"(profiler, replays included) {launches}; wrapper calls (eager "
          f"calls and captures) {calls}; profile read in {t_prof:.1f} s;"
          f" device {sum(ms.values()):.1f} ms in all, by kernel family "
          f"{families(ms, counts)}")
    if stats.requests != REQUESTS or any(r.failed for _, r, *_ in results):
        raise AssertionError("not every request was served")
    if any(caps > reps or reps > 1 for *_, caps, reps in results):
        raise AssertionError("a batch was neither eager nor one graph "
                             "replay")
    if {b.app for b, *_ in results} != set(names):
        raise AssertionError("a tenant served no batch")
    if not any(r.bits == 8 for _, r, *_ in results):
        raise AssertionError("no batch ran at 8 bits")
    for name in kernels:
        if launches[name] <= 0 or calls[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if not any(caps for *_, caps, _ in results):
        raise AssertionError("no batch of the serving run captured")
    evict_all(srv)
    for name in names:
        t0 = time.perf_counter()
        check_outputs(srv.tenants[name])
        print(f"checked {name} in {time.perf_counter() - t0:.1f} s")
    return launches, srv


def how_served(caps: int, reps: int) -> str:
    return "captured" if caps else "replayed" if reps else "eager"


def evict_all(srv) -> None:
    """Evict every tenant through the loader, so that the accounting and
    the card change together; require each tenant's charged graph pool to
    have equalled the pool the allocator held, and after eviction every
    charge, ``used_mb`` and every pool at 0.  Then detach the runtimes from
    the engine: the later checks drive them directly."""
    from repro_torch.core import actions as RA
    from repro_torch.serving.server import pool_bytes

    st = srv.manager.state
    pools = {n: tr.pool for n, tr in srv.tenants.items()
             if tr.pool is not None}
    held = {n: (pool_bytes(pool) / MB, st.tenants[n].pool_mb)
            for n, pool in pools.items()}
    used, weights = st.used_mb, st.weights_mb
    for name, t in st.tenants.items():
        if t.loaded is not None:
            srv.loader.execute(RA.ResidencyPlan((RA.Unload(name),)),
                               srv.engine._now)
    srv.close()  # the staging worker drops the graphs with the variants
    left = {n: pool_bytes(pool) for n, pool in pools.items()}
    print("graph pools after the serving run (held / charged): " + ", ".join(
        f"{n} {b:.1f} / {c:.1f} MB ({srv.tenants[n].captures} captures)"
        for n, (b, c) in held.items())
        + f"; used_mb {used:.1f} = weights {weights:.1f} + pools "
        f"{sum(c for _, c in held.values()):.1f}; after eviction: used_mb "
        f"{st.used_mb:.1f}, pools " + ", ".join(f"{n} {b} B"
                                               for n, b in left.items()))
    if any(abs(b - c) > 1e-6 for b, c in held.values()):
        raise AssertionError("a charged graph pool differs from the pool "
                             "the allocator holds")
    if any(left.values()) or st.pool_mb or st.used_mb:
        raise AssertionError("a graph pool or its charge outlived its "
                             "variant")
    for tr in srv.tenants.values():
        tr.pool_ledger = None


def hold_to_host(what: str, got, plain, host_params, bits: int) -> str:
    """The card's result ``got`` (moved to the host) against ``plain(
    host_params)``, the same function through the plain versions on the
    host: relative l2 within QMM_TOL at 8 bits and TOL[bfloat16] at 16.
    Past that at 16 bits, the card is held to the plain version's own
    error instead: bf16 rounds at other points on the card than on the
    host (cuBLAS against the CPU's products, the kernels' sums), and a
    deep stack can carry that further than the bf16 tolerance, so both
    are measured against the same weights evaluated in f32, and the card
    may be no further from them than twice the plain version.  Returns
    the printed line; raises with it on a failure."""
    from repro_torch.quant.quantize import tree_map

    want = plain(host_params)
    tol = QMM_TOL if bits == 8 else TOL[torch.bfloat16]
    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise AssertionError(f"{what}: {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, or not finite")
    rel = rel_l2(got, want)
    line = f"{what} {tuple(got.shape)} rel L2 err {rel:.3g} (tol {tol})"
    if rel > tol and bits == 16:
        exact = plain(tree_map(lambda _, t: t.float() if
                               t.is_floating_point() else t, host_params))
        card_err, plain_err = rel_l2(got, exact), rel_l2(want, exact)
        line += (f"; against the f32 evaluation: card {card_err:.3g},"
                 f" plain {plain_err:.3g} (tol 2x plain)")
        if card_err > 2 * plain_err:
            raise AssertionError(line)
    elif rel > tol:
        raise AssertionError(line)
    return line


def check_outputs(tr) -> None:
    """The served model on the card against the plain versions on the
    host, for a small prompt batch: prefill logits (relative L2 error) and,
    for the 8-bit variant, greedy tokens; then, per variant, a full batch's
    ``generate`` eagerly and as a graph (:func:`check_graph`)."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.server import _generate_tokens

    cfg = tr.cfg
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    for bits in (8, 16):
        tr.set_variant(tr.zoo.by_bits(bits))
        dev_tok = torch.from_numpy(prompts).cuda()
        with torch.inference_mode():
            got, _ = T.prefill(cfg, tr.device_params, {"tokens": dev_tok},
                               max_len=12)
            line = hold_to_host(
                f"check {cfg.name} {bits}-bit: prefill logits", got.cpu(),
                lambda params: T.prefill(
                    cfg, params, {"tokens": torch.from_numpy(prompts)},
                    max_len=12)[0], tr.host[bits], bits)
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
        check_graph(tr, bits)
    tr.set_variant(None)


def unprofiled_walls(fn) -> list:
    walls = []
    for _ in range(GENERATE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def profile_text(wall, kern, counts, walls) -> str:
    """One profiled call (its wall, the card's busy time within it and the
    idle share both give) and, beside it, the unprofiled walls."""
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
    return (f"unprofiled median {np.median(walls):.1f} ms ("
            + ", ".join(f"{w:.1f}" for w in walls)
            + f"); profiled call: wall {wall:.1f} ms, device busy "
            f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}, "
            f"{sum(counts.values())} kernels; top: "
            + "; ".join(f"{k[:50]} {t:.2f} ms" for k, t in top))


def check_graph(tr, bits: int) -> None:
    """One ``generate`` of a full batch (MAX_BATCH x MAX_PROMPT prompts,
    MAX_NEW new tokens) of the just loaded variant, eagerly through
    ``_generate_tokens`` and as the runtime's graph: equal greedy ids; the
    walls of the first and second calls of two keys (the full batch and a
    prompt a token shorter): the first runs eagerly on the capture stream
    and captures nothing, the second captures and replays; then a
    profiled replay and GENERATE_RUNS unprofiled walls each way.  The
    profiled replay calls no kernel wrapper, so every kernel the profiler
    sees on the card came from the graph; those of the path must be
    there."""
    from repro_torch.kernels import ops
    from repro_torch.serving.server import _generate_tokens, pool_bytes

    cfg = tr.cfg
    batch = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (MAX_BATCH, MAX_PROMPT)).astype(np.int32)

    def eager(prompts):
        with torch.inference_mode():
            return _generate_tokens(
                cfg, tr.device_params, torch.from_numpy(prompts).cuda(),
                max_new=MAX_NEW, max_len=prompts.shape[1] + MAX_NEW)

    eager_prof = device_kernels(lambda: eager(batch))
    eager_walls = unprofiled_walls(lambda: eager(batch))
    caps = tr.captures
    call_ms = []
    for prompts in (batch, np.ascontiguousarray(batch[:, 1:])):
        want = eager(prompts).cpu().numpy()
        for n in (0, 1):  # the key's first call, then its second
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = tr.generate(prompts, MAX_NEW)
            call_ms.append((time.perf_counter() - t0) * 1e3)
            if tr.captures != caps + len(call_ms) // 2:
                raise AssertionError(
                    f"{cfg.name} {bits}-bit: call {n + 1} of a key "
                    f"{'captured' if n == 0 else 'did not capture'}")
            if not np.array_equal(got, want):
                raise AssertionError(f"{cfg.name} {bits}-bit: ids "
                                     f"{got.tolist()} of call {n + 1} "
                                     f"differ from eager {want.tolist()}")
    caps = tr.captures
    wrappers = {k: getattr(ops, k) for k in KERNEL_NAMES}
    for fn in wrappers.values():
        fn.launches = 0
    wall, kern, counts = device_kernels(lambda: tr.generate(batch, MAX_NEW))
    graph_walls = unprofiled_walls(lambda: tr.generate(batch, MAX_NEW))
    called = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    seen = kernel_launches(counts)
    need = (["quant_matmul"] * (bits == 8)
            + (["decode_attention", "flash_attention"]
               if cfg.uses_attention else ["ssd_scan"]))
    if called or tr.captures != caps or not all(seen[k] for k in need):
        raise AssertionError(f"{cfg.name} {bits}-bit replay: wrappers "
                             f"called {called}, kernels seen {seen}")
    print(f"  generate {cfg.name} {bits}-bit ({MAX_BATCH}x{MAX_PROMPT} "
          f"prompt, {MAX_NEW} new), greedy ids equal eager and graph:\n"
          f"    eager: {profile_text(*eager_prof, eager_walls)}\n"
          f"    graph: the variant's first key, first call (eager, capture "
          f"stream) {call_ms[0]:.1f} ms, second (capture, replay) "
          f"{call_ms[1]:.1f} ms; a second key ({MAX_BATCH}x{MAX_PROMPT - 1})"
          f" {call_ms[2]:.1f} / {call_ms[3]:.1f} ms; replay "
          f"{profile_text(wall, kern, counts, graph_walls)}; a replay by "
          f"kernel family (device ms / launches): {families(kern, counts)};"
          f" pool {pool_bytes(tr.pool) / MB:.1f} MB")


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
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dense_fn = ops.decode_attention
    tol = TOL[torch.bfloat16]  # the caches are bf16
    rows = {}
    launches = seen = 0  # by the wrapper, and on the card by the profiler
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            paged_logits, paged_ids, _ = run(hook)
            torch.cuda.synchronize()
        launches += ops.paged_decode_attention.launches
        seen += kernel_launches(card_activity(prof)[1])[
            "paged_decode_attention"]
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
    print(f"replay: paged_decode_attention called {launches} times, "
          f"{seen} of its split kernels seen on the card by the profiler")
    if launches != want or not seen:
        raise AssertionError(f"paged_decode_attention launched {launches} "
                             f"times in the replay, not {want}, {seen} seen")
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


# ---------------------------------------------------------------------------
# Phase 7: the full-sequence forward and the zoo's fidelity
# ---------------------------------------------------------------------------
def check_forward(srv, kernels) -> None:
    """For each tenant, both variants on the card at once: ``forward`` of
    FORWARD_BATCH prompts, every position's logits held to ``forward``
    through the plain versions on the host (:func:`hold_to_host`), its
    last position to the card's ``prefill`` logits for the same prompts
    (relative l2 within 2e-4 at 8 bits, 3e-2 at 16: the two card paths
    agree), the path's kernels launched by it; then ``fidelity`` of the
    8-bit variant against the 16-bit one, printed."""
    from repro_torch.models import transformer as T
    from repro_torch.quant.quantize import fidelity, tree_map

    for name, tr in srv.tenants.items():
        cfg = tr.cfg
        t0 = time.perf_counter()
        host_tokens = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab_size, FORWARD_BATCH).astype(np.int32))
        batch = {"tokens": host_tokens.cuda()}
        params = {b: tree_map(lambda _, t: t.cuda(), tr.host[b])
                  for b in (16, 8)}
        line = f"forward {name} {FORWARD_BATCH}:"
        with torch.inference_mode():
            for bits, tol in ((8, QMM_TOL), (16, TOL[torch.bfloat16])):
                for fn in kernels.values():
                    fn.launches = 0
                full = T.forward(cfg, params[bits], batch)
                calls = {k: fn.launches for k, fn in kernels.items()}
                line += " " + hold_to_host(
                    f"{bits}-bit logits against the host's", full.cpu(),
                    lambda p: T.forward(cfg, p, {"tokens": host_tokens}),
                    tr.host[bits], bits)
                last, _ = T.prefill(cfg, params[bits], batch,
                                    max_len=FORWARD_BATCH[1])
                want = (FORWARD_BATCH[0], FORWARD_BATCH[1],
                        cfg.num_codebooks, cfg.padded_vocab)
                if tuple(full.shape) != want:
                    raise AssertionError(f"{line} {bits}-bit logits "
                                         f"{tuple(full.shape)} malformed")
                rel = rel_l2(full[:, -1], last)
                need = (["quant_matmul"] * (bits == 8)
                        + (["flash_attention"] if cfg.uses_attention
                           else ["ssd_scan"]))
                line += (f", last position vs the card's prefill rel L2 "
                         f"{rel:.3g} (tol {tol:g}), calls {calls};")
                if rel > tol or not all(calls[k] for k in need):
                    raise AssertionError(line)
            fid = fidelity(cfg, params[16], params[8], batch, T.forward)
        del params, full, last
        torch.cuda.empty_cache()
        print(f"{line} fidelity of 8 bits against 16: top-1 agreement "
              f"{fid['top1_agreement']:.2f}%, logit MSE "
              f"{fid['logit_mse']:.6g} (zoo's assumed accuracy "
              f"{tr.zoo.by_bits(8).accuracy:g}); "
              f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 8: the hybrid and MoE families; the dense families at full width
# ---------------------------------------------------------------------------
def build_family_server():
    """hymba-1.5b and olmoe-1b-7b at full width and depth on the card,
    the contended budget derived as the main path's is."""
    from repro_torch.serving.api import (BatchingSpec, EdgeServer,
                                         ServingConfig, TenantSpec)

    t0 = time.perf_counter()
    srv = EdgeServer.build(ServingConfig(
        executor="real",
        tenants=tuple(TenantSpec(a, reduced=False) for a in FAMILY_ARCHS),
        kv_headroom_shape=(MAX_BATCH, 32),
        batching=BatchingSpec(max_batch=MAX_BATCH)), device="cuda")
    print(f"families: built {', '.join(FAMILY_ARCHS)} at full width and "
          f"depth in {time.perf_counter() - t0:.1f} s; contended budget "
          f"{srv.budget_mb:.1f} MB; variants (params_nbytes) "
          + "; ".join(f"{n}: " + ", ".join(
              f"{v.bits}-bit {v.size_mb * MB / 1e9:.2f} GB"
              for v in t.zoo.variants) for n, t in srv.tenants.items()))
    return srv


def serve_families(kernels) -> dict:
    """Phase 8's serving run: FAMILY_BATCHES for each tenant in turn, the
    kernels' counts zeroed just before and the profiler over the run.
    Every request served, the budget held at every event with the pools
    counted, each tenant's charge equal to its pool after every batch and
    above its level before a capture; then eviction (pools back to 0),
    and per tenant and variant the host checks and ``check_graph``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.server import pool_bytes

    srv = build_family_server()
    st = srv.manager.state
    rng = np.random.default_rng(8)
    rows = []
    for fn in kernels.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        now = 0.0
        for B, S in FAMILY_BATCHES:
            for name in FAMILY_ARCHS:
                tr = srv.tenants[name]
                prompts = rng.integers(0, tr.cfg.vocab_size,
                                       (B, S)).astype(np.int32)
                srv.predict_and_preload(now)
                caps, reps = tr.captures, tr.replays
                before = st.tenants[name].pool_mb
                r = srv.serve(name, prompts, MAX_NEW, now_ms=now)
                torch.cuda.synchronize()
                after = st.tenants[name].pool_mb
                held = (pool_bytes(tr.pool) / MB if tr.pool is not None
                        else 0.0)
                rows.append((name, B, S, r, tr.captures - caps,
                             tr.replays - reps, before, after, st.used_mb))
                if abs(after - held) > 1e-6 or (
                        tr.captures > caps and tr.pool is not None
                        and not after > 0):
                    raise AssertionError(
                        f"{name}: pool charged {after:.1f} MB (was "
                        f"{before:.1f}) against {held:.1f} MB held")
                now += 500.0
    calls = {k: fn.launches for k, fn in kernels.items()}
    ms, counts = card_activity(prof)
    launches = kernel_launches(counts)
    srv.engine.check_event_invariant()
    for name, B, S, r, caps, reps, before, after, used in rows:
        print(f"  batch {name} x{B} prompt {S}: bits={r.bits} "
              f"{'warm' if r.warm else 'cold'}"
              f"{' FAILED' if r.failed else ''}, {how_served(caps, reps)}, "
              f"latency {r.latency_s * 1e3:.1f} ms; pool charged "
              f"{before:.1f} -> {after:.1f} MB, used_mb {used:.1f}")
    pools = [e for e in srv.engine.events if e.kind == "pool"]
    print(f"families: {len(rows)} batches, "
          f"{sum(c for *_, c, _, _, _, _ in rows)} captured; pool events "
          f"{len(pools)} (MB: " + ", ".join(f"{e.app} {e.kv_mb:+.1f}"
                                           for e in pools)
          + f"); max used_mb {max(e.used_mb for e in srv.engine.events):.1f}"
          f" of {srv.budget_mb:.1f}; kernel launches (profiler) "
          f"{ {k: launches[k] for k in kernels} }; wrapper calls {calls}; "
          f"device {sum(ms.values()):.1f} ms, by kernel family "
          f"{families(ms, counts)}")
    if any(r.failed for _, _, _, r, *_ in rows):
        raise AssertionError("families: a request was not served")
    if not any(row[4] for row in rows) or not any(
            row[5] and not row[4] for row in rows):
        raise AssertionError("families: no batch captured, or none "
                             "replayed")
    for name in kernels:
        if launches[name] <= 0 or calls[name] <= 0:
            raise AssertionError(f"{name} was not launched by the families")
    evict_all(srv)
    for name in FAMILY_ARCHS:
        t0 = time.perf_counter()
        check_family_outputs(srv.tenants[name])
        print(f"checked {name} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_hymba_long(srv.tenants["hymba-1.5b"])
    print(f"hymba long prefill checked in {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] for k in kernels}


def check_family_outputs(tr) -> None:
    """Per variant: the card's prefill logits and one decode step's logits
    (from the card's cache) held to the host's plain versions by
    ``hold_to_host``; then ``check_graph``.  (No host run of the whole
    greedy loop: at olmoe's size each host pass takes seconds.)"""
    from repro_torch.models import transformer as T

    cfg = tr.cfg
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    host_tok = torch.from_numpy(prompts)
    for bits in (8, 16):
        tr.set_variant(tr.zoo.by_bits(bits))
        with torch.inference_mode():
            logits, cache = T.prefill(cfg, tr.device_params,
                                      {"tokens": host_tok.cuda()},
                                      max_len=12)
            tok = T.greedy_token(cfg, logits)
            before = {n: t.to("cpu", copy=True) for n, t in cache.items()}
            step, _ = T.decode_step(cfg, tr.device_params, cache, tok)
            lines = [hold_to_host(
                f"check {cfg.name} {bits}-bit: prefill logits", logits.cpu(),
                lambda p: T.prefill(cfg, p, {"tokens": host_tok},
                                    max_len=12)[0], tr.host[bits], bits),
                hold_to_host(
                    "decode-step logits from the card's cache", step.cpu(),
                    lambda p: T.decode_step(
                        cfg, p, {n: t.clone() for n, t in before.items()},
                        tok.cpu())[0], tr.host[bits], bits)]
        print("; ".join(lines))
        del cache, before
        check_graph(tr, bits)
    tr.set_variant(None)
    torch.cuda.empty_cache()


def check_hymba_long(tr) -> None:
    """hymba-1.5b at 8 bits over one HYMBA_LONG-token prompt (the meta
    tokens make it HYMBA_LONG + 128 rows): the card's ``forward`` logits
    against the host's, over all rows and over the rows past the window
    (where the meta tokens are visible only through ``prefix``), relative
    l2 within 2e-4; the same forward on the card with the prefix dropped
    from the attention must miss there by more than that, so the check
    cannot pass a kernel that ignores the prefix.  The card's prefill
    logits equal its forward's last position."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = tr.cfg
    tr.set_variant(tr.zoo.by_bits(8))
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (1, HYMBA_LONG)).astype(np.int32))
    flash = ops.flash_attention
    with torch.inference_mode():
        card = T.forward(cfg, tr.device_params, {"tokens": tokens.cuda()})
        last, _ = T.prefill(cfg, tr.device_params, {"tokens": tokens.cuda()},
                            max_len=HYMBA_LONG)
        ops.flash_attention = lambda *a, prefix=0, **kw: flash(*a, **kw)
        try:
            blind = T.forward(cfg, tr.device_params,
                              {"tokens": tokens.cuda()})[0].cpu()
        finally:
            ops.flash_attention = flash
        t0 = time.perf_counter()
        host = T.forward(cfg, tr.host[8], {"tokens": tokens})[0]
        t_host = time.perf_counter() - t0
    past = slice(cfg.sliding_window + cfg.num_meta_tokens, None)
    rel_last = rel_l2(card[:, -1].cpu(), last.cpu())
    card = card[0].cpu()
    rel_all, rel_past = rel_l2(card, host), rel_l2(card[past], host[past])
    rel_blind = rel_l2(blind[past], host[past])
    line = (f"hymba long prefill, 1 x {HYMBA_LONG} tokens ({card.shape[0]} "
            f"rows), 8-bit, card forward against the host's ({t_host:.1f} "
            f"s): rel L2 err {rel_all:.3g}, past the window {rel_past:.3g} "
            f"(tol {QMM_TOL}); without the prefix {rel_blind:.3g} there; "
            f"prefill vs forward's last row {rel_last:.3g}")
    print(line)
    if max(rel_all, rel_past, rel_last) > QMM_TOL or rel_blind <= QMM_TOL:
        raise AssertionError(line)
    tr.set_variant(None)
    torch.cuda.empty_cache()


def cut_variants(arch: str, layers: int, precisions):
    """A full-width config cut to ``layers`` layers, its random f32
    weights made on the card, and its zoo variants: on the card and on the
    host."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.quant.quantize import quantize_params, tree_map

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    params = T.init_params(cfg, 0, torch.float32, device="cuda")
    out = {}
    for bits in precisions:
        card_params = quantize_params(params, bits=bits, group=32)
        out[bits] = (card_params,
                     tree_map(lambda _, t: t.cpu(), card_params))
    del params
    torch.cuda.empty_cache()
    return cfg, out


def check_llama4(kernels) -> None:
    """llama4-scout at full width cut to LLAMA4[1] layers, 8 bits: prefill
    and LLAMA4_STEPS greedy decode steps on the card (top-1 routing and
    the shared expert, dense MoE), every step's logits held to the host's
    plain run from the card's cache before that step, greedy ids equal."""
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg, variants = cut_variants(*LLAMA4, (8,))
    params, host_params = variants[8]
    B, S = 2, 8
    prompts = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    for fn in kernels.values():
        fn.launches = 0
    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, {"tokens": prompts.cuda()},
                                  max_len=S + LLAMA4_STEPS)
        out, ids, states = [logits], [T.greedy_token(cfg, logits)], []
        for _ in range(LLAMA4_STEPS):
            states.append({n: t.to("cpu", copy=True)
                           for n, t in cache.items()})
            logits, cache = T.decode_step(cfg, params, cache, ids[-1])
            out.append(logits)
            ids.append(T.greedy_token(cfg, logits))
    calls = {k: fn.launches for k, fn in kernels.items()}
    t_card = time.perf_counter() - t0
    got = torch.stack(out).cpu()
    ids = torch.stack(ids).cpu()

    # The host's prefill, then every step from the card's cache before it
    # and the card's token, the steps as one batch (they are independent).
    t0 = time.perf_counter()
    with torch.inference_mode():
        first, _ = T.prefill(cfg, host_params, {"tokens": prompts},
                             max_len=S + LLAMA4_STEPS)
        stacked = {n: torch.cat([st[n] for st in states],
                                dim=0 if n == "lengths" else 1)
                   for n in states[0]}
        steps, _ = T.decode_step(cfg, host_params, stacked,
                                 ids[:LLAMA4_STEPS].reshape(-1))
    want = torch.cat([first[None], steps.reshape(LLAMA4_STEPS, B,
                                                 *steps.shape[1:])])
    line = hold_to_host(
        f"llama4-scout full width, {cfg.num_layers} of 48 layers, 8-bit: "
        f"prefill and {LLAMA4_STEPS} steps' logits", got, lambda _: want,
        host_params, 8)
    host_ids = torch.stack([T.greedy_token(cfg, t) for t in want])
    need = ("quant_matmul", "flash_attention", "decode_attention")
    print(f"{line}; card {t_card:.1f} s, host {time.perf_counter() - t0:.1f}"
          f" s; greedy ids {ids.tolist()}; calls {calls}")
    if not torch.equal(ids, host_ids) or not all(calls[k] for k in need):
        raise AssertionError(f"llama4: ids {ids.tolist()} against "
                             f"{host_ids.tolist()}, calls {calls}")
    del variants, params, cache
    torch.cuda.empty_cache()


def check_dense_cuts(kernels) -> None:
    """The dense families at full width cut to two layers each: prefill
    logits and ``forward`` logits on the card at 8 and 16 bits held to the
    host's by ``hold_to_host``; internvl2-1b's prompt carries its patch
    embeddings through the batch's extra inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    for arch, layers in DENSE_CUTS:
        t0 = time.perf_counter()
        cfg, variants = cut_variants(arch, layers, (8, 16))
        rng = np.random.default_rng(12)
        shape = (2, 16) if cfg.num_codebooks == 1 else (2, 16,
                                                        cfg.num_codebooks)
        host = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, shape).astype(np.int32))}
        if cfg.frontend == "vision_stub":
            host["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32))
        batch = {k: v.cuda() for k, v in host.items()}
        lines = []
        for bits, (params, host_params) in sorted(variants.items()):
            for fn in kernels.values():
                fn.launches = 0
            with torch.inference_mode():
                logits, _ = T.prefill(cfg, params, batch, max_len=20)
                full = T.forward(cfg, params, batch)
                calls = {k: fn.launches for k, fn in kernels.items()}
                lines.append(hold_to_host(
                    f"{bits}-bit prefill logits", logits.cpu(),
                    lambda p: T.prefill(cfg, p, host, max_len=20)[0],
                    host_params, bits))
                lines.append(hold_to_host(
                    "forward logits", full.cpu(),
                    lambda p: T.forward(cfg, p, host), host_params, bits))
            need = ["flash_attention"] + ["quant_matmul"] * (bits == 8)
            if not all(calls[k] for k in need):
                raise AssertionError(f"{arch} {bits}-bit: calls {calls}")
        print(f"{arch} full width, {layers} of "
              f"{get_config(arch).num_layers} layers: " + "; ".join(lines)
              + f"; {time.perf_counter() - t0:.1f} s")
        del variants
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 9: the elastic mesh's chip faults served at full width
# ---------------------------------------------------------------------------
def elastic_config(fault: bool, budget_mb=None):
    """``benchmarks/serving_throughput.py`` ``_run_elastic``'s
    configuration with the real executor: its two tenants at full width
    and depth, a (4,) logical mesh on the one card, chip 3 down and up on
    the engine clock (or no fault)."""
    from repro_torch.serving.api import (BatchingSpec, FaultSpec, LoaderSpec,
                                         ServingConfig, TenantSpec)

    return ServingConfig(
        tenants=tuple(TenantSpec(a, reduced=False) for a in ELASTIC_ARCHS),
        executor="real", policy="iws-bfe", delta_ms=750.0,
        batching=BatchingSpec(max_batch=4, window_ms=20.0),
        loader=LoaderSpec(sharded=True, mesh_shape=(4,)),
        kv_headroom_shape=(2, 12), budget_mb=budget_mb,
        fault=FaultSpec(events=ELASTIC_FAULT) if fault else None)


class ElasticWatch:
    """Hooks on one server's engine and runtimes for phase 9: at every
    audit event, each tenant's runtime must hold on the card the variant
    the ledger says is loaded (after the staging channel's queued moves
    land; a tenant with a load in flight may hold either side of it; a
    ``pool`` or ``migrate`` event, its own tenant); at
    the ``drain`` event a tenant the drain downgraded must have dropped
    its graphs and its pool charge; after ``chip_up`` each such tenant's
    original variant must come back.  Every ``generate`` and
    ``set_variant`` is logged with its wall interval."""

    def __init__(self, srv):
        self.srv = srv
        self.gens, self.sets = [], []
        self.before, self.demoted, self.restored = {}, {}, set()
        self.drain = None  # (start, end) of the drain, perf_counter s
        self.at_up = None  # free MB and the tenants at chip_up
        self.events = 0
        self.up = False
        engine, ctl = srv.engine, srv.elastic
        event = engine._event

        def on_event(t, kind, app, mb):
            event(t, kind, app, mb)
            self.check(kind, app)

        engine._event = on_event
        if ctl is not None:
            chip_down = ctl._chip_down

            def on_chip_down(chip, now):
                st = srv.manager.state
                self.before = {n: st.tenants[n].loaded
                               for n in srv.tenants}
                t0 = time.perf_counter()
                chip_down(chip, now)
                self.drain = (t0, time.perf_counter())

            ctl._chip_down = on_chip_down
        for name, tr in srv.tenants.items():
            self._wrap(name, tr)

    def _wrap(self, name, tr):
        generate, set_variant = tr.generate, tr.set_variant

        def gen(prompts, max_new, extra=None):
            t0 = time.perf_counter()
            out = generate(prompts, max_new, extra)
            self.gens.append((name, t0, time.perf_counter(),
                              tr.loaded_bits, prompts.copy(), max_new, out))
            return out

        def setv(variant):
            was, t0 = tr.loaded_bits, time.perf_counter()
            set_variant(variant)
            self.sets.append((name, t0, time.perf_counter(), was,
                              tr.loaded_bits))

        tr.generate, tr.set_variant = gen, setv

    def check(self, kind: str, app: str) -> None:
        srv = self.srv
        st = srv.manager.state
        if kind != "pool":  # inside a batch: no wait on the channel
            srv.loader._pool.submit(lambda: None).result()
        self.events += 1
        for name, tr in srv.tenants.items():
            # A pool event comes from inside its tenant's batch, a
            # migrate event from the middle of a plan's mirror to the
            # card (the tenants of its later actions not mirrored yet):
            # each vouches for its own tenant.
            if kind in ("pool", "migrate") and name != app:
                continue
            want = st.tenants[name].loaded
            bits = {None if want is None else want.bits}
            ld = srv.loader.inflight.get(name)
            if ld is not None:
                bits.add(ld.variant.bits)
            held = tr.loaded_bits
            on_card = (tr.device_params is None if held is None else
                       all(t.is_cuda for t in _leaves(tr.device_params)))
            if held not in bits or not on_card:
                raise AssertionError(
                    f"elastic: at a {kind} event {name} holds {held}-bit "
                    f"weights (on the card: {on_card}), the ledger "
                    f"{sorted(map(str, bits))}")
        if kind == "drain":
            for name, was in self.before.items():
                now = st.tenants[name].loaded
                if was is not None and (now is None
                                        or now.bits < was.bits):
                    tr = srv.tenants[name]
                    self.demoted[name] = (was, now)
                    if (tr._graphs or tr.pool is not None or tr.pool_mb
                            or st.tenants[name].pool_mb):
                        raise AssertionError(
                            f"elastic: {name} downgraded by the drain "
                            "kept its graphs or its pool charge")
        if kind == "chip_up":
            self.up = True
            self.at_up = (st.free_mb, {
                n: (None if t.loaded is None else t.loaded.bits, t.pool_mb,
                    n in srv.loader.inflight)
                for n, t in st.tenants.items()})
        if self.up:
            for name, (was, _) in self.demoted.items():
                if st.tenants[name].loaded == was \
                        and srv.tenants[name].loaded_bits == was.bits:
                    self.restored.add(name)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def serve_elastic(fault: bool, requests: int, budget_mb=None):
    """One run of phase 9's trace on a newly built server; returns (server,
    watch, stats, trace length, kernel launches, wrapper calls, build s,
    serve s).  The profiler counts the kernels of the run (replays
    included)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.serving import poisson_trace
    from repro_torch.serving.api import EdgeServer

    t0 = time.perf_counter()
    srv = EdgeServer.build(elastic_config(fault, budget_mb), device="cuda")
    t_build = time.perf_counter() - t0
    watch = ElasticWatch(srv)
    cfgs = {n: t.cfg for n, t in srv.tenants.items()}
    trace, _ = poisson_trace(cfgs, requests_per_app=requests,
                             mean_iat_ms=400.0, seed=7)
    kernels = {k: getattr(ops, k) for k in ELASTIC_KERNELS}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = srv.engine.run_trace(trace)
        torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    calls = {k: fn.launches for k, fn in kernels.items()}
    _, counts = card_activity(prof)
    launches = {k: n for k, n in kernel_launches(counts).items()
                if k in kernels}
    srv.engine.check_event_invariant()
    srv.close()
    return (srv, watch, stats, len(trace), launches, calls, t_build,
            t_serve)


def check_elastic(requests: int) -> dict:
    """Phase 9: the elastic A/B served on the card (faulted, then clean at
    the same budget).  Fails unless every request is served in both runs,
    the budget holds at every event (globally with the graph pools, and
    per logical chip), one chip is lost and recovered, the audit trail
    holds chip_down, drain and chip_up, the runtimes hold the ledger's
    variants at every event, a drain downgrade is applied on the card
    with its graphs and pool dropped, the downgraded tenant's first batch
    equals an eager run at its new variant, the repromotion restores its
    variant, and no replay of a tenant overlaps its own drain."""
    from repro_torch.serving.server import _generate_tokens

    budget = None
    for attempt in range(ELASTIC_TRIES):
        srv, watch, stats, n, launches, calls, t_build, t_serve = \
            serve_elastic(True, requests, budget)
        ctl = srv.elastic
        unrestored = sorted(set(watch.demoted) - watch.restored)
        if ctl.drain_downgrades and not unrestored:
            break
        if not ctl.drain_downgrades:
            why = (f"the drain of chip 3 downgraded no tenant "
                   f"({ctl.drain_migrations} migrations, "
                   f"{ctl.drain_unloads} unloads), so it changed no "
                   "variant on the card: a lower budget holds one tenant "
                   "when the chip dies, whose share the survivors take "
                   "whole, a higher one holds both, and the 16-bit one's "
                   "share does not fit while its 8-bit share does")
        elif watch.at_up is None:
            why = "chip 3 did not come back within the trace"
        else:
            free, held = watch.at_up
            why = (f"the drain downgraded {unrestored}, but at chip_up "
                   f"the repromotion did not fit ({ctl.repromotions} "
                   f"made): {free:.1f} MB free, the graph pools charged "
                   + ", ".join(f"{a} {p:.1f} MB at {b} bits"
                               for a, (b, p, _) in held.items())
                   + " (a staged load of another variant drops the "
                   "tenant's graphs and pool)")
        print(f"elastic: at budget {srv.budget_mb:.1f} MB {why}; the "
              f"budget rises by {ELASTIC_STEP - 1:.0%}")
        budget = srv.budget_mb * ELASTIC_STEP
        del srv, watch
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise AssertionError("elastic: no budget gave a drain downgrade "
                             "and its repromotion")
    st = srv.manager.state
    kinds = [e.kind.value for e in srv.engine.audit_trail]
    if stats.requests != n or stats.fail_ratio or stats.weight_failures:
        raise AssertionError(f"elastic: {stats.requests} of {n} requests "
                             f"served, fail ratio {stats.fail_ratio}")
    if not (stats.chips_lost == stats.chips_recovered == 1):
        raise AssertionError(f"elastic: chips lost {stats.chips_lost}, "
                             f"recovered {stats.chips_recovered}")
    if not {"chip_down", "drain", "chip_up"} <= set(kinds):
        raise AssertionError("elastic: the audit trail lacks chip_down, "
                             "drain or chip_up")
    d0, d1 = watch.drain
    around = []
    for name in watch.demoted:
        if any(g[0] == name and g[1] < d1 and g[2] > d0
               for g in watch.gens):
            raise AssertionError(f"elastic: a generate of {name} overlaps "
                                 "its drain")
        before = sum(g[0] == name and g[2] <= d0 for g in watch.gens)
        around.append(f"{name}: {before} batches ended before the drain "
                      f"began, {sum(g[0] == name for g in watch.gens) - before}"
                      " began after it ended")
    # The drain's weight moves on the card (a restage of an unchanged
    # variant, a migration's, is a no-op).
    drain_sets = [(s[0], (s[2] - s[1]) * 1e3, s[3], s[4])
                  for s in watch.sets if d0 <= s[1] <= d1 and s[3] != s[4]]
    if not drain_sets:
        raise AssertionError("elastic: the drain moved no weights on the "
                             "card")
    firsts = []
    for name, (was, now) in watch.demoted.items():
        if now is None:
            continue
        first = next((g for g in watch.gens
                      if g[0] == name and g[1] > d1 and g[3] == now.bits),
                     None)
        if first is None:
            raise AssertionError(f"elastic: {name} served no batch at "
                                 f"{now.bits} bits after the drain")
        tr = srv.tenants[name]
        tr.pool_ledger = None
        tr.set_variant(now)
        _, _, _, _, prompts, max_new, out = first
        S = prompts.shape[1]
        with torch.inference_mode():
            want = _generate_tokens(
                tr.cfg, tr.device_params, torch.from_numpy(prompts).cuda(),
                max_new=max_new, max_len=S + max_new).cpu().numpy()
        if not np.array_equal(out, want):
            raise AssertionError(f"elastic: {name}'s first batch at "
                                 f"{now.bits} bits differs from eager")
        firsts.append(f"{name} {was.bits} -> {now.bits} bits, first batch "
                      f"{prompts.shape[0]}x{S} ids equal to eager")
    faulted = (stats, t_serve, watch, launches, calls)
    budget = srv.budget_mb
    pools = sum(1 for e in srv.engine.events if e.kind == "pool")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    srv, cwatch, cstats, cn, clean_launches, clean_calls, cb, cs = \
        serve_elastic(False, requests, budget)
    if cstats.requests != cn or cstats.fail_ratio or cstats.weight_failures:
        raise AssertionError("elastic: the clean run lost a request")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: faulted[3][k] + clean_launches[k] for k in launches}
    calls = {k: faulted[4][k] + clean_calls[k] for k in calls}
    for k in ELASTIC_KERNELS:
        if launches[k] <= 0 or calls[k] <= 0:
            raise AssertionError(f"elastic: {k} was not launched")

    def service(w):
        return sum(g[2] - g[1] for g in w.gens)

    print(f"elastic ({card()}): {ELASTIC_ARCHS} full width and depth, "
          f"mesh (4,) on one card, budget {budget:.1f} MB, "
          f"{requests} requests a tenant; build {t_build:.1f} / {cb:.1f} s, "
          f"serve (profiled) {t_serve:.1f} / {cs:.1f} s; faulted: warm "
          f"ratio {stats.warm_ratio:.4f}, service {service(watch):.3f} s; "
          f"clean: warm ratio {cstats.warm_ratio:.4f}, service "
          f"{service(cwatch):.3f} s; chips lost {stats.chips_lost}, "
          f"recovered {stats.chips_recovered}; drain_migrations "
          f"{stats.drain_migrations}, drain_downgrades "
          f"{stats.drain_downgrades}, repromotions {stats.repromotions}; "
          f"drain set_variant wall ms "
          + ", ".join(f"{a} {b} -> {c} bits {ms:.1f}"
                      for a, ms, b, c in drain_sets)
          + f"; {'; '.join(firsts)}; {'; '.join(around)}; ledger held "
          f"at {watch.events} events "
          f"({pools} pool events); kernel launches (profiler, both runs) "
          f"{launches}; wrapper calls {calls}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: training on the card
# ---------------------------------------------------------------------------
def flash_bwd_rows(cfgs) -> list:
    """(what, B, S, H, KV, D, dtype, kwargs) of the training attention:
    TRAIN_ARCH's (TRAIN_BATCH x TRAIN_SEQ) and the gemma2 cut's local and
    global layers (its window and both softcaps reach the backward)."""
    tl, gm = (cfgs[ARCHS.index(a)] for a in (TRAIN_ARCH, GEMMA_CUT[0]))
    cap = dict(softcap=gm.attn_logit_softcap)
    return [(f"train {tl.name}", TRAIN_BATCH, TRAIN_SEQ, tl.num_heads,
             tl.num_kv_heads, tl.resolved_head_dim, torch.bfloat16, {}),
            *((f"train {gm.name} {kind}", GEMMA_CUT[2], GEMMA_CUT[3],
               gm.num_heads, gm.num_kv_heads, gm.resolved_head_dim,
               torch.bfloat16, kw)
              for kind, kw in (("local", dict(cap, window=gm.sliding_window)),
                               ("global", cap)))]


def hold_grads(what, got, want, dt) -> float:
    """dq, dk, dv held element-wise to TOL[dt] and, in bf16, by relative
    l2 error (FLASH_REL_TOL); returns the worst element error."""
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        worst = max(worst, compare(f"{what} {name}", a, b, TOL[dt], TOL[dt]))
        rel = rel_l2(a.float(), b.float())
        if dt == torch.bfloat16 and rel > FLASH_REL_TOL:
            raise AssertionError(f"{what} {name}: relative l2 err {rel:.3g}"
                                 f" (tol {FLASH_REL_TOL})")
    return worst


def print_bwd_resources(source: str = "flash_attention_bwd",
                        marker: str = "flash_bwd16", count: int = 6) -> None:
    """Registers and spills of a backward source's kernels whose names
    hold ``marker`` (the attention backward's bf16 kernels; every kernel
    of the scan's backward), as ``python -m
    repro_torch.kernels.resources`` reports them; a spill or a stack
    frame fails the phase."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.resources", source],
        capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(SRC))).stdout
    lines = [ln for ln in out.splitlines() if marker in ln]
    if len(lines) != count:
        fail(f"resources: expected {count} {marker} kernels, got\n{out}")
    for ln in lines:
        print(f"  {ln}")
        if "stack 0 B, spill 0/0 B" not in ln:
            fail(f"{source}: a kernel spills: {ln}")


def check_flash_bwd(ref, g, cfgs) -> dict:
    """Phase 10 (a) and (b): the backward kernel against autograd through
    the plain version at the sweep and the training shapes, and timed at
    the training shapes."""
    from repro_torch.kernels import flash_attention as fa

    print_bwd_resources()
    worst, n = 0.0, 0
    for (B, S, H, KV, D) in FLASH_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (rand(g, B, S, n_, D, dtype=dt)
                           for n_ in (H, KV, KV, H))
            for kw in FLASH_MODES + [dict(causal=False)]:
                out, lse = fa.flash_attention_lse(q, k, v, **kw)
                worst = max(worst, hold_grads(
                    f"flash_attention_bwd {B, S, H, KV, D} {dt} {kw}",
                    fa.flash_attention_bwd(q, k, v, out, do, lse, **kw),
                    ref.flash_attention_bwd(q, k, v, do, **kw), dt))
                n += 1
    row = None
    for what, B, S, H, KV, D, dt, kw in flash_bwd_rows(cfgs):
        r = flash_bwd_row(fa, ref, g, what, B, S, H, KV, D, dt, kw)
        row = row or r
        n += 1
        torch.cuda.empty_cache()
    print(f"flash_attention_bwd: {n} cases within tolerance of autograd "
          f"through the plain version (f32 {TOL[torch.float32]}, bf16 "
          f"{TOL[torch.bfloat16]} and relative l2 {FLASH_REL_TOL}); sweep "
          f"max abs err {worst:.3g}")
    return row


def flash_bwd_row(fa, ref, g, what, B, S, H, KV, D, dt, kw) -> dict:
    """One training shape: the backward held to autograd through the
    plain version, and timed: the forward with its log-sum-exp and the
    backward (both kernels) by device time and event time, the plain
    backward (autograd over a kept graph), SDPA's backward (causal, no
    softcap or window: a yardstick), and the bound (10 D operations a
    visible (query, key) pair and head at the peak of dt, or the bytes of
    q, k, v, o, dO, dQ, dK and dV)."""
    q, k, v, do = (rand(g, B, S, n_, D, dtype=dt) for n_ in (H, KV, KV, H))
    out, lse = fa.flash_attention_lse(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o = ref.flash_attention(*leaves, **kw)
    want = torch.autograd.grad(o, leaves, do, retain_graph=True)
    err = hold_grads(f"flash_attention_bwd {what} {dt} {kw}", got, want, dt)
    del got, want

    def plain():
        return torch.autograd.grad(o, leaves, do, retain_graph=True)

    plain_ms = time_ms(plain, iters=3, warmup=1)
    del o
    torch.cuda.empty_cache()
    st = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        so = F.scaled_dot_product_attention(*st, is_causal=True,
                                            enable_gqa=True)
    sdo = do.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(so, st, sdo, retain_graph=True)

    library_ms = kernel_ms(sdpa_bwd)
    del so, st
    esz = q.element_size()
    nbytes = 4 * (q.numel() + k.numel()) * esz
    ops_ = 10 * B * H * D * visible_pairs(S, S, kw.get("window", 0))

    def bwd():
        return fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)

    row = dict(max_abs_err=err, ms=time_ms(bwd, iters=5), plain_ms=plain_ms,
               library_ms=library_ms, **bound(nbytes, ops_, dt))
    row["device_ms"] = kernel_ms(bwd)
    fwd_ms = kernel_ms(lambda: fa.flash_attention_lse(q, k, v, **kw))
    p = fa.flash_bwd_plan(B, S, S, H, KV, D, dt == torch.bfloat16,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    print(f"  {what} ({B}, {S}, {H}/{KV} heads, D={D}"
          f"{', ' + str(kw) if kw else ''}) {dt}: backward {row['ms']:.3f} "
          f"ms (event), device {row['device_ms']:.3f} ms "
          f"({row['bound_ms'] / row['device_ms']:.1%} of the bound "
          f"{row['bound_ms']:.4f} ms, {row['bound_by']}; "
          f"{ops_ / row['device_ms'] / 1e9:.1f} TFLOP/s of the gradient's "
          f"{ops_ / 1e9:.1f} GFLOP), forward with lse device "
          f"{fwd_ms:.3f} ms, plain backward {plain_ms:.3f} ms, sdpa "
          f"backward device {library_ms:.3f} ms, max abs err {err:.3g}; "
          f"{p.path} path, plan: D padded to {p.dp}, {p.big} keys (rows) "
          f"a block, {p.small} rows (keys) a step, {p.col_split} warps to "
          f"16 rows, {p.stages} stages, heads split {p.head_split} ways, "
          f"{p.threads} threads, {p.q_blocks} + {p.kv_blocks} blocks, "
          f"{p.smem} B shared, {p.sm_blocks} an SM")
    row["fwd_lse_ms"] = fwd_ms
    return row


SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")


def ssd_oracle(ref, args, dy, kq, init_state=None, dstate=None):
    """The scan backward's oracle: autograd through the plain chunked
    form at the kernel's own chunk ``kq`` (at another chunk dA, a sum
    over every token of the batch, differs past 2e-4 by the order of the
    sums alone), on the inputs widened to float64 (at 64-row chunks the
    float32 evaluation's own rounding reaches past 2e-4 on dA:
    tests/test_torch_ssd_bwd_plan.py::
    test_the_cards_oracle_is_the_float64_evaluation)."""
    def wide(t):
        return None if t is None else t.double()

    return ref.ssd_scan_bwd(*[t.double() for t in args], wide(dy), chunk=kq,
                            init_state=wide(init_state),
                            dstate=wide(dstate))


def hold_ssd_grads(what, got, want) -> float:
    """The scan's seven gradients, element-wise: float32 ones within
    SSD_TOL, bf16 ones within TOL and, by relative l2, FLASH_REL_TOL,
    against ``want`` (``ssd_oracle``).  Returns the worst element
    error."""
    worst = 0.0
    for name, a, b in zip(SSD_GRADS, got, want):
        if a is None or b is None:
            if a is not b:
                raise AssertionError(f"{what} {name}: {a} against {b}")
            continue
        tol = SSD_TOL if a.dtype == torch.float32 else TOL[a.dtype]
        b = b.to(a.dtype) if b.dtype == torch.float64 else b
        worst = max(worst, compare(f"{what} {name}", a, b, tol, tol))
        rel = rel_l2(a.float(), b.float())
        if a.dtype == torch.bfloat16 and rel > FLASH_REL_TOL:
            raise AssertionError(f"{what} {name}: relative l2 err {rel:.3g}"
                                 f" (tol {FLASH_REL_TOL})")
    return worst


def ssd_bwd_work(B, S, H, P, G, N, esz, with_init, with_dstate):
    """(bytes, operations) of one scan backward: x, dt, B, C and dy read
    and their gradients written once (the state's, its cotangent and the
    initial state's gradient when present; A, D, dA and dD); and the
    least arithmetic, the sequential form's backward: per token and head
    11 P N + 6 P (``csrc/ssd_scan_bwd.cu``'s header), and the sums of dB
    and dC over the heads of a group."""
    nbytes = (3 * B * S * H * P + 2 * B * S * H + 4 * B * S * G * N) * esz \
        + 16 * H + 4 * B * H * P * N * (2 * with_init + with_dstate)
    return nbytes, B * S * H * (11 * P * N + 6 * P) + 2 * B * S * (H - G) * N


def ssd_bwd_chunked(B, S, H, P, G, N, plan) -> tuple:
    """(operations, tensor-core operations, scratch bytes moved) of the
    kernels' chunked form at ``plan`` (``ssd_bwd_plan``), per (head,
    chunk) of Q rows: the chunk's own states S and T (2 x 2 Q P N), g B,
    dy h and x g (3 x 2 Q P N), and the Q^2 products C B^T, dy x^T, M^T
    dy, W B and W^T C (2 Q^2 (3 N + 2 P)); on the tensor cores every
    product with a float32 operand runs three times (its split), C B^T
    and dy x^T once.  The scratch: S and T written, read and written
    back as h and g by the scans, read by the gradient kernel (six
    passes over one (B, H, chunks, P, N) float32 buffer, P and N padded
    to 32), and the cluster partials of dB and dC written and read."""
    Q, chunks = plan.kq, plan.chunks
    per = B * H * chunks
    split = 10 * Q * P * N + 2 * Q * Q * (P + 2 * N)
    ops_ = per * (10 * Q * P * N + 2 * Q * Q * (3 * N + 2 * P))
    tc = per * (3 * split + 2 * Q * Q * (N + P))
    pp, np_ = -(-P // 32) * 32, -(-N // 32) * 32
    moved = 6 * 4 * per * pp * np_ + 2 * 2 * 4 * B * S * (H // plan.cluster) * N
    return ops_, tc, moved


def check_ssd_bwd(ref, g) -> dict:
    """Phase 10 (a): the scan's backward kernel against autograd through
    the plain chunked form, at the sweep in f32 and bf16, with and
    without an initial state and a final-state cotangent; then at the
    training shapes, held and timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as sm

    print_bwd_resources("ssd_scan_bwd", "ssd_bwd", 7)
    worst, n = 0.0, 0
    for shape in SSD_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            x, dt_, A, Bm, Cm, D, init = ssd_inputs(g, *shape, dt)
            args = (x, dt_, A, Bm, Cm, D)
            kq = sm.ssd_bwd_plan(*shape).kq
            dy = rand(g, *shape[:4], dtype=dt)
            dstate = rand(g, shape[0], shape[2], shape[3], shape[5],
                          scale=0.5)
            for with_init in (False, True):
                for with_ds in (False, True):
                    kw = dict(init_state=init if with_init else None,
                              dstate=dstate if with_ds else None)
                    worst = max(worst, hold_ssd_grads(
                        f"ssd_scan_bwd {shape} {dt} init={with_init} "
                        f"dstate={with_ds}", sm.ssd_scan_bwd(*args, dy, **kw),
                        ssd_oracle(ref, args, dy, kq, **kw)))
                    n += 1
    rows = []
    for arch, B, S in SSD_BWD_ROWS:
        rows.append(ssd_bwd_row(sm, ref, g, get_config(arch), B, S))
        n += 1
        torch.cuda.empty_cache()
    print(f"ssd_scan_bwd: {n} cases within tolerance of autograd through "
          f"the plain chunked form at the kernel's chunk in float64, "
          f"element-wise (f32 "
          f"{SSD_TOL}, bf16 {TOL[torch.bfloat16]} and relative l2 "
          f"{FLASH_REL_TOL}); sweep max abs err {worst:.3g}")
    return rows[0]


def ssd_bwd_row(sm, ref, g, cfg, B, S) -> dict:
    """One training shape of ``cfg``'s scan, in bf16 (the compute type),
    no initial state or final-state cotangent (as the model trains): the
    backward held to ``ssd_oracle``, and timed: the backward (its four
    kernels) by device and event time, the forward kernel's device time,
    the plain backward at the model's chunk (autograd over a kept graph)
    and the bound, at the bf16 peak of the operands' type (the f32 units'
    time for the same operations printed beside it); beside them the
    chunked form's operations and scratch bytes (``ssd_bwd_chunked``) and
    the plan."""
    shape = (B, S, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
             cfg.ssm_state)
    x, dt_, A, Bm, Cm, D, _ = ssd_inputs(g, *shape, torch.bfloat16)
    args = (x, dt_, A, Bm, Cm, D)
    dy = rand(g, *shape[:4], dtype=torch.bfloat16)
    p = sm.ssd_bwd_plan(*shape, torch.bfloat16)
    what = f"train {cfg.name} {shape}"
    err = hold_ssd_grads(f"ssd_scan_bwd {what}", sm.ssd_scan_bwd(*args, dy),
                         ssd_oracle(ref, args, dy, p.kq))
    torch.cuda.empty_cache()
    leaves = [t.detach().requires_grad_() for t in args]
    with torch.enable_grad():
        y = ref.ssd_scan_chunked(*leaves, chunk=cfg.ssm_chunk)

    def plain():
        return torch.autograd.grad(y, leaves, dy, retain_graph=True)

    plain_ms = time_ms(plain, iters=3, warmup=1)
    del y
    torch.cuda.empty_cache()

    def bwd():
        return sm.ssd_scan_bwd(*args, dy)

    nbytes, ops_ = ssd_bwd_work(*shape, 2, False, False)
    row = dict(max_abs_err=err, ms=time_ms(bwd, iters=5), plain_ms=plain_ms,
               library_ms=None, **bound(nbytes, ops_, x.dtype))
    row["device_ms"] = kernel_ms(bwd)
    row["fwd_ms"] = kernel_ms(lambda: sm.ssd_scan(*args))
    f32_ms = ops_ / peak_ops(torch.float32) * 1e3
    dev = row["device_ms"]
    c_ops, c_tc, moved = ssd_bwd_chunked(*shape, p)
    print(f"  {what} bf16: backward {row['ms']:.3f} ms (event), device "
          f"{dev:.3f} ms ({row['bound_ms'] / dev:.2%} of the bound "
          f"{row['bound_ms']:.4f} ms, {row['bound_by']} at "
          f"{peak_ops(x.dtype) / 1e12:.0f} TFLOP/s; the same "
          f"{ops_ / 1e9:.2f} GFLOP on the f32 units {f32_ms:.4f} ms, "
          f"{f32_ms / dev:.1%}; {ops_ / dev / 1e9:.2f} TFLOP/s, "
          f"{nbytes / 1e6:.1f} MB), forward kernel device "
          f"{row['fwd_ms']:.3f} ms, plain backward (chunk {cfg.ssm_chunk}) "
          f"{plain_ms:.3f} ms, max abs err {err:.3g} (oracle at chunk "
          f"{p.kq}, float64); the chunked form: {c_ops / 1e9:.2f} GFLOP "
          f"({c_tc / 1e9:.2f} on the tensor cores with the splits, "
          f"{c_tc / dev / 1e9:.1f} TFLOP/s), {moved / 1e6:.1f} MB of scratch "
          f"moved; plan: chunk {p.kq}, {p.chunks} chunks, heads in "
          f"clusters of {p.cluster}, {p.blocks} blocks in each chunk kernel "
          f"(local {p.smem_local} B, gradient {p.smem} B shared, "
          f"{p.sm_blocks} an SM), {p.scan_threads} scan threads a (sequence,"
          f" head) each way, {p.scratch / 1e6:.1f} MB of scratch")
    return row


def train_batch(ds, step: int) -> dict:
    return {k: torch.from_numpy(v).to("cuda")
            for k, v in ds.batch_at(step).items()}


def train_main(kernels, bwds, arch) -> dict:
    """Phase 10 (b) and (c): ``arch`` at full width and depth, f32 master
    weights, bf16 compute, remat, z-loss: TRAIN_STEPS AdamW steps on the
    synthetic stream, the last two with grad_accum=2.  Gates: every loss
    finite, the last below the first, every parameter leaf moved, and the
    model's forward and backward kernels launched (zeroed just before,
    read just after), the backward once a layer and micro-step.  Returns
    the wrapper launches of the run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import model_flops_for
    from repro_torch.training import pytree
    from repro_torch.training.data import DataConfig, SyntheticStream
    from repro_torch.training.optim import AdamW, warmup_cosine
    from repro_torch.training.train_step import init_state, make_train_step

    cfg = get_config(arch)
    opt = AdamW(lr=warmup_cosine(*TRAIN_LR))
    state = init_state(cfg, 0, opt, dtype=torch.float32, device="cuda")
    before = [p.detach().clone() for p in pytree.leaves(state.params)]
    step1 = make_train_step(cfg, opt, remat=True, z_loss=TRAIN_Z)
    step2 = make_train_step(cfg, opt, remat=True, z_loss=TRAIN_Z,
                            grad_accum=2)
    ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    fns = {**kernels, **bwds}
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, accum_walls = [], [], []
    prof_step = 4
    for s in range(TRAIN_STEPS):
        batch = train_batch(ds, s)
        step = step2 if s >= TRAIN_STEPS - 2 else step1
        torch.cuda.synchronize()
        if s == prof_step:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                prof_wall = (time.perf_counter() - t0) * 1e3
        else:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if s >= TRAIN_STEPS - 2:
                accum_walls.append(wall)
            elif s > 0:
                walls.append(wall)
        losses.append(float(m["loss"]))
    calls = {k: fn.launches for k, fn in fns.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {arch}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train {arch}: the loss did not fall: {losses}")
    still = [i for i, (a, b) in enumerate(zip(
        before, pytree.leaves(state.params))) if torch.equal(a, b)]
    if still:
        raise AssertionError(f"train {arch}: parameter leaves {still} never "
                             "moved")
    ms, counts = card_activity(prof)
    busy = sum(ms.values())
    fam = {k: n for k, n in kernel_launches(counts).items() if n}
    n_params = sum(p.numel() for p in before) - before[0].numel()  # embed
    tokens = TRAIN_BATCH * TRAIN_SEQ
    attn = (12 * TRAIN_BATCH * cfg.num_heads * cfg.resolved_head_dim
            * visible_pairs(TRAIN_SEQ, TRAIN_SEQ, 0) * cfg.num_layers
            if cfg.uses_attention else 0)
    inline = 6 * n_params * tokens + attn
    flops = model_flops_for(cfg, TRAIN_SEQ, TRAIN_BATCH, "train")
    med = float(np.median(walls))
    print(f"train {arch} ({card()}): full width and depth "
          f"({cfg.num_layers} layers, d_model {cfg.d_model}), f32 master, "
          f"bf16 compute, remat, z-loss {TRAIN_Z}, AdamW warmup_cosine"
          f"{TRAIN_LR}, batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; step ms median {med:.1f} ({', '.join(f'{w:.1f}' for w in walls)}"
          f"; grad_accum=2: {', '.join(f'{w:.1f}' for w in accum_walls)};"
          f" step 0 untimed), {tokens / med * 1e3:.0f} tokens/s; "
          f"model_flops {flops / 1e12:.2f} TFLOP a step (the inline "
          f"6 N T{' + attention' if attn else ''} with N "
          f"{n_params / 1e9:.3f} B without the embedding: "
          f"{inline / 1e12:.2f} TFLOP, "
          f"{inline / (med / 1e3) / peak_ops(torch.bfloat16):.1%}), "
          f"{flops / (med / 1e3) / peak_ops(torch.bfloat16):.1%} of "
          f"{peak_ops(torch.bfloat16) / 1e12:.0f} TFLOP/s; profiled "
          f"step {prof_step}: wall {prof_wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / prof_wall:.3f}, "
          f"{sum(counts.values())} kernels, the port's kernels (profiler) "
          f"{fam}; by family: {families(ms, counts)}; peak memory "
          f"{peak_gb:.2f} GB; wrapper launches over the run {calls}")
    fwd, bwd = (("ssd_scan", "ssd_scan_bwd") if cfg.family == "ssm" else
                ("flash_attention", "flash_attention_bwd"))
    if calls[fwd] == 0 or calls[bwd] == 0:
        raise AssertionError(f"train {arch}: kernels not launched {calls}")
    want_bwd = cfg.num_layers * (TRAIN_STEPS + 2)  # 2 micro-steps twice
    if calls[bwd] != want_bwd:
        raise AssertionError(f"train {arch}: {calls[bwd]} {bwd} launches, "
                             f"want {want_bwd}")
    del state, before
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def cut_config(arch: str, layers: int):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers)


def cut_setup(arch: str, layers: int, B: int, S: int):
    """A depth cut at full width: its config, f32 weights on the host
    (seed 1), the optimizer and the first batch of the stream (host)."""
    from repro_torch.models import transformer as T
    from repro_torch.training.data import DataConfig, SyntheticStream
    from repro_torch.training.optim import AdamW, warmup_cosine

    cfg = cut_config(arch, layers)
    ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B))
    return (cfg, T.init_params(cfg, 1, torch.float32, device="cpu"),
            AdamW(lr=warmup_cosine(*TRAIN_LR)),
            {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()})


def cut_step(cfg, params, opt, batch, device, compute_dtype,
             remat: bool) -> dict:
    """One train step on ``device`` from the host's ``params``: the loss,
    the gradient norm, the first moment and the params after it, flat
    f32 on the host, and the wall seconds."""
    from repro_torch.training import pytree
    from repro_torch.training.train_step import (make_train_step,
                                                 state_from_params)

    t0 = time.perf_counter()
    st, m = make_train_step(cfg, opt, remat=remat, z_loss=TRAIN_Z,
                            compute_dtype=compute_dtype)(
        state_from_params(pytree.tree_map(lambda p: p.to(device), params),
                          opt),
        {k: v.to(device) for k, v in batch.items()})
    out = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               **{name: torch.cat([x.float().cpu().ravel()
                                   for x in pytree.leaves(tree)])
                  for name, tree in (("mu", st.opt.mu),
                                     ("params", st.params))})
    out["secs"] = time.perf_counter() - t0
    return out


def host_cuts_child(out: Path) -> None:
    """The host's side of phase 10 (d), run in a child process that the
    smoke starts before phase 2, so that its CPU work overlaps the card's
    phases: each cut's train step through the plain path in bf16 (the
    card's compute type), on HOST_THREADS threads, saved under ``out``."""
    sys.path.insert(0, str(SRC))
    os.nice(19)  # the card's phases keep the CPU they need
    torch.set_num_threads(HOST_THREADS)
    for cut in HOST_CUTS:
        cfg, params, opt, batch = cut_setup(*cut)
        torch.save(cut_step(cfg, params, opt, batch, "cpu", torch.bfloat16,
                            remat=False), out / f"{cut[0]}.pt")


def start_host_cuts():
    """Start :func:`host_cuts_child`; returns (process, its directory)."""
    import shutil

    out = ROOT / "build" / "host_cuts"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    log = open(out / "child.log", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--host-cuts", str(out)], stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    return proc, out


def check_train_cut(cut, host) -> None:
    """Phase 10 (d): ``cut`` = (arch, layers, B, S), ``arch`` at full
    width cut to ``layers`` layers: one train step on the card (bf16
    compute, remat) and one through the plain path on the host (bf16
    compute; ``host_cuts_child``) from the same f32 weights and batch:
    the loss, the global gradient norm, the first moment (the clipped
    gradient, every leaf together) and the step's params held to PERF.md
    section 2's bf16 rule: relative 3e-2 from the host; past it, the
    card no further than 2x the host from the host's f32 evaluation,
    which runs only then.  The update itself (Adam's first step sends it
    to +-lr wherever a gradient is near zero) is recorded."""
    import shutil

    from repro_torch.training import pytree

    arch, layers, B, S = cut
    cfg, params, opt, batch = cut_setup(*cut)
    p0 = torch.cat([x.ravel() for x in pytree.leaves(params)])
    card = cut_step(cfg, params, opt, batch, "cuda", torch.bfloat16,
                    remat=True)
    proc, out = host
    t0 = time.perf_counter()
    if proc.wait(timeout=900) != 0:
        raise AssertionError(f"train cut: the host's child failed:\n"
                             + (out / "child.log").read_text()[-3000:])
    waited = time.perf_counter() - t0
    plain = torch.load(out / f"{arch}.pt")
    (out / f"{arch}.pt").unlink()

    def gaps(got, want):
        return dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                    grad_norm=abs(got["grad_norm"] - want["grad_norm"])
                    / want["grad_norm"],
                    grads=rel_l2(got["mu"], want["mu"]),
                    params=rel_l2(got["params"], want["params"]),
                    update=rel_l2(got["params"] - p0, want["params"] - p0))

    gap = gaps(card, plain)
    text = "against the host's bf16 run: " + ", ".join(
        f"{k} {v:.3g}" for k, v in gap.items())
    past = [k for k in ("loss", "grad_norm", "grads", "params")
            if gap[k] > TOL[torch.bfloat16]]
    if past:
        f32 = cut_step(cfg, params, opt, batch, "cpu", None, remat=False)
        card_f32, plain_f32 = gaps(card, f32), gaps(plain, f32)
        text += "; from the host's f32 evaluation, card / host bf16: " + \
            ", ".join(f"{k} {card_f32[k]:.3g} / {plain_f32[k]:.3g}"
                      for k in past)
        over = [k for k in past if card_f32[k] > 2 * plain_f32[k]]
        if over:
            raise AssertionError(f"train cut {arch}: {over} past the bf16 "
                                 f"rule: {text}")
    print(f"train cut {arch} ({layers} layers, full width, {B} x {S}): "
          f"card (bf16, remat) {text} (tol {TOL[torch.bfloat16]}, past it "
          f"2x the host's own distance from f32; the update recorded); "
          f"card {card['secs']:.1f} s, host bf16 {plain['secs']:.1f} s "
          f"({HOST_THREADS} threads, in a child process since phase 2; "
          f"waited for {waited:.1f} s here)")
    if arch == HOST_CUTS[-1][0]:
        shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()


def check_recovery() -> None:
    """Phase 10 (e), run in a child process so that cuBLAS can be given a
    fixed workspace (``CUBLAS_WORKSPACE_CONFIG``) before it starts: see
    ``recovery_child``."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--recovery-child"], capture_output=True,
                         text=True, env=env, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"recovery: the child failed:\n{out.stderr}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if not res["ok"]:
        raise AssertionError(f"recovery: {res}")
    print(f"recovery ({time.perf_counter() - t0:.1f} s, child process): "
          f"{res['text']}")


def recovery_child() -> None:
    """The cut-depth TRAIN_ARCH (CUT_LAYERS layers, full width) trained
    RECOVERY_STEPS steps by ``run_supervised`` twice under
    ``torch.use_deterministic_algorithms(True)``: unbroken, and with a
    node failure injected at step 3, checkpoints every 2 steps under
    ``build/``; the final params must be equal bit for bit.  Where an op
    has no deterministic CUDA form, it is named and the runs are held to
    1e-6 relative instead.  Prints one JSON line."""
    import shutil

    sys.path.insert(0, str(SRC))
    from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                         run_supervised)
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.training import pytree
    from repro_torch.training.data import DataConfig, SyntheticStream
    from repro_torch.training.optim import AdamW, warmup_cosine
    from repro_torch.training.train_step import (make_train_step,
                                                 state_from_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    build.build_all(("flash_attention", "flash_attention_bwd"))
    cfg = cut_config(TRAIN_ARCH, CUT_LAYERS)
    opt = AdamW(lr=warmup_cosine(*TRAIN_LR))
    params = T.init_params(cfg, 2, torch.float32, device="cuda")
    step_fn = make_train_step(cfg, opt, remat=True, z_loss=TRAIN_Z)
    ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    root = ROOT / "build" / "smoke_ckpt"

    def run(name, injector):
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        rep = run_supervised(
            init_state=state_from_params(params, opt), step_fn=step_fn,
            batch_fn=lambda s: train_batch(ds, s),
            total_steps=RECOVERY_STEPS, ckpt_dir=str(d), ckpt_every=2,
            injector=injector)
        return rep, d

    nondet = ""
    torch.use_deterministic_algorithms(True)
    try:
        a, da = run("unbroken", None)
        b, db = run("faulted", FailureInjector(fail_at_steps=(3,)))
    except RuntimeError as e:
        if "deterministic" not in str(e):
            raise
        nondet = str(e).splitlines()[0]
        torch.use_deterministic_algorithms(True, warn_only=True)
        a, da = run("unbroken", None)
        b, db = run("faulted", FailureInjector(fail_at_steps=(3,)))
    from repro_torch.distributed import checkpoint as ckpt

    template = state_from_params(params, opt)
    fa, fb = (pytree.leaves(ckpt.restore(template, str(d)))
              for d in (da, db))
    equal = all(torch.equal(x, y) for x, y in zip(fa, fb))
    worst = max(float(rel_l2(x.float(), y.float())) if x.is_floating_point()
                else float(not torch.equal(x, y)) for x, y in zip(fa, fb))
    ok = b.restarts == 1 and (equal or (nondet and worst <= 1e-6))
    shutil.rmtree(root, ignore_errors=True)
    text = (f"{cfg.name} cut to {CUT_LAYERS} layers, {RECOVERY_STEPS} steps"
            f", failure at step 3, checkpoints every 2: restarts "
            f"{b.restarts}; final params and optimizer state "
            + ("bit-equal to the unbroken run" if equal else
               f"differ from the unbroken run (worst relative l2 {worst:.3g})")
            + f"; losses {[round(x, 5) for x in a.losses]} / "
            f"{[round(x, 5) for x in b.losses]}; deterministic algorithms on"
            + (f", an op without a deterministic CUDA form: {nondet}"
               if nondet else ", no op refused"))
    print(json.dumps({"ok": bool(ok), "text": text}))


def check_training(ref, g, cfgs, kernels, host) -> tuple:
    """Phase 10: training on the card; ``host`` is ``start_host_cuts``'s.
    Returns ({kernel: its row} of the two backward kernels, the training
    runs' wrapper launches summed)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    bwds = {"flash_attention_bwd": flash_attention_bwd,
            "ssd_scan_bwd": ssd_scan_bwd}
    t0 = time.perf_counter()
    rows = {"flash_attention_bwd": check_flash_bwd(ref, g, cfgs),
            "ssd_scan_bwd": check_ssd_bwd(ref, g)}
    print(f"backward kernel checks took {time.perf_counter() - t0:.1f} s")
    calls = {}
    for arch in (TRAIN_ARCH, SSM_TRAIN_ARCH):
        t0 = time.perf_counter()
        for k, n in train_main(kernels, bwds, arch).items():
            calls[k] = calls.get(k, 0) + n
        print(f"training run {arch} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for cut in HOST_CUTS:
        check_train_cut(cut, host)
    print(f"cut-depth checks took {time.perf_counter() - t0:.1f} s")
    check_recovery()
    return rows, calls


# ---------------------------------------------------------------------------
# Phase 11: the production train cell's per-device step
# ---------------------------------------------------------------------------
def cell_step(kernels, bwds, arch) -> dict:
    """``arch``'s ``train_4k`` cell on the production mesh: its dry-run on
    ``meta`` (``run_cell``), then the cell's own step function
    (``build_cell``'s ``fn``) on the card at one device's share of the
    batch, at full width and depth from ``init_state``'s state on the
    card: one untimed step, then CELL_STEPS timed.  Gates: the cell is
    pure data-parallel with no microbatching, the state's leaves are the
    cell's stand-ins, every loss finite, every parameter leaf moved, and
    the model's forward and backward kernels launched once a layer and
    step (counts zeroed just before, read just after).  Returns the
    wrapper launches of the run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import pick_grad_accum, run_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import model_flops
    from repro_torch.launch.specs import SHAPE_SPECS
    from repro_torch.launch.steps import build_cell
    from repro_torch.training import pytree
    from repro_torch.training.data import DataConfig, SyntheticStream
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import init_state

    cfg = get_config(arch)
    mesh = make_production_mesh()
    seq, gbatch, _ = SHAPE_SPECS[CELL_SHAPE]
    t0 = time.perf_counter()
    dry = run_cell(arch, CELL_SHAPE, probe=False, verbose=False)
    dry_s = time.perf_counter() - t0
    if dry["status"] != "OK" or not dry["dp_only"]:
        raise AssertionError(f"cell {arch}: {dry['status']} dp_only="
                             f"{dry.get('dp_only')} {dry.get('error', '')}")
    accum = pick_grad_accum(cfg, CELL_SHAPE, mesh)
    rows = gbatch // mesh.size  # pure data parallelism: one device's rows
    if accum != 1 or rows != 1:
        raise AssertionError(f"cell {arch}: grad_accum {accum}, {rows} rows")
    fn, args, _, _, _ = build_cell(cfg, CELL_SHAPE, mesh, grad_accum=accum)
    state = init_state(cfg, 0, AdamW(lr=1e-4), dtype=torch.float32,
                       device="cuda")
    got = [(tuple(t.shape), t.dtype) for t in pytree.leaves(state)]
    want = [(tuple(t.shape), t.dtype) for t in pytree.leaves(args[0])]
    if got != want:
        raise AssertionError(f"cell {arch}: the state is not the cell's")
    before = [p.detach().clone() for p in pytree.leaves(state.params)]
    ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=rows))
    fns = {**kernels, **bwds}
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for s in range(CELL_STEPS + 1):
        batch = train_batch(ds, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = fn(state, batch)
        torch.cuda.synchronize()
        if s:
            walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    calls = {k: f.launches for k, f in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"cell {arch}: a loss is not finite: {losses}")
    still = [i for i, (a, b) in enumerate(zip(
        before, pytree.leaves(state.params))) if torch.equal(a, b)]
    if still:
        raise AssertionError(f"cell {arch}: parameter leaves {still} never "
                             "moved")
    med = float(np.median(walls))
    chips = mesh.size
    per_dev = model_flops(cfg, CELL_SHAPE) / chips
    t = dry["roofline"]
    mem = dry["memory"]
    state_bytes = sum(x.numel() * x.element_size()
                      for x in pytree.leaves(state))
    fwd, bwd = (("ssd_scan", "ssd_scan_bwd") if cfg.family == "ssm" else
                ("flash_attention", "flash_attention_bwd"))
    print(f"cell {arch} x {CELL_SHAPE} ({card()}): the production mesh "
          f"{dict(mesh.shape)}, pure data parallelism, grad_accum {accum}: "
          f"build_cell's step on one device's {rows} x {seq} tokens, full "
          f"width and depth ({cfg.num_layers} layers), f32 state, bf16 "
          f"compute, remat saving the tagged products: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; step ms median {med:.1f} ({', '.join(f'{w:.1f}' for w in walls)};"
          f" step 0 untimed), {rows * seq / med * 1e3:.0f} tokens/s; "
          f"model_flops / {chips} = {per_dev / 1e12:.3f} TFLOP a device, "
          f"{per_dev / (med / 1e3) / peak_ops(torch.bfloat16):.1%} of "
          f"{peak_ops(torch.bfloat16) / 1e12:.0f} TFLOP/s; dry-run on meta "
          f"({dry_s:.1f} s) a device: compute_s {t['compute_s'] * 1e3:.2f} "
          f"ms, memory_s {t['memory_s'] * 1e3:.2f} ms (each kernel's "
          f"inputs and outputs, the other operations' operands and "
          f"results), bound_s {t['bound_s'] * 1e3:.2f} ms "
          f"({t['dominant']}): the step is {med / 1e3 / t['bound_s']:.2f}x "
          f"bound_s and {med / 1e3 / t['compute_s']:.2f}x compute_s; "
          f"useful_ratio {t['useful_ratio']:.3f}; peak memory "
          f"{peak / 1e9:.2f} GB against the cell's "
          f"{mem['argument_bytes'] / 1e9:.4f} GB of arguments a device: "
          f"the card holds the whole f32 state ({state_bytes / 1e9:.2f} GB), "
          f"which ZeRO spreads over {chips} devices in the cell "
          f"({state_bytes / chips / 1e9:.4f} GB each), "
          f"{(peak - mem['argument_bytes']) / 1e9:.2f} GB more here; "
          f"{fwd} / {bwd} launches {calls[fwd]} / {calls[bwd]}")
    want_bwd = cfg.num_layers * (CELL_STEPS + 1)
    if calls[fwd] == 0 or calls[bwd] != want_bwd:
        raise AssertionError(f"cell {arch}: launches {calls}, want "
                             f"{want_bwd} {bwd}")
    del state, before
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def check_cells(kernels) -> dict:
    """Phase 11: the production train cell's per-device step of each of
    CELL_ARCHS.  Returns the runs' wrapper launches summed."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    from repro_torch.models import transformer as T

    bwds = {"flash_attention_bwd": flash_attention_bwd,
            "ssd_scan_bwd": ssd_scan_bwd}
    calls = {}
    try:
        for arch in CELL_ARCHS:
            for k, n in cell_step(kernels, bwds, arch).items():
                calls[k] = calls.get(k, 0) + n
    finally:
        from repro_torch.distributed.ctx import set_ctx

        set_ctx(None)  # build_cell's sharding context and remat policy
        T.set_remat_save_tp(True)
    return calls


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
    host = start_host_cuts()  # phase 10's host side, beside phases 2-9
    try:
        run(ops, ref, get_config, host)
    finally:
        if host[0].poll() is None:
            host[0].kill()
            host[0].wait()


def run(ops, ref, get_config, host) -> None:
    """Phases 2-12 (``main`` builds the kernels and starts the host's
    side of phase 10 first)."""
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
    t0 = time.perf_counter()
    check_forward(srv, kernels)
    print(f"forward and fidelity checks took {time.perf_counter() - t0:.1f} s")
    del srv  # phase 8 runs on a card and host the main path has left
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths = {"main": launches,
             "families": serve_families(kernels)}
    print(f"families served and checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_llama4(kernels)
    check_dense_cuts(kernels)
    print(f"depth-cut models checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["elastic"] = check_elastic(ELASTIC_REQUESTS)
    print(f"elastic A/B served and checked in "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bwd_rows, calls = check_training(ref, g, cfgs, kernels, host)
    rows.update(bwd_rows)
    paths["train"] = {k: n for k, n in calls.items() if n}
    print(f"training phase took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths["cell"] = {k: n for k, n in check_cells(kernels).items() if n}
    print(f"train cell phase took {time.perf_counter() - t0:.1f} s")

    replaces = {
        "quant_matmul": "src/repro/kernels/quant_matmul.py:102",
        "decode_attention": "src/repro/kernels/decode_attention.py:122",
        "flash_attention": "src/repro/kernels/flash_attention.py:124",
        "ssd_scan": "src/repro/kernels/ssd_scan.py:137",
        "paged_decode_attention": "src/repro/kernels/decode_attention.py:191",
        # Port-only: the gradients of those kernels (the Pallas ones have
        # none).
        "flash_attention_bwd": "src/repro/kernels/flash_attention.py:124",
        "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:137"}
    # The serving kernels run inside CUDA graphs, where their wrappers
    # are not called: their launches are the profiler's count over the
    # main path's serving run, phase 8's and phase 9's two, graph replays
    # and eager calls alike.  The paged kernel runs eagerly in the replay.
    counted_by = {k: "torch.profiler kernels over the serving runs of the "
                  "main path, the families and the elastic A/B, graph "
                  "replays and eager calls" for k in kernels}
    counted_by["paged_decode_attention"] = "wrapper calls over the replay"
    for k in ("flash_attention", "ssd_scan"):
        counted_by[k] += ("; the training runs' and the train cell's eager "
                          "calls by the wrapper")
    counted_by["flash_attention_bwd"] = (
        "wrapper calls over the training runs and the train cell (each "
        "launches the dQ and the dK/dV kernels; the profiler counted both "
        "over one step)")
    counted_by["ssd_scan_bwd"] = (
        "wrapper calls over the training runs and the train cell (each "
        "launches the local "
        "states, the scans, the gradient and the reduction kernels; the "
        "profiler counted all four over one step)")
    launches_by = {k: {p: n[k] for p, n in paths.items() if k in n}
                   for k in replaces}
    out = [dict(name=k, route="cuda", source="src/repro_torch/csrc/"
                f"{'decode_attention' if k.startswith('paged') else k}.cu",
                replaces=replaces[k], launches=sum(launches_by[k].values()),
                **rows[k], launches_by_path=launches_by[k],
                launches_counted_by=counted_by[k])
           for k in replaces]
    print(json.dumps({"kernels": out}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--recovery-child"]:  # phase 10's own children
        recovery_child()
    elif sys.argv[1:2] == ["--host-cuts"]:
        host_cuts_child(Path(sys.argv[2]))
    else:
        main()
