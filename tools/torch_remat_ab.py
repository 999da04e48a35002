#!/usr/bin/env python3
"""Training step time and peak memory with the remat that keeps the
``"tp_out"`` products (``set_remat_save_tp(True)``) against plain remat
(``False``), on one card.

    python3 tools/torch_remat_ab.py [--archs tinyllama-1.1b mamba2-780m]

Needs a CUDA card.  For each model at full width and depth, phase 10's
step of ``chip_smoke.py`` (f32 master, bf16 compute, remat, z-loss, AdamW,
the synthetic stream at ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens): the
policy off, on, on, off in turns, each turn one untimed step and
``--steps`` timed, then one profiled step (device busy ms and kernels);
prints each turn's median step ms, busy ms and peak memory, and last one
JSON line with the card and every turn.  Both settings give the same
losses.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def turn(cfg, save: bool, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T
    from repro_torch.training.data import DataConfig, SyntheticStream
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import init_state, make_train_step

    T.set_remat_save_tp(save)
    opt = AdamW(lr=1e-4)
    state = init_state(cfg, 0, opt, device="cuda")
    step = make_train_step(cfg, opt, remat=True, z_loss=smoke.TRAIN_Z)
    ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=smoke.TRAIN_SEQ,
                                    global_batch=smoke.TRAIN_BATCH))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for s in range(steps + 1):
        batch = smoke.train_batch(ds, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        if s:
            walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    batch = smoke.train_batch(ds, steps + 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    ms, counts = smoke.card_activity(prof)
    out = dict(save_tp=save, step_ms=float(np.median(walls)), walls=walls,
               busy_ms=sum(ms.values()), kernels=sum(counts.values()),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses)
    del state
    torch.cuda.empty_cache()
    T.set_remat_save_tp(True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+",
                    default=[smoke.TRAIN_ARCH, smoke.SSM_TRAIN_ARCH])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_remat_ab: no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    card = smoke.card()
    build.build_all(("flash_attention", "flash_attention_bwd", "ssd_scan",
                     "ssd_scan_bwd"))
    rows = {}
    for arch in args.archs:
        cfg = get_config(arch)
        rows[arch] = [turn(cfg, save, args.steps)
                      for save in (False, True, True, False)]
        for r in rows[arch]:
            print(f"{arch} ({card}) save_tp={r['save_tp']}: step ms median "
                  f"{r['step_ms']:.1f} ({', '.join(f'{w:.1f}' for w in r['walls'])}), "
                  f"device busy {r['busy_ms']:.1f} ms / {r['kernels']} "
                  f"kernels a step, peak {r['peak_gb']:.2f} GB, losses "
                  + ", ".join(f"{x:.4f}" for x in r["losses"]), flush=True)
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
