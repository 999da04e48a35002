"""Training launcher.

Port of :mod:`repro.launch.train`.  ``--reduced`` really trains the
reduced config on ``--device`` (default ``cuda``; asking for it without
a card raises) through :func:`~repro_torch.distributed.fault_tolerance.run_supervised`:
warmup-cosine AdamW, remat, optional gradient accumulation and int8
gradient compression, checkpoints every ``--ckpt-every`` steps, and
injected node failures at ``--fail-at`` steps that the supervisor
recovers from.  Without ``--reduced`` the launcher takes the full config's
path, as the reference's does: the ``train_4k`` cell's dry-run on the
production mesh (:func:`repro_torch.launch.dryrun.run_cell`, the step run
on ``meta`` tensors and priced against one H100's roofline; no device
is touched).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --reduced --steps 50 --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     run_supervised)
from repro_torch.serving.server import resolve_device
from repro_torch.training.data import DataConfig, SyntheticStream
from repro_torch.training.optim import AdamW, warmup_cosine
from repro_torch.training.train_step import init_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--moe-impl", default="dense")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not args.reduced:
        # Full-config path: delegate to the dry-run cell.
        from repro_torch.launch.dryrun import run_cell

        result = run_cell(args.arch, "train_4k", probe=False)
        if result["status"] != "OK":
            raise SystemExit(f"train_4k cell of {args.arch}: "
                             f"{result['status']}")
        return

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    opt = AdamW(lr=warmup_cosine(args.lr, 10, args.steps),
                weight_decay=0.01)
    step_fn = make_train_step(
        cfg, opt, moe_impl=args.moe_impl, remat=True,
        grad_accum=args.grad_accum, compression=args.compression)
    state = init_state(cfg, args.seed, opt, compression=args.compression,
                       device=device)
    ds = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(device)
                for k, v in ds.batch_at(step).items()}

    t0 = time.time()
    report = run_supervised(
        init_state=state, step_fn=step_fn, batch_fn=batch_fn,
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        injector=(FailureInjector(fail_at_steps=tuple(args.fail_at))
                  if args.fail_at else None))
    dt = time.time() - t0
    print(f"arch={cfg.name} device={device} "
          f"steps={report.steps_completed} restarts={report.restarts} "
          f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f} "
          f"({dt:.1f}s, {report.steps_completed / dt:.2f} steps/s)")


if __name__ == "__main__":
    main()
