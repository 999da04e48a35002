"""End-to-end training driver on the PyTorch port: train a reduced LM for
a few hundred steps with the full stack — mixed precision, remat,
gradient accumulation, int8+error-feedback gradient compression, async
atomic checkpointing, and two injected node failures that the supervisor
recovers from (the port of ``examples/train_small_lm.py``).

    PYTHONPATH=src python examples/torch_train_small_lm.py --steps 200 \
        --device cpu
"""
import argparse
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

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="tinyllama-1.1b")
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

device = resolve_device(args.device)
cfg = get_config(args.arch, reduced=True)
print(f"training {cfg.name}: {cfg.param_count():,} params, "
      f"batch={args.batch} seq={args.seq} on {device}")

opt = AdamW(lr=warmup_cosine(3e-3, 20, args.steps), weight_decay=0.01)
step_fn = make_train_step(cfg, opt, remat=True, grad_accum=2,
                          compression=True, compute_dtype=None)
state = init_state(cfg, 0, opt, compression=True, device=device)
ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=args.seq,
                                global_batch=args.batch))


def batch_fn(step):
    return {k: torch.from_numpy(v).to(device)
            for k, v in ds.batch_at(step).items()}


with tempfile.TemporaryDirectory() as ckpt_dir:
    t0 = time.time()
    report = run_supervised(
        init_state=state, step_fn=step_fn, batch_fn=batch_fn,
        total_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=25,
        injector=FailureInjector(
            fail_at_steps=(args.steps // 3, 2 * args.steps // 3)))
    dt = time.time() - t0

print(f"\ndone: {report.steps_completed} steps in {dt:.1f}s "
      f"({report.steps_completed / dt:.2f} steps/s), "
      f"{report.restarts} node failures survived")
print(f"loss: {report.losses[0]:.4f} -> {report.losses[-1]:.4f}")
every = max(len(report.losses) // 10, 1)
print("curve:", " ".join(f"{x:.3f}" for x in report.losses[::every]))
assert report.losses[-1] < report.losses[0], "loss must decrease"
