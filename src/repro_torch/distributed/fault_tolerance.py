"""Fault tolerance: failure injection and the supervised
checkpoint/restart loop.

Port of :mod:`repro.distributed.fault_tolerance`.
:class:`FailureInjector` draws from the same counter-based
``(seed, step)`` numpy stream, so a schedule fires on the same steps as
the reference's; the serving stack's elastic mesh bridges chip faults
through it.  :func:`run_supervised` wraps a step function in a
supervise-restore-continue loop over :mod:`repro_torch.distributed.checkpoint`:
the data pipeline is step-indexed and checkpoints are atomic, so a run
with injected failures ends where an unbroken run does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.distributed import checkpoint as ckpt


class NodeFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic failure schedule (or probabilistic with a seed)."""
    fail_at_steps: tuple = ()
    prob: float = 0.0
    seed: int = 0
    _fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise NodeFailure(f"injected node failure at step {step}")
        if self.prob > 0.0:
            rng = np.random.default_rng((self.seed, step))
            if rng.random() < self.prob and step not in self._fired:
                self._fired.add(step)
                raise NodeFailure(f"random node failure at step {step}")


@dataclass
class RunReport:
    steps_completed: int
    restarts: int
    final_metrics: Dict[str, float]
    losses: list


def run_supervised(
    *,
    init_state: Any,
    step_fn: Callable,  # (state, batch) -> (state, metrics)
    batch_fn: Callable,  # step -> batch
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    injector: Optional[FailureInjector] = None,
    max_restarts: int = 10,
    async_save: bool = True,
) -> RunReport:
    """Run to ``total_steps``, surviving injected failures via restore
    from the latest checkpoint (or from ``init_state`` when there is
    none); resumes from ``ckpt_dir``'s latest checkpoint if one exists."""
    saver = ckpt.AsyncCheckpointer()
    restarts = 0
    losses = []
    state = init_state
    step = 0
    last = ckpt.latest_step(ckpt_dir)
    if last is not None:
        state = ckpt.restore(init_state, ckpt_dir, last)
        step = last

    metrics: Dict[str, float] = {}
    while step < total_steps:
        try:
            if injector is not None:
                injector.check(step)
            batch = batch_fn(step)
            state, m = step_fn(state, batch)
            metrics = {k: float(v) for k, v in m.items()}
            losses.append(metrics.get("loss", float("nan")))
            step += 1
            if step % ckpt_every == 0 or step == total_steps:
                if async_save:
                    saver.save_async(state, ckpt_dir, step)
                else:
                    ckpt.save(state, ckpt_dir, step)
        except NodeFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            saver.wait()
            last = ckpt.latest_step(ckpt_dir)
            if last is None:
                state, step = init_state, 0
            else:
                state = ckpt.restore(init_state, ckpt_dir, last)
                step = last
    saver.wait()
    return RunReport(step, restarts, metrics, losses)
