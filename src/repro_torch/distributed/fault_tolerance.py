"""Failure injection: the deterministic failure authority.

Port of :class:`repro.distributed.fault_tolerance.NodeFailure` and
:class:`~repro.distributed.fault_tolerance.FailureInjector`, with the
same counter-based ``(seed, step)`` numpy stream, so a schedule fires on
the same steps as the reference's.  The serving stack's elastic mesh
bridges chip faults through it.  The supervised checkpoint/restart loop
(``run_supervised``) needs checkpointing and waits for the distributed
remainder (ROADMAP A10).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


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
