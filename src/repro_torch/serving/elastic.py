"""Chip-fault schedules for the elastic serving mesh.

Port of :class:`repro.serving.elastic.FaultSpec`, the declarative part
``ServingConfig`` carries.  The drain planner and ``ElasticController``
are not ported yet: a server built with ``fault=`` raises
``NotImplementedError`` (the elastic mesh needs the sharded loader).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

__all__ = ["FaultSpec"]

# (t_ms, chip, kind) schedule entry kinds.
_KINDS = ("down", "up")


@dataclass(frozen=True)
class FaultSpec:
    """A deterministic chip fault schedule on the engine clock.

    ``events`` is a sequence of ``(t_ms, chip, kind)`` with ``kind`` in
    ``{"down", "up"}``; events fire in time order when the engine clock
    reaches them (events past the end of the trace never fire).  The
    schedule is bridged through a
    :class:`~repro.distributed.fault_tolerance.FailureInjector`
    (``seed`` is its seed), so the same failure authority drives
    training restarts and serving drains.

    ``prob`` makes the ``down`` entries stochastic: each scheduled down
    fires with probability ``prob`` via the injector's counter-based
    ``(seed, step)`` stream, so faulted runs can sweep seeds while one
    seed stays bit-reproducible.  The default ``prob=0.0`` keeps the
    deterministic path: every listed down fires, exactly as before.
    """

    events: Tuple[Tuple[float, int, str], ...] = ()
    seed: int = 0
    prob: float = 0.0

    def __post_init__(self) -> None:
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"fault prob must be in [0, 1], "
                             f"got {self.prob}")
        norm = []
        for ev in self.events:
            t, chip, kind = ev
            if kind not in _KINDS:
                raise ValueError(f"bad fault event kind {kind!r} in {ev}")
            if t < 0 or int(chip) < 0:
                raise ValueError(f"bad fault event {ev}")
            norm.append((float(t), int(chip), str(kind)))
        norm.sort(key=lambda e: e[0])
        object.__setattr__(self, "events", tuple(norm))

    def with_seed(self, seed: int) -> "FaultSpec":
        """The same schedule under a different injector seed — the
        seed-sweep idiom: ``spec.with_seed(s)`` per benchmark seed,
        each run bit-reproducible on its own stream."""
        return replace(self, seed=seed)
