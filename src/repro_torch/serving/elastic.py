"""Elastic serving mesh: chip loss & recovery as transactional drain plans.

Port of :mod:`repro.serving.elastic`: the same plans from the same
state, so a faulted sim run equals the reference's bit for bit.  On the
card a drain's ``Downgrade`` reaches ``TenantRuntime.set_variant``
through the manager and the loader's staging channel, which drops the
tenant's CUDA graphs with the old variant; the ledger clears the pool
charge in the same ``apply``.

A production edge box loses accelerators mid-serve; Edge-MultiAI's
premise — latency-sensitive tenants keep serving under contention — has
to survive that, not just memory pressure.  This module makes device
availability a first-class scheduling input (cf. Liang et al.,
"Model-driven Cluster Resource Management for AI Workloads in Edge
Clouds") by expressing a chip's death as *one* residency plan:

* :class:`FaultSpec` — a declarative chip-down/chip-up schedule on the
  engine clock, carried by ``ServingConfig``;
* :func:`drain_plan` — the pure planner: vacate the dead chip with
  ``MigrateShard`` rehomings where live chips have room, ``Downgrade`` +
  migrate where only a smaller variant fits, ``Unload`` where nothing
  does, plus ``EvictKV`` for sequences holding KV pages on the chip;
* :func:`rebalance_plan` — the reverse migration toward the canonical
  layout when the chip returns;
* :class:`ElasticController` — bridges
  :class:`~repro_torch.distributed.fault_tolerance.FailureInjector` into the
  serving loop: the engine polls it each iteration, and a due ``down``
  event raises :class:`~repro_torch.distributed.fault_tolerance.NodeFailure`
  through the injector, which the controller converts into offline
  ledger/pool bookkeeping + one simulate-validated, all-or-nothing
  drain plan applied through the manager while other tenants keep
  decoding.

Deliberately imports nothing from ``serving.engine``/``serving.server``
(the engine imports *us*): the controller talks to the world through
the manager, the loader protocol, and plain callbacks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional,
                    Sequence, Tuple)

from repro_torch.core import actions as A
from repro_torch.core.policies import variant_score
from repro_torch.distributed.fault_tolerance import FailureInjector, NodeFailure

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.manager import EdgeMultiAI
    from repro_torch.core.memory_state import MemoryState
    from repro_torch.core.model_zoo import ModelVariant

__all__ = ["ElasticController", "FaultSpec", "drain_plan",
           "rebalance_plan"]

EPS = A.EPS

# (t_ms, chip, kind) schedule entry kinds.
_KINDS = ("down", "up")


@dataclass(frozen=True)
class FaultSpec:
    """A deterministic chip fault schedule on the engine clock.

    ``events`` is a sequence of ``(t_ms, chip, kind)`` with ``kind`` in
    ``{"down", "up"}``; events fire in time order when the engine clock
    reaches them (events past the end of the trace never fire).  The
    schedule is bridged through a
    :class:`~repro_torch.distributed.fault_tolerance.FailureInjector`
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


def _fill(remaining: float, rooms: Dict[int, float]
          ) -> Optional[List[Tuple[int, float]]]:
    """Greedily place ``remaining`` MB across chips with ``rooms`` free
    (roomiest first, ties to the lowest chip); None when it cannot all
    land."""
    out: List[Tuple[int, float]] = []
    for j in sorted(rooms, key=lambda j: (-rooms[j], j)):
        if remaining <= EPS:
            break
        take = min(remaining, rooms[j])
        if take > EPS:
            out.append((j, take))
            remaining -= take
    return out if remaining <= EPS else None


def drain_plan(state: "MemoryState", dead: int, *, now: float = 0.0
               ) -> Tuple[Tuple[A.Action, ...], Dict[str, int],
                          Tuple[Tuple[str, int], ...], float]:
    """Plan the evacuation of chip ``dead`` (already taken offline, so
    its budget reads zero).

    Tenants holding weights on the chip are handled in *descending*
    ``accuracy · readiness`` order (the :func:`~repro_torch.core.policies.
    variant_score` CostBFE ranks procurement with, evaluated at ``now``;
    ties break by name): the residents worth the most by their next
    predicted request claim the survivors' free room first and migrate
    intact, so the degradation cascade lands on the variants that were
    cheapest to lose.  Per tenant: (a) migrate the dead-chip shard to
    live chips with room (split across chips if needed); (b) else walk
    the zoo down to the largest variant whose (layout-preserving)
    dead-chip share the survivors can absorb, downgrading then
    migrating; (c) else unload.  Sequences holding KV pages on the chip
    are evicted (their pages land in the pool's offline stash) and
    returned as preempted ``(app, seq)`` pairs for the engine to
    requeue.

    Returns ``(actions, counters, preempted, vacated_mb)``.  The plan is
    feasible by construction — the worst case degrades to pure unloads —
    but callers still ``simulate`` before ``apply``.
    """
    led = state.devices
    if led is None:
        raise A.PlanError("drain_plan without a DeviceLedger")
    n = led.n_devices
    used = [led.used_mb(d) for d in range(n)]
    counters = {"migrations": 0, "downgrades": 0, "unloads": 0}
    acts: List[A.Action] = []
    vacated = 0.0

    def rank(app: str) -> float:
        t = state.tenants[app]
        if t.loaded is None:
            return 0.0
        pred = t.predicted_next
        idle = math.inf if pred is None or math.isinf(pred) \
            else max(pred - now, 0.0)
        return variant_score(t.loaded, idle)

    for app in sorted(led.weights, key=lambda a: (-rank(a), a)):
        cur = list(led.weights[app])
        share = cur[dead]
        if share <= EPS:
            continue
        vacated += share
        t = state.tenants[app]
        rooms = {j: led.budgets_mb[j] - used[j]
                 for j in range(n) if j != dead}

        # (a) Rehome the shard as-is.
        placed = _fill(share, rooms)
        if placed is not None:
            for j, mb in placed:
                acts.append(A.MigrateShard(app, dead, j, mb))
                used[j] += mb
                counters["migrations"] += 1
            used[dead] -= share
            continue

        # (b) Downgrade until the (smaller) dead-chip share fits.
        total = sum(cur)
        planned = None
        v = t.loaded
        while v is not None and planned is None:
            v = t.zoo.next_smaller(v)
            if v is None:
                break
            # Layout-preserving projection — exactly what Downgrade will
            # commit through DeviceLedger.projected.
            scale = sum(led.split(app, v)) / total
            proj = [w * scale for w in cur]
            rooms_after = {
                j: led.budgets_mb[j] - used[j] + (cur[j] - proj[j])
                for j in range(n) if j != dead}
            placed = _fill(proj[dead], rooms_after)
            if placed is not None:
                planned = (v, proj, placed)
        if planned is not None:
            v, proj, placed = planned
            # A drain downgrade always targets a lower-bits sibling of
            # the resident variant, so it requantizes in place — the
            # degraded layout lands with zero bytes over the host link.
            acts.append(A.downgrade_action(app, t.loaded, v))
            counters["downgrades"] += 1
            for d in range(n):
                used[d] += proj[d] - cur[d]
            for j, mb in placed:
                acts.append(A.MigrateShard(app, dead, j, mb))
                used[j] += mb
                counters["migrations"] += 1
            used[dead] -= proj[dead]
            continue

        # (c) Nothing fits anywhere: the tenant goes cold.
        acts.append(A.Unload(app))
        counters["unloads"] += 1
        for d in range(n):
            used[d] -= cur[d]

    preempted: Tuple[Tuple[str, int], ...] = ()
    if state.kv_pool is not None:
        preempted = tuple(state.kv_pool.seqs_on_device(dead))
        for app, seq in preempted:
            acts.append(A.EvictKV(app, 0.0, seq=seq))

    return tuple(acts), counters, preempted, vacated


def rebalance_plan(state: "MemoryState", chip: int,
                   *, exclude: Sequence[str] = ()
                   ) -> Tuple[A.Action, ...]:
    """Reverse migration when ``chip`` comes back: move each tenant's
    surplus (held above canonical on the chips that absorbed it) toward
    its canonical share on the restored chip.  Tenants with in-flight
    loads are left alone — their commit re-derives placement anyway."""
    led = state.devices
    if led is None:
        raise A.PlanError("rebalance_plan without a DeviceLedger")
    acts: List[A.Action] = []
    used = list(led.device_used())
    frozen = set(exclude) | set(led.inflight)
    for app in sorted(led.weights):
        if app in frozen:
            continue
        loaded = state.tenants[app].loaded
        if loaded is None:
            continue
        cur = list(led.weights[app])
        canon = led.split(app, loaded)
        deficit = min(canon[chip] - cur[chip],
                      led.budgets_mb[chip] - used[chip])
        if deficit <= EPS:
            continue
        order = sorted((j for j in range(led.n_devices) if j != chip),
                       key=lambda j: (-(cur[j] - canon[j]), j))
        for j in order:
            if deficit <= EPS:
                break
            surplus = cur[j] - canon[j]
            if surplus <= EPS:
                continue
            mb = min(deficit, surplus)
            acts.append(A.MigrateShard(app, j, chip, mb))
            used[j] -= mb
            used[chip] += mb
            cur[j] -= mb
            cur[chip] += mb
            deficit -= mb
    return tuple(acts)


class ElasticController:
    """Fires a :class:`FaultSpec` on the engine clock.

    The engine calls :meth:`poll` each maintenance pass (and folds
    :meth:`next_event_ms` into its idle wake-up), so faults land at
    their scheduled instant even on an idle mesh.  A ``down`` event:

    1. cancels in-flight loads that claim the chip or belong to tenants
       holding weights there (the existing loader lifecycle — budget
       claims unwind shard-by-shard);
    2. takes the ledger budget and KV pages offline;
    3. builds one :func:`drain_plan`, validates it with
       ``state.simulate``, and applies it all-or-nothing through
       ``manager._apply_actions`` — the same mirror path admission
       migration uses, so variant changes restage and ``migrate``
       events flow;
    4. records preempted sequences with the manager so the continuous
       engine requeues them.

    An ``up`` event restores the budget/pages and applies a best-effort
    :func:`rebalance_plan`.  ``on_event(t, kind, app, mb)`` mirrors
    ``chip_down`` / ``chip_up`` / ``drain`` into the engine's audit
    stream; ``on_reshard(app)`` lets a real executor re-place buffers
    after a plan lands.
    """

    def __init__(self, spec: FaultSpec, manager: "EdgeMultiAI",
                 loader=None):
        state = manager.state
        if state.devices is None:
            raise ValueError("elastic serving requires a device ledger "
                             "(LoaderSpec(sharded=True))")
        n = state.devices.n_devices
        for t, chip, kind in spec.events:
            if chip >= n:
                raise ValueError(
                    f"fault event targets chip {chip} of a "
                    f"{n}-device mesh")
        self.spec = spec
        self.manager = manager
        self.loader = loader
        # The training-world failure authority, keyed by schedule index:
        # a scheduled "down" only drains if the injector actually fires.
        # prob > 0 switches the injector to its counter-based (seed,
        # step) stream — the same schedule becomes a seed-sweepable
        # failure distribution.
        if spec.prob > 0.0:
            self.injector = FailureInjector(prob=spec.prob,
                                            seed=spec.seed)
        else:
            self.injector = FailureInjector(
                fail_at_steps=tuple(i for i, ev in enumerate(spec.events)
                                    if ev[2] == "down"),
                seed=spec.seed)
        self._next = 0
        self.on_event: Optional[Callable[[float, str, str, float],
                                         None]] = None
        self.on_reshard: Optional[Callable[[str], None]] = None
        self.chips_lost = 0
        self.chips_recovered = 0
        self.drain_migrations = 0
        self.drain_downgrades = 0
        self.drain_unloads = 0
        self.repromotions = 0
        # Pre-drain variants of tenants a drain degraded, awaiting
        # re-promotion when a chip returns.
        self._demoted: Dict[str, "ModelVariant"] = {}

    # -- engine protocol -------------------------------------------------
    def next_event_ms(self) -> float:
        if self._next >= len(self.spec.events):
            return math.inf
        return self.spec.events[self._next][0]

    def poll(self, now_ms: float) -> None:
        """Fire every schedule entry due at ``now_ms``."""
        while (self._next < len(self.spec.events)
               and self.spec.events[self._next][0] <= now_ms + 1e-9):
            idx = self._next
            _, chip, kind = self.spec.events[idx]
            self._next += 1
            if kind == "down":
                try:
                    self.injector.check(idx)
                except NodeFailure:
                    self._chip_down(chip, now_ms)
            else:
                self._chip_up(chip, now_ms)

    # -- internals -------------------------------------------------------
    def _emit(self, t: float, kind: str, app: str, mb: float) -> None:
        if self.on_event is not None:
            self.on_event(t, kind, app, mb)

    def _affected(self, acts: Sequence[A.Action]) -> Tuple[str, ...]:
        return tuple(sorted({a.app for a in acts
                             if isinstance(a, (A.Downgrade, A.Unload,
                                               A.MigrateShard))}))

    def _chip_down(self, chip: int, now: float) -> None:
        state = self.manager.state
        led = state.devices
        if chip in led._offline:
            return
        # In-flight loads touching the chip unwind through the existing
        # cancel lifecycle before the budget shrinks.
        if self.loader is not None:
            for app in sorted(self.loader.inflight):
                ld = self.loader.inflight[app]
                claims = getattr(ld, "shard_claims", None)
                touches = claims is not None and claims[chip] > EPS
                holds = led.weights.get(app, ())
                holds = bool(holds) and holds[chip] > EPS
                if touches or holds:
                    self.loader.cancel(app, now)
        # Emit before the budget shrinks: the event snapshots per-device
        # budgets, and the drain that reconciles the chip has not
        # applied yet at this instant.
        self._emit(now, "chip_down", f"chip{chip}",
                   -led.budgets_mb[chip])
        led.offline(chip)
        if state.kv_pool is not None:
            state.kv_pool.offline_device(chip)

        acts, counters, preempted, vacated = drain_plan(state, chip,
                                                        now=now)
        if acts:
            msg = state.simulate(A.ResidencyPlan(acts))
            if msg is not None:
                # Pure-shed fallback: always feasible (only frees).
                acts = tuple(
                    [A.Unload(a) for a in sorted(led.weights)
                     if led.weights[a][chip] > EPS]
                    + [A.EvictKV(a, 0.0, seq=s) for a, s in preempted])
                counters = {"migrations": 0, "downgrades": 0,
                            "unloads": sum(
                                1 for a in acts
                                if isinstance(a, A.Unload))}
            # Remember what each degraded tenant held before the drain,
            # so chip_up can restore it.  setdefault: across stacked
            # drains the *original* variant is the re-promotion target.
            for a in acts:
                if isinstance(a, (A.Downgrade, A.Unload)):
                    was = state.tenants[a.app].loaded
                    if was is not None:
                        self._demoted.setdefault(a.app, was)
            self.manager._apply_actions(acts, now=now)
        for app, seq in preempted:
            self.manager.kv_preemptions += 1
            self.manager._preempted.append((app, seq))
        self.chips_lost += 1
        self.drain_migrations += counters["migrations"]
        self.drain_downgrades += counters["downgrades"]
        self.drain_unloads += counters["unloads"]
        self._emit(now, "drain", f"chip{chip}", -vacated)
        if self.on_reshard is not None:
            for app in self._affected(acts):
                self.on_reshard(app)

    def _chip_up(self, chip: int, now: float) -> None:
        state = self.manager.state
        led = state.devices
        if chip not in led._offline:
            return
        restored = led._offline[chip]
        led.online(chip)
        if state.kv_pool is not None:
            state.kv_pool.restore_device(chip)
        self._emit(now, "chip_up", f"chip{chip}", restored)
        acts = rebalance_plan(state, chip)
        if acts and state.simulate(A.ResidencyPlan(acts)) is None:
            self.manager._apply_actions(acts, now=now)
            if self.on_reshard is not None:
                for app in self._affected(acts):
                    self.on_reshard(app)
        self.chips_recovered += 1
        self._repromote(now)

    def _repromote(self, now: float) -> None:
        """Restore the variants a drain degraded, now that capacity is
        back: a staged load through the loader when one is attached (the
        transfer overlaps serving, exactly like a prefetch — committing
        before the tenant's next request makes that admission warm),
        else a synchronous ``Load``.  Each attempt is simulate-validated;
        a target that no longer fits is dropped rather than retried
        forever."""
        state = self.manager.state
        for app in sorted(self._demoted):
            want = self._demoted[app]
            t = state.tenants[app]
            if t.loaded is not None and t.loaded.size_mb >= want.size_mb:
                del self._demoted[app]
                continue
            if self.loader is not None and app in self.loader.inflight:
                continue  # the loader owns this tenant's residency;
                # a later chip_up (or the load itself) resolves it
            if self.loader is not None:
                plan = A.ResidencyPlan(
                    (A.staged_load_action(state, app, want),))
                if state.simulate(plan) is None \
                        and self.loader.execute(plan, now) is not None:
                    self.repromotions += 1
            else:
                # A bare Load is device-blind by design (admission may
                # transiently overshoot a chip mid-downgrade), so mirror
                # the per-device commit check here: fits_variant
                # validates exactly the layout on_load will write.
                plan = A.ResidencyPlan((A.Load(app, want),))
                if state.simulate(plan) is None \
                        and state.devices.fits_variant(app, want):
                    self.manager._apply_actions(plan.actions, now=now)
                    self.repromotions += 1
                    if self.on_reshard is not None:
                        self.on_reshard(app)
            del self._demoted[app]
