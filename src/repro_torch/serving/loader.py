"""Background model-loading pipeline: staging tenant weights off the hot
path (the live-engine half of the paper's iWS-BFE prefetch story).

Table 1 of the paper measures model *load* time at 8-17x inference time —
which is exactly why Edge-MultiAI fires proactive loads at t_pred - Delta
- theta instead of waiting for the request.  PR 1's engine still enacted
every load synchronously inside the admit path, so one tenant's cold
start stalled every other tenant's decode loop.  This module closes that
gap:

* **One staging channel.**  Every physical weight movement — prefetches,
  demand loads, victim downgrades, synchronous admission-path loads —
  funnels through a single worker thread (:meth:`BackgroundLoader.stage`).
  That gives a total order over device mutations that matches the order
  of the accounting mutations on the engine thread, so a victim's
  background downgrade can never land *after* a later reactive reload of
  the same tenant.

* **In-flight memory charges.**  An enqueued load immediately claims the
  memory its commit will add (``MemoryState.reserve_inflight``), so
  eviction/procurement planning against ``free_mb`` cannot double-book
  memory a prefetch already owns; a cancelled prefetch releases the
  charge.  Tenants mid-staging are exempt from victim selection (see
  ``repro_torch.core.policies``) — the loader owns their residency until the
  load commits or is cancelled.

* **Virtual-time completion.**  A load enqueued at virtual time ``t``
  commits at ``t + variant.load_ms`` (the zoo's measured transfer time),
  while the wall-clock host-to-device copy runs on the worker.  The engine
  defers batches whose tenant is mid-staging and keeps serving everyone
  else — the load is *overlapped*, and the overlap is measured
  (``load_overlap_ms``) as the time other tenants spent executing inside
  the load interval.

Every residency mutation here is expressed in the action IR
(:mod:`repro_torch.core.actions`) and committed through the one transactional
applier, ``MemoryState.apply``: :meth:`BackgroundLoader.execute` takes a
:class:`~repro_torch.core.actions.ResidencyPlan`, applies it atomically (a
stale plan rolls back whole — its evictions are *not* left behind), then
translates each action to this loader's physical stage ops; per-action
completion callbacks fire as each action's effect lands (instantaneous
actions immediately, a staged load's at commit).  ``enqueue`` survives
as the ProcurePlan-shaped wrapper.

Lifecycle of one load (the action-record state machine: ``staging`` →
``committed`` | ``cancelled``, one-way — a record that has left
``staging`` can never release its claim again)::

    execute([... , Load(staged=True)])
                   ->  in-flight (claim reserved, evictions enacted,
                       device_put queued on the worker)
        |-- reap(now >= ready_ms)  ->  committed (Load commit applied:
        |                              claim converts to weights,
        |                              awaiting first use)
        |       |-- first admit    ->  prefetch hit (warm) or demand-cold
        |-- shrink_inflight(..)    ->  claim shrunk to a smaller variant
        |                              (one smaller transfer instead of
        |                              cancel-then-demand)
        |-- cancel(..)             ->  cancelled (claim released, device
                                       restored, counted as wasted)
"""
from __future__ import annotations

import math
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import actions as A
from repro_torch.core.model_zoo import ModelVariant
from repro_torch.core.policies import ProcurePlan
from repro_torch.distributed.compression import wire_compression_ratio
from repro_torch.serving.events import MonotoneQueue

INF = math.inf

# (t_ms, kind, app, mb) — the engine mirrors these into its audit trail.
LoadEventHook = Callable[[float, str, str, float], None]

# (action, t_ms) — per-action completion hook for LoaderChannel.execute.
ActionHook = Callable[[A.Action, float], None]


@dataclass
class InflightLoad:
    """One background load between enqueue and commit/cancel."""
    app: str
    variant: ModelVariant
    t_enqueue_ms: float
    ready_ms: float  # virtual completion: t_enqueue + variant.load_ms
    charge_mb: float  # in-flight claim = what the commit will add
    demand: bool  # a request is already waiting (vs. predictor-driven)
    predicted_ms: float  # the prediction that justified a prefetch
    future: Future  # the wall-clock device staging task
    # Action-record state machine: "staging" -> "committed"|"cancelled".
    # One-way: release/commit paths check-and-set, so a stale reference
    # (e.g. a cancel racing a shrink's restage) can never double-release
    # the claim — the new record owns it.
    state: str = field(default="staging")
    on_action: Optional[ActionHook] = None  # fires at commit
    # Online overlap accounting (indexed scheduler): the engine folds
    # each execution span into these as it retires — ``ol_ivals`` are
    # the load's transfer intervals, ``ol_busy`` the per-interval busy
    # time accumulated so far, ``ol_key`` the (enqueue, ready) window
    # the accumulation is valid for (an in-place shrink re-times the
    # window, invalidating the accumulated values by key mismatch).
    ol_key: Optional[Tuple[float, float]] = None
    ol_ivals: Optional[List[Tuple[float, float]]] = None
    ol_busy: Optional[List[float]] = None

    @property
    def staging(self) -> bool:
        return self.state == "staging"

    def ol_take(self) -> Optional[Tuple[float, ...]]:
        """The accumulated per-interval busy times, or None when the
        accumulator is absent or stale (then the reap-time span scan is
        the fallback)."""
        if (self.ol_busy is None
                or self.ol_key != (self.t_enqueue_ms, self.ready_ms)):
            return None
        return tuple(self.ol_busy)


@dataclass
class LoadRecord:
    """A committed load, kept until its first admission claims it."""
    app: str
    bits: int
    load_ms: float
    t_enqueue_ms: float
    t_ready_ms: float
    demand: bool
    overlap_ms: float = 0.0  # other tenants' execution inside the window
    # Per-shard transfer intervals ``(t0, t1, cap_ms)`` for mesh-sharded
    # loads; None = one single-stream interval spanning the whole load.
    # The engine measures overlap per interval, so a sharded load's
    # landed shards count honestly even when the load never commits.
    shard_intervals: Optional[Tuple[Tuple[float, float, float], ...]] = None
    partial: bool = False  # landed shards of a cancelled sharded load
    # Per-interval busy time accumulated online by the indexed engine
    # (parallel to the intervals above); None = measure by span scan.
    overlap_busy: Optional[Tuple[float, ...]] = None


class BackgroundLoader:
    """Stages tenant weights to the device off the engine's hot path.

    ``stage_fn(app, variant_or_None)`` performs the physical move (the
    serving runtime passes ``TenantRuntime.set_variant``); accounting-only
    tests can omit it and exercise the charge lifecycle alone.

    ``compress="int8"`` turns on quantize-on-the-wire staging: every
    load ships the int8 payload + per-group scales host→chip and
    dequantizes on land, so a load's *virtual transfer time* is
    ``variant.load_ms ×``
    :func:`~repro_torch.distributed.compression.wire_compression_ratio` while
    the in-flight claim and the committed weights still charge the
    resident footprint (the bytes on the chip are full width after
    dequantize).  ``wire_mb_staged`` counts the MB actually shipped
    over the link; ``inplace_downgrades`` counts variant switches that
    shipped *zero* bytes (``Downgrade(in_place=True)`` — resident
    leaves requantized via the ``quant_matmul`` machinery).
    """

    def __init__(self, manager, stage_fn: Optional[
            Callable[[str, Optional[ModelVariant]], None]] = None,
            compress: Optional[str] = None):
        if compress not in (None, "int8"):
            raise ValueError(
                f"unknown wire compression {compress!r} (None or 'int8')")
        self.manager = manager
        self.compress = compress
        self._stage_fn = stage_fn or (lambda app, variant: None)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="model-loader")
        # Predictor fits get their own worker: they mutate no device
        # state (so they need no slot in the staging channel's total
        # order), and a 150-step RNN fit queued ahead of a weight move
        # would head-of-line block reap()/stage_sync() in wall clock.
        self._fit_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="predictor-fit")
        self.inflight: Dict[str, InflightLoad] = {}
        # Readiness heap for the indexed scheduler: every (re)timed
        # in-flight load pushes an entry; stale entries (committed /
        # cancelled / shrunk-and-restaged records) are lazily dropped at
        # peek.  ``indexed_ready`` selects it over the linear scan — the
        # engine sets it from ``ServingConfig.scheduler``; both paths
        # return the identical float (min over live ready_ms).
        self.indexed_ready = False
        self._ready = MonotoneQueue()
        self._committed: Dict[str, LoadRecord] = {}
        self.history: List[LoadRecord] = []
        self.on_event: Optional[LoadEventHook] = None
        self._fits: Dict[int, Future] = {}  # in-flight predictor fits
        # Counters surfaced through engine/server stats.
        self.prefetch_hits = 0  # predictor-staged load served warm
        self.prefetch_wasted = 0  # cancelled before any request used it
        self.prefetch_shrunk = 0  # in-flight load shrunk under pressure
        self.demand_loads = 0  # cold admits staged off the loop instead
        self.loads_committed = 0
        self.load_overlap_ms = 0.0
        self.fits_scheduled = 0  # background predictor fits enqueued
        self.wire_mb_staged = 0.0  # MB actually shipped host→chip
        self.inplace_downgrades = 0  # variant switches with zero wire MB

    # -- quantize-on-the-wire staging -------------------------------------
    def wire_ratio(self, variant: ModelVariant) -> float:
        """Fraction of ``variant``'s full-width bytes a transfer ships
        under this channel's compression scheme (1.0 when off)."""
        if self.compress is None:
            return 1.0
        return wire_compression_ratio(variant.bits, scheme=self.compress)

    def _wire_ms(self, variant: ModelVariant) -> float:
        """Virtual host→chip transfer time: the zoo's measured load time
        scaled by the wire ratio — same link, fewer bytes."""
        return variant.load_ms * self.wire_ratio(variant)

    def _count_stage(self, act: A.Action) -> None:
        """Wire accounting for a residency action's physical move: an
        in-place downgrade ships zero bytes (resident leaves are
        requantized on-chip); everything else ships the variant's
        compressed payload; an unload ships nothing."""
        if isinstance(act, A.Downgrade) and act.in_place:
            self.inplace_downgrades += 1
        elif act.variant is not None:
            self.wire_mb_staged += (act.variant.size_mb
                                    * self.wire_ratio(act.variant))

    # -- physical staging channel ---------------------------------------
    def stage(self, app: str, variant: Optional[ModelVariant]) -> Future:
        """Queue a physical weight move on the single worker.  All device
        mutations go through here so they serialize in submission order."""
        return self._pool.submit(self._stage_fn, app, variant)

    def stage_sync(self, app: str, variant: Optional[ModelVariant]) -> None:
        """Hot-path (admission) staging: same channel, but wait for it."""
        self.stage(app, variant).result()

    def submit_fit(self, predictor,
                   steps: Optional[int] = None) -> Optional[Future]:
        """Schedule a predictor's :meth:`fit` on the loader's fit worker —
        the RNN trains in the background once enough inter-arrival
        history accumulates, never on the serving loop and never ahead
        of a weight move (fits ride a separate worker from the staging
        channel).  One fit per predictor at a time: a still-running fit
        dedupes the resubmission (returns None).  ``steps`` defaults to
        the predictor's own ``fit_steps`` (the ``PredictorSpec.fit_steps``
        config knob)."""
        key = id(predictor)
        fut = self._fits.get(key)
        if fut is not None and not fut.done():
            return None
        if steps is None:
            steps = getattr(predictor, "fit_steps", 150)
        fut = self._fit_pool.submit(predictor.fit, steps)
        self._fits[key] = fut
        self.fits_scheduled += 1
        return fut

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        self._fit_pool.shutdown(wait=True)

    # -- load lifecycle --------------------------------------------------
    def _emit(self, t_ms: float, kind: str, app: str, mb: float) -> None:
        if self.on_event is not None:
            self.on_event(t_ms, kind, app, mb)

    def enqueue(self, plan: ProcurePlan, now_ms: float, *,
                demand: bool = False,
                predicted_ms: float = INF) -> Optional[InflightLoad]:
        """Start a background load for ``plan.app``'s chosen variant:
        the ProcurePlan-shaped wrapper over :meth:`execute` — victims'
        evictions plus one staged load, compiled to a ResidencyPlan and
        applied atomically.  Returns None when there is nothing to do
        (already in flight / already resident / the plan would not grow
        the tenant / the plan went stale — in which case *nothing* is
        enacted, evictions included)."""
        if plan is None or plan.variant is None:
            return None
        return self.execute(
            A.ResidencyPlan(A.procure_actions(plan, staged=True)),
            now_ms, demand=demand, predicted_ms=predicted_ms)

    def execute(self, rplan: A.ResidencyPlan, now_ms: float, *,
                demand: bool = False, predicted_ms: float = INF,
                on_action: Optional[ActionHook] = None
                ) -> Optional[InflightLoad]:
        """Enact a :class:`~repro_torch.core.actions.ResidencyPlan` through
        this staging channel.

        The whole plan commits against ``MemoryState`` in one
        transaction (``apply``; an infeasible plan rolls back and
        returns None), then every action is translated to the loader's
        physical ops in plan order: evictions/loads ride the staging
        worker, a ``Load(staged=True)`` becomes an in-flight transfer
        tracked until :meth:`reap` commits it.  ``on_action(action,
        t_ms)`` fires as each action's effect lands — instantaneous
        actions during this call, the staged load's at commit time.
        Returns the in-flight record when the plan staged a transfer.
        """
        rplan = self._concretize(rplan, now_ms)
        if rplan is None:
            return None
        try:
            self.manager.state.apply(rplan)
        except A.PlanError:
            return None  # plan went stale between planning and execute
        ld: Optional[InflightLoad] = None
        for act in rplan:
            staged = self._perform(act, now_ms, demand=demand,
                                   predicted_ms=predicted_ms,
                                   on_action=on_action)
            ld = staged if staged is not None else ld
        return ld

    # -- plan translation hooks (overridden by the sharded channel) ------
    def _concretize(self, rplan: A.ResidencyPlan, now_ms: float
                    ) -> Optional[A.ResidencyPlan]:
        """Resolve staged loads to concrete claims; None = nothing to do
        (duplicate in-flight load, or a plan that would not grow the
        tenant — downgrades are admission-time decisions)."""
        state = self.manager.state
        acts = []
        for act in rplan:
            if isinstance(act, A.Load) and act.staged:
                t = state.tenants[act.app]
                if act.app in self.inflight:
                    return None
                if t.loaded is not None and \
                        act.variant.size_mb <= t.loaded.size_mb:
                    return None
                act = A.concretize_load(act, state)
            acts.append(act)
        return A.ResidencyPlan(tuple(acts))

    def _perform(self, act: A.Action, now_ms: float, *, demand: bool,
                 predicted_ms: float,
                 on_action: Optional[ActionHook]
                 ) -> Optional[InflightLoad]:
        """Translate one applied action to this loader's physical ops."""
        if isinstance(act, A.Load) and act.staged:
            ld = InflightLoad(
                app=act.app, variant=act.variant, t_enqueue_ms=now_ms,
                ready_ms=now_ms + self._wire_ms(act.variant),
                charge_mb=act.claim_mb, demand=demand,
                predicted_ms=predicted_ms,
                future=self.stage(act.app, act.variant),
                on_action=on_action)
            self.inflight[act.app] = ld
            self._ready.push(ld.ready_ms, (act.app, ld))
            self.wire_mb_staged += (act.variant.size_mb
                                    * self.wire_ratio(act.variant))
            if demand:
                self.demand_loads += 1
            self._emit(now_ms, "demand" if demand else "prefetch",
                       act.app, act.claim_mb)
            return ld
        if isinstance(act, A.RESIDENCY_ACTIONS):
            self._count_stage(act)
            self.stage(act.app, act.variant)
        if on_action is not None:
            on_action(act, now_ms)
        return None

    def _ready_live(self, t: float, payload) -> bool:
        """A heap entry is live iff its record is still the in-flight
        load for its tenant, still staging, and still timed at ``t`` —
        commits, cancels, and shrink restages all invalidate by value."""
        app, ld = payload
        return (self.inflight.get(app) is ld and ld.staging
                and ld.ready_ms == t)

    def earliest_ready(self) -> float:
        if self.indexed_ready:
            return self._ready.peek(self._ready_live)
        return min((ld.ready_ms for ld in self.inflight.values()),
                   default=INF)

    def reap(self, now_ms: float) -> List[LoadRecord]:
        """Commit every load whose virtual completion has passed: release
        the in-flight charge and charge the variant as loaded weights (a
        net zero on ``free_mb``, so commits never trip the budget).  The
        wall-clock staging is awaited here — the virtual clock says the
        transfer is done, so any real lag is absorbed now, off the other
        tenants' critical path."""
        out = []
        state = self.manager.state
        for app in [a for a, ld in self.inflight.items()
                    if ld.ready_ms <= now_ms]:
            ld = self.inflight.pop(app)
            if not ld.staging:
                continue  # a stale record cannot commit twice
            ld.future.result()
            commit = A.Load(app, ld.variant, claim_mb=ld.charge_mb)
            state.apply(A.ResidencyPlan((commit,)))
            ld.state = "committed"
            rec = LoadRecord(
                app=app, bits=ld.variant.bits,
                # Wire time, not the zoo's full-width load_ms: with
                # compression on, the transfer interval (and the
                # overlap it can hide) really is shorter.
                load_ms=ld.ready_ms - ld.t_enqueue_ms,
                t_enqueue_ms=ld.t_enqueue_ms, t_ready_ms=ld.ready_ms,
                demand=ld.demand, overlap_busy=ld.ol_take())
            self._committed[app] = rec
            self.history.append(rec)
            self.loads_committed += 1
            self._emit(ld.ready_ms, "load", app, ld.variant.size_mb)
            if ld.on_action is not None:
                ld.on_action(commit, ld.ready_ms)
            out.append(rec)
        return out

    def peek_use(self, app: str) -> Optional[LoadRecord]:
        """The committed-but-unused load the next admission will consume."""
        return self._committed.get(app)

    def take_use(self, app: str, warm: bool) -> Optional[LoadRecord]:
        """An admission for ``app`` succeeded: claim its pending commit.
        A predictor-staged load that serves warm is the payoff the whole
        pipeline exists for — count it."""
        rec = self._committed.pop(app, None)
        if rec is not None and warm and not rec.demand:
            self.prefetch_hits += 1
        return rec

    def shrink_inflight(self, app: str, variant: Optional[ModelVariant],
                        now_ms: float) -> Optional[InflightLoad]:
        """Shrink an in-flight *speculative* load to a smaller variant
        under memory pressure: release the claim difference and restage
        the smaller transfer from ``now``.  If the prediction was right,
        the tenant still warm-starts (degraded) — one smaller transfer
        instead of cancel-now-plus-demand-load-later.  Demand loads are
        never shrunk (their variant was planned against a waiting
        batch's cache needs).  Returns the updated load, or None when
        there is nothing to shrink (not in flight / not smaller / the
        target is not above what is already resident)."""
        ld = self.inflight.get(app)
        if ld is None or ld.demand or variant is None or not ld.staging:
            return None
        if variant.size_mb >= ld.variant.size_mb:
            return None
        state = self.manager.state
        loaded = state.tenants[app].loaded
        new_charge = variant.size_mb - (loaded.size_mb if loaded else 0.0)
        if new_charge <= 0.0:
            return None  # below residency: that is a cancel, not a shrink
        freed = ld.charge_mb - new_charge
        state.apply(A.ResidencyPlan((A.Shrink(app, variant, freed),)))
        # Restage the smaller variant; if the big move already ran (or is
        # running) the new stage lands after it on the same worker, so
        # the device converges to the shrunk variant either way.  The
        # overlap window restarts at *now*: the abandoned transfer hid
        # nothing worth crediting, and measuring the small load over the
        # big load's interval would inflate load_overlap_ms.
        ld.future.cancel()
        ld.variant = variant
        ld.charge_mb = new_charge
        ld.t_enqueue_ms = now_ms
        ld.ready_ms = now_ms + self._wire_ms(variant)
        self._ready.push(ld.ready_ms, (app, ld))  # re-time: old entry stale
        ld.future = self.stage(app, variant)
        self.wire_mb_staged += (variant.size_mb
                                * self.wire_ratio(variant))
        self.prefetch_shrunk += 1
        self._emit(now_ms, "shrink", app, -freed)
        return ld

    def cancel(self, app: str, now_ms: float) -> Optional[InflightLoad]:
        """The predictor was wrong (or the caller changed its mind):
        release the in-flight charge and restore the device to what the
        accounting says is loaded, in case the staging already ran."""
        ld = self.inflight.pop(app, None)
        if ld is None or not ld.staging:
            return None
        ld.state = "cancelled"  # before the release: one-way, no repeats
        state = self.manager.state
        state.apply(A.ResidencyPlan(
            (A.CancelPrefetch(app, ld.charge_mb),)))
        self.prefetch_wasted += 1
        if not ld.future.cancel():
            # The worker already staged (or is staging) the new variant:
            # queue a restore so device contents match the accounting.
            self.stage(app, state.tenants[app].loaded)
        self._emit(now_ms, "cancel", app, -ld.charge_mb)
        return ld

    def cancel_stale(self, now_ms: float,
                     delta_ms: "float | Callable[[str], float]",
                     has_queued: Callable[[str], bool]) -> int:
        """Cancel predictor-driven prefetches whose predicted request
        window has fully passed with no request in sight — the in-flight
        memory goes back to the pool instead of squatting on a wrong
        guess.  Demand loads are never stale (a batch is waiting).
        ``delta_ms`` may be a per-tenant callable (the adaptive window's
        ``delta_for``), so staleness agrees with the same Δ the window
        checks use."""
        def delta(app: str) -> float:
            return delta_ms(app) if callable(delta_ms) else delta_ms

        stale = [a for a, ld in self.inflight.items()
                 if not ld.demand and not has_queued(a)
                 and now_ms > ld.predicted_ms + delta(a)]
        for app in stale:
            self.cancel(app, now_ms)
        return len(stale)
