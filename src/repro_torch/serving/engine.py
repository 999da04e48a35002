"""Event-driven multi-tenant serving engine with KV-cache residency.

The seed server handled one request at a time and its decode caches were
invisible to the Edge-MultiAI budget.  This engine closes both gaps:

* **admit → (maybe load/evict) → prefill → decode → retire** as a
  continuous loop pulled from the :class:`~repro_torch.serving.batcher.Batcher`
  (largest-queue-first across tenants, FIFO within a tenant);
* every admitted batch's KV cache is sized from the real decode-cache
  pytree (``transformer.abstract_cache``) and charged to the tenant via
  ``EdgeMultiAI.admit_batch`` — so ``MemoryState.free_mb``, the eviction
  policies, and iWS-BFE procurement all see weights **plus** caches; the
  charge is released when the batch retires;
* a trace-driven load generator reuses the simulator's Poisson
  per-tenant arrivals (``generate_workload``) so the same workloads that
  drive the paper evaluation drive the real models;
* per-tenant latency percentiles and throughput come out of ``stats()``.

Time is virtual (milliseconds, like the simulator) so runs are
reproducible; batch *service* time is the measured wall clock of the real
prefill+decode — or a deterministic virtual time when the tenant's
executor supplies one — folded back into the virtual clock.  ``run_async``
wraps the loop for asyncio callers.

The engine is written against three structural protocols rather than the
concrete serving classes: :class:`ServingHost` (what it needs from the
tenant registry/facade), :class:`TenantExecutor` (one tenant's config,
zoo, predictor, and execution), and :class:`LoaderChannel` (the
background staging pipeline).  ``EdgeServer``/``TenantRuntime``/
``BackgroundLoader`` are the production implementations; the sim-time
executor (``repro_torch.serving.api.SimTenant``) drops in for deterministic
tests with no device work.
"""
from __future__ import annotations

import asyncio
import functools
import itertools
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import (Any, Callable, Deque, Dict, List, Mapping, Optional,
                    Protocol, Sequence, Tuple)

import numpy as np

from repro_torch.core import actions as RA
from repro_torch.core.manager import LOAD_OVER_INFER, BatchAdmission
from repro_torch.core.policies import DemandContext, ProcurePlan
from repro_torch.core.simulator import Workload, generate_workload
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.batcher import Batch, Batcher, Request
from repro_torch.serving.stats import AuditEvent, EventKind, ServingStats

MB = 1024 * 1024


# ---------------------------------------------------------------------------
# Structural protocols: the engine's entire view of the serving stack
# ---------------------------------------------------------------------------
class TenantExecutor(Protocol):
    """One tenant, as the engine sees it: enough to size caches, charge
    load penalties, feed the arrival predictor, and run a batch.
    ``execute`` returns the generated tokens plus an optional *virtual*
    service time in ms — ``None`` means "time me by wall clock" (the real
    device runtime), a number means deterministic sim time."""

    cfg: ModelConfig
    zoo: Any  # ModelZoo
    predictor: Any  # RequestPredictor

    def execute(self, batch: Batch, extra: Optional[dict] = None
                ) -> Tuple[np.ndarray, Optional[float]]: ...


class LoaderChannel(Protocol):
    """The background staging pipeline, as the engine drives it.

    ``execute`` is the residency-IR entry point: the engine (and the
    host's prefetch hook) compile policy plans to
    :class:`~repro_torch.core.actions.ResidencyPlan` groups, the channel
    applies each group atomically through ``MemoryState.apply`` and
    translates the actions to its physical stage ops; ``on_action``
    fires per action as its effect lands (a staged load's at commit).
    ``enqueue`` remains the ProcurePlan-shaped wrapper."""

    inflight: Mapping[str, Any]
    on_event: Optional[Callable[[float, str, str, float], None]]
    prefetch_hits: int
    prefetch_wasted: int
    prefetch_shrunk: int
    demand_loads: int
    loads_committed: int
    load_overlap_ms: float
    fits_scheduled: int

    def execute(self, plan: RA.ResidencyPlan, now_ms: float, *,
                demand: bool = ..., predicted_ms: float = ...,
                on_action: Optional[Callable[[RA.Action, float], None]]
                = ...) -> Any: ...
    def enqueue(self, plan: ProcurePlan, now_ms: float, *,
                demand: bool = ..., predicted_ms: float = ...) -> Any: ...
    def reap(self, now_ms: float) -> List[Any]: ...
    def cancel(self, app: str, now_ms: float) -> Any: ...
    def shrink_inflight(self, app: str, variant: Any,
                        now_ms: float) -> Any: ...
    def cancel_stale(self, now_ms: float,
                     delta_ms: "float | Callable[[str], float]",
                     has_queued: Callable[[str], bool]) -> int: ...
    def peek_use(self, app: str) -> Any: ...
    def take_use(self, app: str, warm: bool) -> Any: ...
    def earliest_ready(self) -> float: ...
    def close(self) -> None: ...


class ServingHost(Protocol):
    """What the engine needs from the tenant registry/facade — the
    manager for admission accounting, the tenant executors, and the
    predictor-driven prefetch hooks.  ``EdgeServer`` is the production
    implementation."""

    manager: Any  # EdgeMultiAI
    tenants: Mapping[str, TenantExecutor]

    def predict_and_preload(self, now_ms: float) -> None: ...
    def next_prefetch_trigger(self, now_ms: float) -> float: ...


@functools.lru_cache(maxsize=1024)
def kv_cache_mb(cfg: ModelConfig, batch: int, max_len: int,
                quantized: bool = False) -> float:
    """Exact decode-cache footprint in MB, from the cache's shapes
    (no allocation) — the same shapes ``prefill`` will materialize.
    Memoized: admission sits on the serving hot path and batch shapes
    repeat (ModelConfig is frozen/hashable)."""
    shapes = T.cache_shapes(cfg, batch, max_len, quantized=quantized)
    return sum(int(np.prod(shape)) * dtype.itemsize
               for shape, dtype in shapes.values()) / MB


@dataclass
class RequestResult:
    """Per-request outcome with queueing + service latency."""
    rid: int
    app: str
    arrival_ms: float
    start_ms: float
    done_ms: float
    warm: bool
    failed: bool
    bits: Optional[int]
    batch_size: int
    kv_mb: float

    @property
    def latency_ms(self) -> float:
        return self.done_ms - self.arrival_ms


@dataclass
class EngineEvent:
    """Audit-trail entry emitted at every engine state change; the
    invariant tests replay these to check ``used_mb + inflight_mb ≤
    budget_mb`` at every point in the run, not just at the end — and,
    on a sharded mesh, per-device ``weights + claims ≤ chip budget``."""
    t_ms: float
    kind: EventKind
    app: str
    kv_mb: float
    used_mb: float
    free_mb: float
    inflight_mb: float = 0.0  # background-load claims at event time
    # The tenants' CUDA-graph pools at event time (part of used_mb).
    pool_mb: float = 0.0
    # Per-device weights + in-flight claims when a DeviceLedger is
    # installed (sharded mesh); None on single-device runs.
    device_mb: Optional[Tuple[float, ...]] = None
    # Per-device budgets *at event time*: chip loss/recovery changes the
    # ledger mid-run, so the invariant check compares each event against
    # the budgets that held when it fired, not today's.
    device_budget_mb: Optional[Tuple[float, ...]] = None

    @property
    def audit(self) -> AuditEvent:
        """The normalized audit record (kind/time/tenant/MB delta)."""
        return AuditEvent(self.kind, self.t_ms, self.app, self.kv_mb)


Executor = Callable[[Any, Batch, Optional[dict]], np.ndarray]

# One full-batch service span covers the default request's decode budget
# (max_new=8), so a single continuous-batching decode step is the
# variant's service time divided by this.
STEPS_PER_SERVICE = 8.0


@dataclass(eq=False)
class _ActiveSeq:
    """One request mid-decode in the continuous batch: its admission
    outcome, its page-rounded KV charge, and its step progress.
    ``eq=False``: membership and removal are by identity — field
    equality would ``==``-broadcast the request's ndarray prompt."""
    req: Request
    start_ms: float
    warm: bool
    bits: Optional[int]
    kv_mb: float
    batch_size: int  # active set size at admission (stats)
    steps_done: int = 0


class ServingEngine:
    """Pulls batches from the Batcher and drives them through the
    Edge-MultiAI manager with full runtime-memory accounting.

    ``host`` is anything satisfying :class:`ServingHost`; per-batch
    execution goes through each tenant's :class:`TenantExecutor`.  The
    legacy ``executor`` callable ``(runtime, batch, extra) -> tokens``
    remains injectable (it overrides the protocol path) so
    accounting/invariant tests can run the full admit/retire protocol
    without touching the device.
    """

    def __init__(self, host: ServingHost, *, max_batch: int = 8,
                 batch_window_ms: float = 0.0,
                 executor: Optional[Executor] = None,
                 loader: Optional[LoaderChannel] = None,
                 continuous: bool = False,
                 audit: str = "full",
                 scheduler: str = "indexed"):
        if audit not in ("full", "counters"):
            raise ValueError(
                f"audit must be 'full' or 'counters', got {audit!r}")
        if scheduler not in ("indexed", "linear"):
            raise ValueError(
                f"scheduler must be 'indexed' or 'linear', got "
                f"{scheduler!r}")
        self.host = host
        self.batcher = Batcher(max_batch=max_batch)
        self.max_batch = max_batch
        self.batch_window_ms = batch_window_ms
        # Audit level: "full" records an EngineEvent (with device/usage
        # snapshots) at every state change — required by the invariant
        # tests and the default everywhere; "counters" keeps only the
        # event count, for large-scale replays where the per-event
        # snapshots dominate the hot path.
        self.audit = audit
        # Scheduler: "indexed" (default) answers "when does the next
        # thing happen" from incremental structures (loader readiness
        # heap, memoized prediction triggers, online overlap
        # accounting); "linear" is the retained pre-refactor reference
        # that rescans on every idle step.  Both produce bit-identical
        # audit trails and stats — proven by
        # tests/test_engine_equivalence.py.
        self.scheduler = scheduler
        self.indexed = scheduler == "indexed"
        # Continuous batching: the admission unit is the request, not the
        # batch — requests join/leave the running decode per step and
        # charge/free page-granular KV (requires a KVPagePool on the
        # state; installed by EdgeServer.start when the BatchingSpec
        # asks for it).
        self.continuous = continuous
        self.results: List[RequestResult] = []
        self.events: List[EngineEvent] = []
        self.events_emitted = 0  # total, counted even under audit="counters"
        self.warm_served = 0  # incremental Σ r.warm over self.results
        self.kv_downgrades = 0  # requester shrank itself to fit its cache
        self.weight_failures = 0  # batches whose weights were unprocurable
        self._now = 0.0  # loop clock (audit events outside execute paths)
        # Maintenance-skip validity (continuous loop, indexed host):
        # True only while NOTHING invalidating happened since the last
        # executed maintenance pass — no arrival, no load commit, no
        # admission, no retirement.  Together with the host's
        # ``maint_valid_ms`` horizon it lets the loop skip maintenance
        # calls that are provably identical no-ops.
        self._maint_clean = False
        # None => route through TenantExecutor.execute (the protocol
        # path); a callable overrides it (legacy injection point).
        self._executor = executor
        # Background loading pipeline (None = reactive PR-1 behavior:
        # every load is enacted synchronously inside the admit path and
        # charges the loop clock).
        self.loader = loader
        if loader is not None:
            loader.on_event = self._loader_event
            # Select the loader's readiness heap over its linear scan
            # (both return the identical min; protocol fakes that lack
            # the attribute simply keep scanning).
            try:
                loader.indexed_ready = self.indexed
            except AttributeError:
                pass
        # Elastic mesh controller (chip loss & recovery); installed by
        # EdgeServer.start when the config carries a FaultSpec.  Polled
        # in the maintenance pass and folded into the idle wake-up.
        self.elastic = None
        # Execution spans (start, end, app) inside the current loader
        # window — used to measure how much of each load was hidden
        # behind other tenants' prefill/decode.  Spans append in loop
        # order, so their end times are monotone non-decreasing and the
        # prune in _reap_loads is a prefix popleft.
        self._spans: Deque[Tuple[float, float, str]] = deque()
        # Cluster-tier local clock: where cluster_advance left this
        # server's loop (a batch may have run past the last horizon).
        self._cluster_now = 0.0
        # Runtimes that capture CUDA graphs charge their pools through
        # the engine (sim tenants and CPU runtimes never call it).
        for app, tr in host.tenants.items():
            if hasattr(tr, "pool_ledger"):
                tr.pool_ledger = functools.partial(self._charge_pool, app)

    @property
    def audit_trail(self) -> List[AuditEvent]:
        """Every event as a normalized :class:`AuditEvent` record."""
        return [ev.audit for ev in self.events]

    @property
    def server(self) -> ServingHost:
        """Deprecated alias for :attr:`host` (pre-protocol name)."""
        return self.host

    @property
    def kv_rejections(self) -> int:
        """Batches bounced for cache pressure — the manager's counter is
        the single source of truth (it performs the rejection)."""
        mgr = self.host.manager
        return mgr.kv_rejections if mgr else 0

    # ------------------------------------------------------------------
    def _event(self, t_ms: float, kind: str, app: str, kv_mb: float) -> None:
        self.events_emitted += 1
        if self.audit != "full":
            return  # counters level: count the event, skip the snapshot
        st = self.host.manager.state
        self.events.append(EngineEvent(
            t_ms, EventKind(kind), app, kv_mb, st.used_mb, st.free_mb,
            st.inflight_mb, st.pool_mb,
            device_mb=(st.devices.device_used()
                       if st.devices is not None else None),
            device_budget_mb=(st.devices.budgets_mb
                              if st.devices is not None else None)))

    def _charge_pool(self, app: str, mb: float) -> bool:
        """Set ``app``'s graph-pool charge to ``mb``: the runtime's call
        before a capture (the estimate it reserves) and after it (the
        pool it measured).  A rise that ``free_mb`` cannot take changes
        nothing and returns False, so no event ever reads over budget;
        the runtime then serves the batch eagerly."""
        st = self.host.manager.state
        delta = mb - st.tenants[app].pool_mb
        if delta > st.free_mb:
            return False
        st.charge_pool(app, mb)
        self._event(self._now, "pool", app, delta)
        return True

    def _loader_event(self, t_ms: float, kind: str, app: str,
                      mb: float) -> None:
        """Mirror loader lifecycle transitions into the audit trail."""
        self._event(t_ms, kind, app, mb)

    def _wire_audit(self) -> None:
        """Route the state's KV over-release audit hook into the event
        log (timing is loop-clock granular)."""
        mgr = self.host.manager
        if mgr is not None and mgr.state.on_audit is None:
            mgr.state.on_audit = (
                lambda kind, app, mb: self._event(self._now, kind, app, mb))

    def submit(self, req: Request, now_ms: float) -> None:
        """Enqueue a request; feeds the tenant's RNN arrival predictor."""
        req.arrival_ms = now_ms if req.arrival_ms == 0.0 else req.arrival_ms
        self._maint_clean = False  # new arrival: predictions shift
        self.host.tenants[req.app].predictor.observe_request(
            req.arrival_ms)
        self.batcher.submit(req)
        self._event(req.arrival_ms, "submit", req.app, 0.0)

    # ------------------------------------------------------------------
    def execute_batch(self, batch: Batch, now_ms: float,
                      extra: Optional[dict] = None, *,
                      charge_load: bool = False
                      ) -> Tuple[List[RequestResult], float,
                                 Optional[np.ndarray]]:
        """One admit→(load/evict)→prefill→decode→retire cycle.

        Returns the per-request results, the service time in ms (wall
        clock of the real model execution, plus the variant's load time
        when ``charge_load`` is set and the admit cold-loaded — the
        reactive engine's synchronous load stalls the whole loop, and
        the virtual clock must say so), and the generated tokens (None
        when the batch was rejected).

        When a background loader is attached, a batch whose weights were
        staged by a demand-triggered load is admitted ``demand_cold``:
        the request waited out the transfer, so the serve is a cold
        start even though the weights are resident by admission time.
        """
        mgr = self.host.manager
        assert mgr is not None, "server.start() before engine use"
        self._wire_audit()
        self._now = now_ms
        tr = self.host.tenants[batch.app]
        total_len = batch.prompts.shape[1] + batch.max_new
        kv_mb = kv_cache_mb(tr.cfg, len(batch.requests), total_len)
        if self.loader is not None:
            # Sync callers (serve()) don't defer on the loader the way
            # run_trace does: commit whatever is virtually complete, and
            # if this tenant still has a load mid-flight, release its
            # claim and procure synchronously — otherwise an admission-
            # path upgrade double-tracks the staged variant and the
            # in-flight charge leaks forever.
            self._reap_loads(now_ms)
            if batch.app in self.loader.inflight:
                self.loader.cancel(batch.app, now_ms)
        staged = (self.loader.peek_use(batch.app)
                  if self.loader is not None else None)
        adm: BatchAdmission = mgr.admit_batch(
            batch.app, now_ms, kv_mb,
            demand_cold=staged.demand if staged is not None else False)
        if adm.self_downgraded:
            self.kv_downgrades += 1
        if adm.failed:
            if staged is not None:
                # Consume the staged-load record even on rejection — left
                # behind it would mark the tenant's *next* (genuinely
                # warm) admission demand-cold.
                self.loader.take_use(batch.app, False)
            if not adm.kv_rejected:
                self.weight_failures += 1
            self._event(now_ms, "reject", batch.app, kv_mb)
            # A rejected request was never served: not warm, failed.
            results = [
                RequestResult(r.rid, batch.app, r.arrival_ms, now_ms,
                              now_ms, False, True, None,
                              len(batch.requests), 0.0)
                for r in batch.requests]
            self.results.extend(results)
            return results, 0.0, None
        if staged is not None:
            self.loader.take_use(batch.app, adm.warm)
        # A cold serve whose load happened synchronously inside
        # admit_batch (reactive mode, or a loader-mode admission that
        # slipped past demand staging — e.g. its plan was unfundable and
        # desperation loaded on the spot) stalled the loop thread for
        # the transfer, so the virtual clock is charged for it.  A
        # demand-staged cold (``staged``) already paid in queue time.
        sync_cold = charge_load or (self.loader is not None
                                    and staged is None)
        load_pen_ms = (tr.zoo.by_bits(adm.bits).load_ms
                       if sync_cold and not adm.warm else 0.0)
        self._event(now_ms, "admit", batch.app, adm.kv_mb)
        t0 = time.monotonic()
        virtual_ms: Optional[float] = None
        try:
            if self._executor is not None:  # legacy injected callable
                tokens = self._executor(tr, batch, extra)
            else:  # TenantExecutor protocol: tokens + optional sim time
                tokens, virtual_ms = tr.execute(batch, extra)
        except BaseException:
            # Execution crashed (device OOM, bad inputs): release the cache
            # charge so it doesn't leak, balance the audit trail, and
            # record the requests as failed so callers that catch the
            # exception and keep serving don't lose them from stats.
            service_ms = (time.monotonic() - t0) * 1e3
            done_ms = now_ms + service_ms
            mgr.release_kv(batch.app, adm.kv_mb)
            self._event(done_ms, "retire", batch.app, -adm.kv_mb)
            self.results.extend(
                RequestResult(r.rid, batch.app, r.arrival_ms, now_ms,
                              done_ms, False, True, None,
                              len(batch.requests), 0.0)
                for r in batch.requests)
            raise
        service_ms = (virtual_ms if virtual_ms is not None
                      else (time.monotonic() - t0) * 1e3) + load_pen_ms
        # Per-request retirement: a short request finishes — and returns
        # its share of the cache — when *its* decode budget is spent, not
        # when the batch's longest request retires.  The decode itself
        # still runs to batch.max_new (padding is compute); the memory
        # charge does not.  Shares release in finish order; the longest
        # request carries the float residue so the batch drains to
        # exactly zero, and its release is the batch's "retire" event
        # (earlier ones are "free_kv") so admits and retires stay 1:1
        # in the audit trail.
        B = len(batch.requests)
        decode_ms = service_ms - load_pen_ms
        order = sorted(range(B),
                       key=lambda j: (batch.requests[j].max_new, j))
        results: List[Optional[RequestResult]] = [None] * B
        released = 0.0
        for pos, j in enumerate(order):
            r = batch.requests[j]
            frac = r.max_new / batch.max_new if batch.max_new > 0 else 1.0
            r_done = now_ms + load_pen_ms + decode_ms * frac
            last = pos == B - 1
            share = (max(0.0, adm.kv_mb - released) if last
                     else adm.kv_mb / B)
            released += share
            mgr.release_kv(batch.app, share)
            self._event(r_done, "retire" if last else "free_kv",
                        batch.app, -share)
            results[j] = RequestResult(
                r.rid, batch.app, r.arrival_ms, now_ms, r_done,
                adm.warm, False, adm.bits, B, share)
        if adm.warm:
            self.warm_served += B
        self.results.extend(results)
        return results, service_ms, tokens

    # ------------------------------------------------------------------
    def _stage_demand_loads(self, now: float) -> None:
        """Cold tenants with queued work get their load staged off the
        loop: plan a variant (with the waiting batch's cache need as a
        planning charge) and hand it to the background loader.  The
        batch itself stays queued — ``run_trace`` skips the tenant until
        the load commits, while everyone else keeps prefilling/decoding.
        If no variant fits, the batch is admitted anyway so the failure
        is counted the normal way."""
        mgr = self.host.manager
        # queued_apps() is a live keys view (no per-step copy); nothing
        # in this loop inserts or drops queue keys, so iterating it
        # directly is safe.
        for app in self.batcher.queued_apps():
            if app in self.loader.inflight:
                continue
            if mgr.state.tenants[app].loaded is not None:
                continue
            q = list(itertools.islice(self.batcher.queues[app],
                                      self.max_batch))
            total_len = (max(len(r.prompt) for r in q)
                         + max(r.max_new for r in q))
            cfg = self.host.tenants[app].cfg
            # Head batch as queued right now, plus the full-batch bound a
            # burst could fill in before the load commits — the policy's
            # demand_charge hook picks which one to plan around.
            demand = DemandContext(
                kv_head_mb=kv_cache_mb(cfg, len(q), total_len),
                kv_full_mb=kv_cache_mb(cfg, self.max_batch, total_len),
                queue_depth=self.batcher.queued(app),
                max_batch=self.max_batch)
            plan = mgr.plan_demand(app, now, demand=demand)
            if plan is None:
                # Speculation yields to demand — but gradually: first
                # shrink predictor-driven prefetches to their smallest
                # variant (the guess keeps its warm start, degraded, and
                # most of the claim comes back), then cancel outright
                # (least-credible prediction first) until the real
                # request's load becomes fundable — speculative claims
                # must never starve actual queued work.
                def guesses():
                    return sorted(
                        (a for a, ld in self.loader.inflight.items()
                         if not ld.demand),
                        key=lambda a: -self.loader.inflight[a]
                        .predicted_ms)
                for guess in guesses():
                    small = mgr.state.tenants[guess].zoo.smallest
                    if self.loader.shrink_inflight(guess, small,
                                                   now) is None:
                        continue
                    plan = mgr.plan_demand(app, now, demand=demand)
                    if plan is not None:
                        break
                if plan is None:
                    for guess in guesses():
                        self.loader.cancel(guess, now)
                        plan = mgr.plan_demand(app, now, demand=demand)
                        if plan is not None:
                            break
            if plan is not None:
                # Compile the policy's plan to the residency IR and hand
                # it to the channel: evictions + the staged load commit
                # as one atomic group (a stale plan enacts *nothing*).
                self.loader.execute(
                    RA.ResidencyPlan(RA.procure_actions(plan, staged=True)),
                    now, demand=True)

    def _note_span(self, t0: float, t1: float, app: str) -> None:
        """Record one retired execution span; on the indexed path, also
        fold it into every in-flight load's online overlap accumulator.
        The accumulator adds the identical per-interval contributions,
        in the identical span order, that the reap-time scan would sum
        — same float additions, bit-identical ``load_overlap_ms``."""
        self._spans.append((t0, t1, app))
        if not self.indexed or self.loader is None:
            return
        for ld in self.loader.inflight.values():
            # Protocol fakes without the accumulator fields simply keep
            # the reap-time scan (their records carry no busy values).
            if (ld.app == app or not getattr(ld, "staging", False)
                    or not hasattr(ld, "ol_key")):
                continue
            key = (ld.t_enqueue_ms, ld.ready_ms)
            if ld.ol_key != key:
                # First span since this load's window was (re)opened:
                # no earlier span can intersect it (spans retire with
                # end ≤ the loop clock that opened the window), so the
                # accumulator starts at zero.
                shards = getattr(ld, "shards", None)
                ld.ol_key = key
                ld.ol_ivals = ([(sh.t_start_ms, sh.ready_ms)
                                for sh in shards] if shards else [key])
                ld.ol_busy = [0.0] * len(ld.ol_ivals)
            for k, (a0, a1) in enumerate(ld.ol_ivals):
                if t1 > a0 and t0 < a1:
                    ld.ol_busy[k] += min(t1, a1) - max(t0, a0)

    def _reap_loads(self, now: float) -> None:
        """Commit loads whose virtual transfer has finished and measure
        how much of each load interval was hidden behind *other*
        tenants' execution — the paper's overlap claim, quantified.
        Sharded loads measure per shard interval (which also credits the
        landed shards of a cancelled load: that transfer was real and
        really was hidden); single-stream loads over the whole load.

        A record carrying online-accumulated busy values (indexed
        scheduler) skips the span scan; records without them (linear
        reference path, protocol fakes, loads that saw no spans) measure
        by scanning the retained spans exactly as before."""
        for rec in self.loader.reap(now):
            self._maint_clean = False  # a commit changed residency
            intervals = (rec.shard_intervals
                         or ((rec.t_enqueue_ms, rec.t_ready_ms,
                              rec.load_ms),))
            busies = getattr(rec, "overlap_busy", None)
            overlap = 0.0
            if busies is not None:
                for (t0, t1, cap), busy in zip(intervals, busies):
                    overlap += min(busy, cap)
            else:
                for t0, t1, cap in intervals:
                    busy = sum(min(e, t1) - max(s, t0)
                               for s, e, a in self._spans
                               if a != rec.app and e > t0 and s < t1)
                    overlap += min(busy, cap)
            rec.overlap_ms = overlap
            self.loader.load_overlap_ms += rec.overlap_ms
        horizon = min((ld.t_enqueue_ms
                       for ld in self.loader.inflight.values()),
                      default=now)
        # Span ends are monotone (appended in loop order), so pruning
        # everything that ended at/before the horizon is a prefix pop.
        spans = self._spans
        while spans and spans[0][1] <= horizon:
            spans.popleft()

    def run_trace(self, requests: Sequence[Request]) -> dict:
        """Closed-loop trace replay: arrivals enter the batcher at their
        trace timestamps; the single engine pulls the next batch whenever
        it is idle, waiting out the batching window when the queue is
        short and another arrival is imminent.

        With a background loader attached (the default via
        ``EdgeServer``), no weight transfer ever blocks the loop:
        predicted-next tenants are prefetched ahead of their requests,
        cold tenants' demand loads stage while other tenants execute,
        and a tenant is only deferred until its own load commits.
        Without a loader this is the reactive PR-1 engine — every cold
        load happens synchronously inside the admit path and is charged
        to the loop clock, stalling every queued tenant behind it.

        With ``continuous=True`` the batch-scalar loop is replaced by
        :meth:`_run_continuous`: requests join and leave the running
        decode batch per step against the paged KV pool.
        """
        self._wire_audit()
        if self.continuous:
            return self._run_continuous(requests)
        pending = sorted(requests, key=lambda r: r.arrival_ms)
        i, n, now = 0, len(pending), 0.0
        while i < n or self.batcher.pending():
            if not self.batcher.pending():
                t_next = pending[i].arrival_ms if i < n else math.inf
                if self.loader is not None:
                    # Idle wake-ups: a pending load commit, or a tenant's
                    # prefetch trigger (t_pred − Δ − θ) — sleeping past
                    # either would turn a hideable load into a stall.
                    t_next = min(t_next, self.loader.earliest_ready(),
                                 self.host.next_prefetch_trigger(now))
                if self.elastic is not None:
                    # A scheduled chip fault wakes the loop even when it
                    # is otherwise idle — drains fire at their instant.
                    t_next = min(t_next, self.elastic.next_event_ms())
                now = max(now, t_next)
            while i < n and pending[i].arrival_ms <= now:
                self.submit(pending[i], pending[i].arrival_ms)
                i += 1
            # Hold a short batch for an imminent arrival (amortization).
            if (self.batcher.pending() < self.max_batch and i < n
                    and pending[i].arrival_ms <= now + self.batch_window_ms):
                now = pending[i].arrival_ms
                continue
            if self.loader is not None:
                self._reap_loads(now)
                if self.elastic is not None:
                    self._now = now
                    self.elastic.poll(now)
                self.host.predict_and_preload(now)
                self._stage_demand_loads(now)
                batch = self.batcher.next_batch(
                    exclude=self.loader.inflight)
                if batch is None:
                    # Every queued tenant is awaiting its own load (or
                    # nothing is queued at all): jump to the earliest
                    # commit or the next arrival — the loop idles, it
                    # does not block on a transfer.
                    t_next = self.loader.earliest_ready()
                    if i < n:
                        t_next = min(t_next, pending[i].arrival_ms)
                    if self.elastic is not None:
                        t_next = min(t_next,
                                     self.elastic.next_event_ms())
                    if t_next is not math.inf:
                        now = max(now, t_next)
                        continue
                    break
            else:
                batch = self.batcher.next_batch()
            t0 = now
            _, service_ms, _ = self.execute_batch(
                batch, now, charge_load=self.loader is None)
            now += service_ms
            self._note_span(t0, now, batch.app)
        if self.loader is not None:
            # Trace drained: commit whatever is still staging so the
            # audit trail balances and residency reflects the weights.
            self._reap_loads(math.inf)
        return self.stats()

    # ------------------------------------------------------------------
    # Cluster tier: the shared-clock protocol EdgeCluster drives
    # ------------------------------------------------------------------
    def cluster_submit(self, req: Request) -> None:
        """Cluster-tier entry: enqueue a routed request at its own
        arrival timestamp.  The cluster loop owns the global clock and
        pumps arrivals itself, so unlike :meth:`run_trace` there is no
        trace replay here — one call per routed request.  The local
        clock advances to the arrival (an idle server was simply idle
        until now; a busy one is already past it), so queued work never
        executes before it arrived."""
        self.submit(req, req.arrival_ms)
        self._cluster_now = max(self._cluster_now, req.arrival_ms)

    def cluster_advance(self, horizon_ms: float) -> float:
        """Run this server's loop up to — exclusive of — ``horizon_ms``.

        The same cycle as :meth:`run_trace` (maintenance pass, pull a
        batch, execute, advance the local clock by its service time),
        except arrivals come from :meth:`cluster_submit` between calls
        instead of an internal trace.  Only work *starting* strictly
        before the horizon runs, so a request routed at ``t`` by the
        cluster loop is visible before any same-instant batch is pulled
        — the exact submit-before-batch ordering ``run_trace`` has for
        same-timestamp arrivals.  The local clock may end past the
        horizon (a batch's service time is indivisible); it never ends
        before a completed horizon.

        Returns this server's next internal event time (queued work's
        resume instant, a pending load commit, a prefetch trigger, or a
        scheduled chip fault) — ``math.inf`` when fully drained.  The
        cluster loop folds these into its global clock.
        """
        self._wire_audit()
        now = self._cluster_now
        while True:
            if not self.batcher.pending():
                t_next = math.inf
                if self.loader is not None:
                    t_next = min(self.loader.earliest_ready(),
                                 self.host.next_prefetch_trigger(now))
                if self.elastic is not None:
                    t_next = min(t_next, self.elastic.next_event_ms())
                if not t_next < horizon_ms:
                    break
                now = max(now, t_next)
            elif not now < horizon_ms:
                t_next = now  # runnable work at/after the horizon
                break
            if self.loader is not None:
                self._reap_loads(now)
            if self.elastic is not None:
                self._now = now
                self.elastic.poll(now)
            if self.loader is not None:
                self.host.predict_and_preload(now)
                self._stage_demand_loads(now)
                batch = self.batcher.next_batch(
                    exclude=self.loader.inflight)
            else:
                batch = self.batcher.next_batch()
            if batch is None:
                if not self.batcher.pending():
                    continue  # maintenance consumed the wake-up;
                    # recompute the idle candidates from the top
                # Every queued tenant is awaiting its own load.
                t_next = math.inf
                if self.loader is not None:
                    t_next = self.loader.earliest_ready()
                if self.elastic is not None:
                    t_next = min(t_next, self.elastic.next_event_ms())
                if not t_next < horizon_ms:
                    break
                now = max(now, t_next)
                continue
            t0 = now
            _, service_ms, _ = self.execute_batch(
                batch, now, charge_load=self.loader is None)
            now += service_ms
            self._note_span(t0, now, batch.app)
        self._cluster_now = now
        return t_next

    def cluster_finish(self) -> None:
        """Terminal pass once the cluster loop drained every server:
        commit whatever is still staging so the audit trail balances."""
        if self.loader is not None:
            self._reap_loads(math.inf)

    # ------------------------------------------------------------------
    # Continuous batching: the request is the admission unit
    # ------------------------------------------------------------------
    def _step_ms(self, app: str, n_active: int) -> float:
        """One decode step's virtual time for ``app``'s active set: the
        loaded variant's service span over the nominal decode budget.
        A tenant executor may override by exposing ``step_ms``."""
        tr = self.host.tenants[app]
        step = getattr(tr, "step_ms", None)
        if callable(step):
            return step(n_active)
        loaded = self.host.manager.state.tenants[app].loaded
        base = loaded.load_ms / LOAD_OVER_INFER if loaded else 1.0
        return max(base / STEPS_PER_SERVICE, 1e-6)

    def _requeue_preempted(self, active: Dict[str, List[_ActiveSeq]],
                           now: float) -> None:
        """Sequences whose pages were evicted as admission victims lose
        their decode progress and go back to the head of their queue
        (their pages are already freed by the manager's plan)."""
        for vapp, seq in self.host.manager.take_preempted():
            seqs = active.get(vapp, [])
            victim = next((s for s in seqs if s.req.rid == seq), None)
            if victim is None:
                continue
            seqs.remove(victim)
            self._event(now, "preempt", vapp, -victim.kv_mb)
            self.batcher.queues[vapp].appendleft(victim.req)

    def _join_requests(self, active: Dict[str, List[_ActiveSeq]],
                       now: float) -> float:
        """Admit queued requests into the running decode batch, FIFO per
        tenant, until each tenant's active set is full or an admission
        fails.  Each request charges its own page-rounded KV need; a
        rejected request is dropped and counted like a rejected batch.
        Returns the (possibly advanced) loop clock — a synchronous cold
        load inside an admit stalls the loop, exactly like the reactive
        batch engine."""
        mgr = self.host.manager
        pool = mgr.state.kv_pool
        inflight = self.loader.inflight if self.loader is not None else {}
        if self.batcher.queues:
            # Queued work may admit (memory mutates) or stay queued
            # (skip is blocked anyway): conservatively invalidate.
            self._maint_clean = False
        # Snapshot, not the live view: _requeue_preempted below can
        # insert brand-new queue keys mid-iteration (a preempted victim
        # whose tenant had drained its queue), which would blow up a
        # live keys-view iteration.
        for app in list(self.batcher.queued_apps()):
            if app in inflight:
                continue  # weights mid-staging: join after the commit
            tr = self.host.tenants[app]
            while (self.batcher.queues.get(app)
                   and len(active.setdefault(app, [])) < self.max_batch):
                req = self.batcher.queues[app][0]
                raw = kv_cache_mb(tr.cfg, 1, len(req.prompt) + req.max_new)
                need = (pool.pages_for(raw) * pool.page_mb
                        if pool is not None else raw)
                staged = (self.loader.peek_use(app)
                          if self.loader is not None else None)
                adm = mgr.admit_batch(
                    app, now, need,
                    demand_cold=staged.demand if staged is not None
                    else False,
                    seq=req.rid if pool is not None else None)
                # Admission may have preempted other tenants' sequences
                # (cold-page victims): drop them from the active sets
                # and requeue before touching this queue further.
                self._requeue_preempted(active, now)
                if adm.self_downgraded:
                    self.kv_downgrades += 1
                if adm.failed:
                    if staged is not None:
                        self.loader.take_use(app, False)
                    if not adm.kv_rejected:
                        self.weight_failures += 1
                    self.batcher.queues[app].popleft()
                    self._event(now, "reject", app, need)
                    self.results.append(RequestResult(
                        req.rid, app, req.arrival_ms, now, now, False,
                        True, None, len(active[app]), 0.0))
                    continue
                if staged is not None:
                    self.loader.take_use(app, adm.warm)
                if not adm.warm and (self.loader is None
                                     or staged is None):
                    # Synchronous cold load inside the admit: the loop
                    # clock pays for the transfer (reactive semantics).
                    now += tr.zoo.by_bits(adm.bits).load_ms
                self.batcher.queues[app].popleft()
                self._event(now, "admit", app, adm.kv_mb)
                active[app].append(_ActiveSeq(
                    req=req, start_ms=now, warm=adm.warm, bits=adm.bits,
                    kv_mb=adm.kv_mb, batch_size=len(active[app]) + 1))
            if not self.batcher.queues.get(app):
                self.batcher.queues.pop(app, None)
        return now

    def _retire_seq(self, s: _ActiveSeq, now: float) -> None:
        """A sequence finished its decode budget: free its pages *now*
        (not when the batch's longest request retires — there is no
        batch anymore) and record the result."""
        mgr = self.host.manager
        pool = mgr.state.kv_pool
        self._maint_clean = False  # the freed cache changes free_mb
        mgr.release_kv(s.req.app, s.kv_mb,
                       seq=s.req.rid if pool is not None else None)
        self._event(now, "retire", s.req.app, -s.kv_mb)
        self.warm_served += s.warm
        self.results.append(RequestResult(
            s.req.rid, s.req.app, s.req.arrival_ms, s.start_ms, now,
            s.warm, False, s.bits, s.batch_size, s.kv_mb))

    def _run_continuous(self, requests: Sequence[Request]) -> dict:
        """Continuous-batching trace replay.  Per iteration: pump due
        arrivals, run the loader maintenance hooks, join queued requests
        into the active sets (request-granular admission against free KV
        pages), then run ONE decode step for the tenant with the largest
        active set — sequences whose budget is spent retire and free
        their pages immediately, so the next join admits against the
        reclaimed pages mid-"batch".  Virtual-time, deterministic."""
        pending = sorted(requests, key=lambda r: r.arrival_ms)
        i, n, now = 0, len(pending), 0.0
        active: Dict[str, List[_ActiveSeq]] = {}
        while (i < n or self.batcher.pending()
               or any(active.values())):
            self._now = now
            while i < n and pending[i].arrival_ms <= now:
                self.submit(pending[i], pending[i].arrival_ms)
                i += 1
            if self.loader is not None:
                self._reap_loads(now)
                if self.elastic is not None:
                    self.elastic.poll(now)
                    self._requeue_preempted(active, now)
                # Maintenance skip: the host's last fully-skipped pass
                # published a horizon (``maint_valid_ms``) before which
                # its decisions cannot flip.  If nothing invalidating
                # happened since (``_maint_clean``), no work is queued
                # or staging, fits land synchronously (no background
                # thread can mutate a predictor mid-skip), and no
                # elastic controller can fire, the call is provably the
                # identical no-op — don't make it.
                host = self.host
                if not (self._maint_clean and self.elastic is None
                        and now < getattr(host, "maint_valid_ms",
                                          -math.inf)
                        and getattr(host, "sync_predictor_fits", False)
                        and not self.batcher.queues
                        and not self.loader.inflight):
                    host.predict_and_preload(now)
                    self._maint_clean = True
                self._stage_demand_loads(now)
            now = self._join_requests(active, now)
            apps = [a for a in sorted(active) if active[a]]
            if not apps:
                # Nothing decoding: jump to the next arrival, the
                # earliest load commit, or a prefetch trigger.
                t_next = pending[i].arrival_ms if i < n else math.inf
                if self.loader is not None:
                    t_next = min(t_next, self.loader.earliest_ready(),
                                 self.host.next_prefetch_trigger(now))
                if self.elastic is not None:
                    t_next = min(t_next, self.elastic.next_event_ms())
                if t_next is math.inf:
                    break
                now = max(now, t_next)
                continue
            app = max(apps, key=lambda a: (
                len(active[a]),
                -min(s.start_ms for s in active[a]), a))
            t0 = now
            now += self._step_ms(app, len(active[app]))
            self._note_span(t0, now, app)
            finished = []
            for s in active[app]:
                s.steps_done += 1
                if s.steps_done >= s.req.max_new:
                    finished.append(s)
            if finished:
                # Identity, not equality: _ActiveSeq carries the request
                # (whose prompt is an ndarray — == broadcasts).
                gone = {id(s) for s in finished}
                active[app] = [s for s in active[app]
                               if id(s) not in gone]
                for s in finished:
                    self._retire_seq(s, now)
        if self.loader is not None:
            self._reap_loads(math.inf)
        return self.stats()

    async def run_async(self, requests: Sequence[Request]) -> dict:
        """Asyncio entry point: replays the trace off the event loop."""
        return await asyncio.to_thread(self.run_trace, requests)

    # ------------------------------------------------------------------
    def stats(self) -> ServingStats:
        """Aggregate + per-tenant latency percentiles and throughput,
        plus the prefetch pipeline's hit/waste/overlap counters, as a
        typed :class:`~repro_torch.serving.stats.ServingStats` (fields of
        unattached subsystems stay ``None`` and drop out of
        ``to_dict()``)."""
        st = self.host.manager.state
        tens = st.tenants.values()
        total_req = sum(t.requests for t in tens)
        kw: dict = {
            "requests": len(self.results),
            "kv_downgrades": self.kv_downgrades,
            "kv_rejections": self.kv_rejections,
            "weight_failures": self.weight_failures,
            # Clamped KV over-release drift (0.0 in a healthy run; the
            # strict_kv flag turns any drift into a hard failure).
            "kv_overrelease_mb": st.kv_overrelease_mb,
            # Fraction of batch admissions arriving inside a predicted
            # window (the manager's on_request unit — one count per
            # admitted batch, not per request) — the live measure of
            # predictor leverage.
            "prediction_hit_rate": (
                sum(t.requests - t.unexpected for t in tens) / total_req
                if total_req else 0.0),
            "per_tenant": {},
            "warm_ratio": 0.0,
        }
        if self.loader is not None:
            kw.update(
                prefetch_hits=self.loader.prefetch_hits,
                prefetch_wasted=self.loader.prefetch_wasted,
                prefetch_shrunk=self.loader.prefetch_shrunk,
                demand_loads=self.loader.demand_loads,
                loads_committed=self.loader.loads_committed,
                load_overlap_ms=self.loader.load_overlap_ms,
                fits_scheduled=self.loader.fits_scheduled)
            shards = getattr(self.loader, "shards_landed", None)
            if shards is not None:
                kw["shards_landed"] = shards
            # Wire accounting (getattr: protocol fakes may predate it).
            wire = getattr(self.loader, "wire_mb_staged", None)
            if wire is not None:
                kw["wire_mb_staged"] = wire
                kw["inplace_downgrades"] = getattr(
                    self.loader, "inplace_downgrades", 0)
        devices = st.devices
        if devices is not None:
            # Cross-device victim migrations (admission + loader paths;
            # the ledger counts them where the moves commit).
            kw["shards_migrated"] = devices.shards_migrated
        if st.kv_pool is not None:
            kw.update(
                kv_page_mb=st.kv_pool.page_mb,
                kv_pages_total=st.kv_pool.n_pages,
                kv_pages_used=st.kv_pool.used_pages,
                kv_preemptions=self.host.manager.kv_preemptions)
        if self.elastic is not None:
            kw.update(
                chips_lost=self.elastic.chips_lost,
                chips_recovered=self.elastic.chips_recovered,
                drain_migrations=self.elastic.drain_migrations,
                drain_downgrades=self.elastic.drain_downgrades,
                repromotions=self.elastic.repromotions)
        if not self.results:
            return ServingStats(**kw)
        # One pass over results: warm count, the global trace span, and
        # the per-tenant buckets all come out of a single walk instead
        # of a fresh min/max/filter scan per aggregate and per tenant.
        warm = 0
        origin = math.inf
        t_end = -math.inf
        by_app: Dict[str, List[RequestResult]] = {}
        for r in self.results:
            warm += r.warm
            origin = min(origin, r.arrival_ms)
            t_end = max(t_end, r.done_ms)
            by_app.setdefault(r.app, []).append(r)
        kw["warm_ratio"] = warm / len(self.results)
        span_ms = t_end - origin
        kw["requests_per_sec"] = (
            len(self.results) / (span_ms / 1e3) if span_ms > 0 else 0.0)
        for app in sorted(by_app):
            rs = by_app[app]
            ok = [r.latency_ms for r in rs if not r.failed]
            lat = (dict(zip(
                ("p50_ms", "p95_ms", "p99_ms"),
                (float(x) for x in np.percentile(ok, (50, 95, 99)))))
                if ok else {"p50_ms": float("inf"),
                            "p95_ms": float("inf"),
                            "p99_ms": float("inf")})
            t_span = (max(r.done_ms for r in rs)
                      - min(r.arrival_ms for r in rs))
            kw["per_tenant"][app] = {
                "requests": len(rs),
                "warm_ratio": sum(r.warm for r in rs) / len(rs),
                "fail_ratio": sum(r.failed for r in rs) / len(rs),
                "mean_batch": float(np.mean([r.batch_size for r in rs])),
                "throughput_rps": (len(rs) / (t_span / 1e3)
                                   if t_span > 0 else 0.0),
                **lat,
            }
        return ServingStats(**kw)

    def check_event_invariant(self, budget_mb: Optional[float] = None
                              ) -> None:
        """Every recorded event must respect the memory budget —
        committed memory *and* in-flight background-load claims; on a
        sharded mesh, every chip's weights + shard claims must respect
        the per-device budget *that held at event time* (chip loss and
        recovery change the ledger mid-run)."""
        if self.audit != "full":
            raise RuntimeError(
                "check_event_invariant needs audit='full' (per-event "
                f"usage snapshots); this engine runs audit={self.audit!r}")
        budget = (budget_mb if budget_mb is not None
                  else self.host.manager.state.budget_mb)
        for ev in self.events:
            if ev.used_mb + ev.inflight_mb > budget + 1e-6:
                raise AssertionError(
                    f"budget exceeded at t={ev.t_ms:.1f}ms "
                    f"({ev.kind} {ev.app}): {ev.used_mb:.2f}MB "
                    f"+ {ev.inflight_mb:.2f}MB in-flight "
                    f"> {budget:.2f}MB")
            if ev.device_mb is None or ev.device_budget_mb is None:
                continue
            for d, mb in enumerate(ev.device_mb):
                if mb > ev.device_budget_mb[d] + 1e-6:
                    raise AssertionError(
                        f"device {d} over budget at t={ev.t_ms:.1f}ms "
                        f"({ev.kind} {ev.app}): {mb:.2f}MB "
                        f"> {ev.device_budget_mb[d]:.2f}MB")


# ---------------------------------------------------------------------------
# Trace-driven load generation (reuses the simulator's arrival process)
# ---------------------------------------------------------------------------
def trace_from_workload(wl: Workload, cfgs: Dict[str, ModelConfig], *,
                        seed: int = 0, prompt_len: Tuple[int, int] = (4, 12),
                        max_new: int = 8) -> List[Request]:
    """Materialize a simulator :class:`Workload` as real serving requests:
    same Poisson per-tenant timestamps, random prompts per tenant vocab."""
    rng = np.random.default_rng(seed)
    reqs = []
    for t, app in wl.requests:
        plen = int(rng.integers(*prompt_len))
        prompt = rng.integers(
            0, cfgs[app].vocab_size, plen).astype(np.int32)
        reqs.append(Request(app=app, prompt=prompt, max_new=max_new,
                            arrival_ms=t))
    return reqs


def fast_trace_from_workload(wl: Workload, cfgs: Dict[str, ModelConfig],
                             *, seed: int = 0,
                             prompt_len: Tuple[int, int] = (4, 12),
                             max_new: int = 8) -> List[Request]:
    """Vectorized materializer for large replays: one batched draw for
    every prompt length, prompt arrays shared from a per-(app, length)
    pool.  The sim executor's virtual service time reads only the
    prompt *length*, so sharing the array is behaviour-identical there;
    don't use this with the real executor, where token content reaches
    the model.  Draw order differs from :func:`trace_from_workload`
    (whose per-request order is contractual), so this is a separate
    entry point, not a fast path inside it."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(*prompt_len, size=len(wl.requests))
    pool: Dict[Tuple[str, int], np.ndarray] = {}
    reqs = []
    for (t, app), plen in zip(wl.requests, lens):
        key = (app, int(plen))
        prompt = pool.get(key)
        if prompt is None:
            prompt = pool[key] = rng.integers(
                0, cfgs[app].vocab_size, int(plen)).astype(np.int32)
        reqs.append(Request(app=app, prompt=prompt, max_new=max_new,
                            arrival_ms=t))
    return reqs


def poisson_trace(cfgs: Dict[str, ModelConfig], *,
                  requests_per_app: int = 20,
                  mean_iat_ms: float = 2000.0,
                  deviation: float = 0.3,
                  seed: int = 0,
                  prompt_len: Tuple[int, int] = (4, 12),
                  max_new: int = 8) -> Tuple[List[Request], Workload]:
    """Convenience: generate_workload → requests, returning both so the
    caller can feed predictions to the manager if desired."""
    wl = generate_workload(list(cfgs), requests_per_app=requests_per_app,
                           mean_iat_ms=mean_iat_ms, deviation=deviation,
                           seed=seed)
    return trace_from_workload(wl, cfgs, seed=seed,
                               prompt_len=prompt_len, max_new=max_new), wl
