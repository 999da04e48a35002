"""The NN Model Manager (§III-A): request/memory predictors + memory
optimizer + model loader, orchestrating the eviction policies.

``EdgeMultiAI`` is the framework object: it owns the MemoryState and does
the warm/cold accounting.  Every residency decision it makes — admission
procurement, KV headroom scavenging, self-downgrade, the desperation
backstop, cross-device migration — is *built* as a
:class:`~repro_torch.core.actions.ResidencyPlan` and *enacted* through the one
transactional applier, ``MemoryState.apply``; physical weight moves
mirror the applied actions through the ``loader`` callback.  It is used
two ways:

* driven by the **simulator** (paper-faithful evaluation, Figs 4–10) with
  an externally generated predicted workload, and
* driven by the **serving runtime** (repro_torch.serving) with live RNN
  predictors, where "load" means staging real tenant weights to device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.core import actions as A
from repro_torch.core.memory_state import INF, MemoryState, TenantState
from repro_torch.core.model_zoo import ModelVariant, ModelZoo
from repro_torch.core.policies import (DemandContext, FallbackPolicy, Policy,
                                 PolicyLike, ProcurePlan,
                                 kv_page_victim_plan, resolve_fallback,
                                 resolve_policy)

# Inference time is load_ms/12 by default: the 8–17× load/infer asymmetry
# measured in the paper's Table I (midpoint), which is what makes
# cold-starts catastrophic and this whole framework worthwhile.
LOAD_OVER_INFER = 12.0


@dataclass
class BatchAdmission:
    """Outcome of admitting one serving batch: weights resident (possibly
    after procurement) *and* its KV cache charged against the budget."""
    app: str
    t: float
    kv_mb: float  # charged KV MB (0 when failed)
    warm: bool
    failed: bool
    bits: Optional[int]
    self_downgraded: bool = False  # requester shrank to fit its own cache
    kv_rejected: bool = False  # failed specifically for cache pressure


@dataclass
class InferenceRecord:
    app: str
    t: float
    warm: bool
    failed: bool
    expected: bool  # arrived inside a predicted window
    bits: Optional[int]
    accuracy: float
    latency_ms: float


class EdgeMultiAI:
    """Framework facade: policy-driven multi-tenant model management."""

    #: EWMA weight for the arrival-residual estimate behind the adaptive
    #: prediction window (satellite of the plan-IR PR).
    RESID_ALPHA = 0.3

    def __init__(
        self,
        zoos: Dict[str, ModelZoo],
        budget_mb: float,
        policy: PolicyLike = "iws-bfe",
        delta_ms: float = 500.0,
        history_ms: float = 3000.0,
        loader: Optional[Callable[[str, Optional[ModelVariant]], None]] = None,
        fallback: "FallbackPolicy | str | None" = "desperation",
        adaptive_delta: bool = False,
        migrate: bool = True,
    ):
        self.state = MemoryState(
            budget_mb=budget_mb,
            tenants={a: TenantState(zoo=z) for a, z in zoos.items()})
        # ``policy`` resolves through the registry: a name, a Policy class,
        # or a ready instance; "none" (the paper's unmanaged baseline)
        # disables procurement entirely.
        self.policy: Optional[Policy] = (
            None if policy == "none" else resolve_policy(policy))
        self.policy_name = (policy if isinstance(policy, str)
                            else self.policy.name)
        # What backstops an unfundable plan in the serving runtime; the
        # unmanaged baseline has no eviction authority, so no fallback.
        self.fallback: Optional[FallbackPolicy] = (
            None if self.policy is None else resolve_fallback(fallback))
        self.delta = delta_ms
        self.history = history_ms
        # Adaptive prediction window: per-tenant Δ from the EWMA of
        # measured arrival residuals |t_actual − t_pred| (off by default
        # — the paper's fixed Δ).  ``delta_for`` is the single read path.
        self.adaptive_delta = adaptive_delta
        self._residuals: Dict[str, float] = {}
        # Cross-device victim migration: when a chip's budget blocks an
        # admission load while neighbors idle, move a resident victim's
        # shards instead of downgrading/failing (sharded mesh only).
        self.migrate = migrate
        self.records: List[InferenceRecord] = []
        self.kv_rejections = 0  # batches rejected for KV pressure
        # Paged-KV preemption (continuous batching): sequences whose
        # pages were evicted as victims of another tenant's admission.
        # The engine drains ``take_preempted`` and requeues them.
        self.kv_preemptions = 0
        self._preempted: List[tuple] = []
        self._loader = loader  # real weight mover (serving runtime)
        # Admission-path migration observer (t_ms, app, mb): the serving
        # runtime wires this to the loader's event hook so MigrateShard
        # moves show up in the engine's audit trail like loader-path
        # migrations do.
        self.on_migrate: Optional[Callable[[float, str, float],
                                           None]] = None

    # ------------------------------------------------------------------
    def _apply_actions(self, actions: Iterable[A.Action],
                       now: Optional[float] = None) -> None:
        """Enact residency actions: one transactional ``state.apply``,
        then mirror each action to the physical loader in the same order
        the accounting committed them (a migrated victim is restaged so
        device contents track the ledger; a same-variant restage is a
        no-op for the runtime)."""
        actions = tuple(actions)
        if not actions:
            return
        self.state.apply(A.ResidencyPlan(actions))
        for act in actions:
            if isinstance(act, A.RESIDENCY_ACTIONS):
                if self._loader:
                    self._loader(act.app, act.variant)
            elif isinstance(act, A.MigrateShard):
                if self._loader:
                    self._loader(act.app,
                                 self.state.tenants[act.app].loaded)
                if self.on_migrate is not None and now is not None:
                    self.on_migrate(now, act.app, act.mb)

    def _enact(self, plan: ProcurePlan) -> None:
        self._apply_actions(A.procure_actions(plan))

    def _procure(self, app: str, now: float) -> ProcurePlan:
        return self.policy.plan_procure(self.state, app, now,
                                        delta=self.delta_for(app),
                                        history=self.history)

    # ------------------------------------------------------------------
    def delta_for(self, app: str) -> float:
        """The prediction-window half-width Δ for one tenant: the
        configured constant, or — with ``adaptive_delta`` — twice the
        EWMA of the tenant's measured arrival residuals, clamped to
        [Δ/4, 2Δ] so a lucky streak cannot collapse the window to zero
        nor a noisy tenant inflate it without bound."""
        if not self.adaptive_delta:
            return self.delta
        r = self._residuals.get(app)
        if r is None:
            return self.delta
        return min(max(2.0 * r, 0.25 * self.delta), 2.0 * self.delta)

    def _observe_residual(self, app: str, now: float) -> None:
        t = self.state.tenants[app]
        if t.predicted_next is INF or math.isinf(t.predicted_next):
            return
        resid = abs(now - t.predicted_next)
        prev = self._residuals.get(app)
        self._residuals[app] = (
            resid if prev is None
            else self.RESID_ALPHA * resid + (1 - self.RESID_ALPHA) * prev)

    def set_prediction(self, app: str, t_pred: float) -> None:
        self.state.tenants[app].predicted_next = t_pred

    def plan_proactive(self, app: str, now: float) -> Optional[ProcurePlan]:
        """The planning half of :meth:`proactive_load`: decide what a
        t_pred − Δ − θ trigger would stage, without enacting it.  The
        serving runtime routes the returned plan to the background loader
        so the weight transfer happens off the hot path; the simulator
        keeps the synchronous :meth:`proactive_load` wrapper."""
        if self.policy is None:
            return None
        t = self.state.tenants[app]
        if t.loaded is t.zoo.largest or t.inflight_mb > 0.0:
            return None
        plan = self._procure(app, now)
        return plan if plan.ok else None

    def proactive_load(self, app: str, now: float) -> None:
        """Fires at t_pred − Δ − θ: stage the highest-precision model that
        fits, ahead of the predicted request (the maximalist promotion)."""
        plan = self.plan_proactive(app, now)
        if plan is not None:
            self._enact(plan)

    def plan_prefetch(self, app: str, now: float) -> Optional[ProcurePlan]:
        """Speculative plan for the background loader — delegated to the
        policy's ``plan_prefetch`` hook (default: eviction-free,
        surplus-only; see :class:`~repro_torch.core.policies.Policy`)."""
        if self.policy is None:
            return None
        return self.policy.plan_prefetch(self.state, app, now,
                                         delta=self.delta_for(app),
                                         history=self.history)

    def plan_demand(self, app: str, now: float, kv_mb: float = 0.0,
                    demand: Optional[DemandContext] = None
                    ) -> Optional[ProcurePlan]:
        """Plan a load for a *cold* tenant with requests already queued,
        for the background loader: the engine stages the weights off the
        loop and keeps serving other tenants instead of blocking inside
        the admit path.  ``demand`` carries the waiting queue's cache
        needs (head batch and full-queue bound); the policy's
        ``plan_demand`` hook stages its chosen charge as a pending
        planning reservation so the variant leaves room for the cache
        (no load-then-downgrade thrash at admission).  ``kv_mb`` is the
        pre-protocol shorthand for a head-batch-only context.  Returns
        None when the tenant is already resident/mid-staging or no
        variant fits (admission will then record the counted failure).
        """
        if self.policy is None:
            return None
        t = self.state.tenants[app]
        if t.loaded is not None or t.inflight_mb > 0.0:
            return None
        if demand is None:
            demand = DemandContext(kv_head_mb=kv_mb, kv_full_mb=kv_mb,
                                   queue_depth=1, max_batch=1)
        plan = self.policy.plan_demand(self.state, app, now, demand,
                                       delta=self.delta_for(app),
                                       history=self.history)
        if plan is None and self.fallback is not None:
            # Serving never fails what the fallback can fund: free the
            # smallest variant's footprint ignoring window/history
            # protections, then load exactly that — a maximalist
            # re-procure here would snowball the evictions it just
            # forced into an even bigger claim.  (The fallback's
            # evictions are enacted here as one atomic plan: the pure
            # policies stay pure over the *current* state.)
            with self.state.pending(self.policy.demand_charge(demand)):
                self._desperate_evict(app, t.zoo.smallest.size_mb)
                if self.state.free_mb >= t.zoo.smallest.size_mb:
                    plan = ProcurePlan(app, t.zoo.smallest)
        return plan if plan is not None and plan.ok else None

    def _desperate_evict(self, app: str, need_mb: float, *,
                         seq: Optional[int] = None,
                         now: Optional[float] = None) -> None:
        """Enact the fallback policy's evictions for ``app``'s need —
        built as one plan, applied all-or-nothing.  With a KV page pool
        installed and a page-granular charge (``seq`` set), cold KV
        pages join the victim class: whole-model evictions and other
        sequences' page evictions compose into the *same* atomic plan,
        and the preempted sequences are recorded for the engine to
        requeue."""
        evs = (self.fallback.plan(self.state, app, need_mb)
               if self.fallback is not None else ())
        acts: tuple = A.eviction_actions(evs)
        pool = self.state.kv_pool
        if pool is not None and seq is not None:
            acts += kv_page_victim_plan(
                self.state, app, need_mb=need_mb,
                need_pages=pool.pages_for(need_mb),
                extra_free_mb=sum(e.freed_mb for e in evs))
        if not acts:
            return
        self._apply_actions(acts, now=now)
        for act in acts:
            if isinstance(act, A.EvictKV) and act.seq is not None:
                self.kv_preemptions += 1
                self._preempted.append((act.app, act.seq))

    def take_preempted(self) -> tuple:
        """Drain the (app, seq) pairs evicted as page victims since the
        last call — the engine requeues their requests."""
        out = tuple(self._preempted)
        self._preempted.clear()
        return out

    def on_request(self, app: str, now: float) -> InferenceRecord:
        t = self.state.tenants[app]
        expected = self.state.in_window(app, now, self.delta_for(app),
                                        t.zoo.largest.load_ms)
        # Close the predictor-quality loop *after* the window check: the
        # adapted Δ a request sees comes from prior residuals, then this
        # arrival's |t_actual − t_pred| feeds the EWMA for the next one.
        self._observe_residual(app, now)
        t.requests += 1
        if not expected:
            t.unexpected += 1

        if t.loaded is not None:
            variant = t.loaded
            warm, failed = True, False
            # §III-A: upon each request the memory optimizer re-determines
            # the highest-precision model loadable.  For *expected* requests
            # the load was already fired θ early (proactive), so an upgrade
            # here overlaps the Δ slack; unexpected requests must be served
            # immediately by whatever is resident (the WS mechanism).
            if expected and self.policy is not None \
                    and variant is not t.zoo.largest:
                plan = self._procure(app, now)
                if plan.ok and plan.variant.size_mb > variant.size_mb:
                    self._enact(plan)
                    variant = plan.variant
            latency = variant.load_ms / LOAD_OVER_INFER
        elif self.policy is None:
            # No framework: on-demand FP32 load, no eviction authority.
            big = t.zoo.largest
            if self.state.free_mb >= big.size_mb:
                self._apply_actions((A.Load(app, big),))
                variant, warm, failed = big, False, False
                latency = big.load_ms + big.load_ms / LOAD_OVER_INFER
            else:
                variant, warm, failed = None, False, True
                latency = math.inf
        else:
            plan = self._procure(app, now)
            if plan.ok:
                self._enact(plan)
                variant, warm, failed = plan.variant, False, False
                latency = (variant.load_ms
                           + variant.load_ms / LOAD_OVER_INFER)
            else:
                variant, warm, failed = None, False, True
                latency = math.inf

        t.last_request = now
        rec = InferenceRecord(
            app=app, t=now, warm=warm, failed=failed, expected=expected,
            bits=variant.bits if variant else None,
            accuracy=variant.accuracy if variant else 0.0,
            latency_ms=latency)
        self.records.append(rec)
        return rec

    # ------------------------------------------------------------------
    # KV-cache residency (serving runtime): batches charge their decode
    # caches against the same budget the eviction policies manage.
    # ------------------------------------------------------------------
    def _kv_short(self, kv_mb: float, seq: Optional[int]) -> bool:
        """Would charging ``kv_mb`` fail right now?  Global budget always;
        with a page pool and a page-granular charge, the pool's free
        pages must cover the rounded page count too (fragmentation the
        scalar check cannot see)."""
        if self.state.free_mb < kv_mb:
            return True
        pool = self.state.kv_pool
        if pool is not None and seq is not None:
            return pool.free_pages < pool.pages_for(kv_mb)
        return False

    def admit_batch(self, app: str, now: float, kv_mb: float,
                    demand_cold: bool = False,
                    seq: Optional[int] = None) -> BatchAdmission:
        """Admit one batch: ensure weights are resident (procuring if
        needed), then charge ``kv_mb`` of cache.  The KV need is staged as
        a pending planning charge during procurement so the policies pick
        a variant that leaves room for the cache up front (one weight
        transfer, no load-then-downgrade thrash).  If pressure remains
        (e.g. the tenant was already warm at a large variant), scavenge
        victims' weight memory, then downgrade the requester itself; if
        the cache still cannot fit, the batch is rejected and counted —
        never an invariant assert.

        ``demand_cold``: the weights are only resident because a
        demand-triggered background load just committed for this very
        batch — the request waited out the transfer, so the serve is
        recorded as a cold start (latency includes the load) even though
        ``loaded`` is non-None by admission time."""
        t = self.state.tenants[app]
        with self.state.pending(kv_mb):
            rec = self.on_request(app, now)
            if rec.failed and self.policy is not None:
                # The pure policies refuse to unload (iWS-BFE only ever
                # replaces), but in the serving runtime a failure is
                # strictly worse than evicting an idle tenant: free the
                # smallest variant's footprint ignoring protections and
                # serve degraded (smallest only — not a maximalist
                # re-procure, which would snowball the forced evictions
                # into an even bigger claim).
                self._desperate_evict(app, t.zoo.smallest.size_mb)
                small = t.zoo.smallest
                if self.state.free_mb >= small.size_mb:
                    self._enact(ProcurePlan(app, small))
                    rec.failed, rec.warm = False, False
                    rec.bits = small.bits
                    rec.accuracy = small.accuracy
                    rec.latency_ms = (small.load_ms
                                      * (1.0 + 1.0 / LOAD_OVER_INFER))
        if rec.failed:
            # Attribute the failure: if weights alone would have been
            # procurable without the staged KV need, this is cache
            # pressure, not weight capacity.
            if self.policy is None:
                kv_rej = self.state.free_mb >= t.zoo.largest.size_mb
            else:
                kv_rej = kv_mb > 0 and self._procure(app, now).ok
            if kv_rej:
                self.kv_rejections += 1
            return BatchAdmission(app, now, 0.0, rec.warm, True, None,
                                  kv_rejected=kv_rej)
        if self._kv_short(kv_mb, seq) and self.policy is not None:
            self._apply_actions(A.eviction_actions(
                self.policy.plan_headroom(self.state, app, now, kv_mb,
                                          delta=self.delta_for(app),
                                          history=self.history)))
        self_downgraded = False
        if self.policy is not None and t.loaded is not None \
                and self.state.free_mb < kv_mb:
            # Self-downgrade, planned: walk the zoo down until the freed
            # weight difference funds the cache, then apply one
            # Downgrade to the final variant (identical resolution to
            # the old step-by-step loop, one transaction and one
            # physical restage instead of N).
            v, freed = t.loaded, 0.0
            while (self.state.free_mb + freed < kv_mb
                   and (nxt := t.zoo.next_smaller(v)) is not None):
                freed += v.size_mb - nxt.size_mb
                v = nxt
            if v is not t.loaded:
                self._apply_actions(
                    (A.downgrade_action(app, t.loaded, v),))
                self_downgraded = True
        if (self.policy is not None and self.state.devices is not None
                and t.loaded is not None and self.migrate
                and not self.state.devices.fits_variant(app, t.loaded)):
            # Cross-device victim migration: the admission load was
            # planned against the *global* budget (policies are
            # device-blind) and one chip overflowed while neighbors
            # idle.  Before downgrading the whole load, try moving
            # resident victims' shards to the free chips — simulate
            # first, then commit the moves as one atomic plan.
            moves = A.plan_migration(
                self.state, app,
                (0.0,) * self.state.devices.n_devices)
            if moves is not None and \
                    self.state.simulate(A.ResidencyPlan(moves)) is None:
                self._apply_actions(moves, now=now)
        if (self.policy is not None and self.state.devices is not None
                and t.loaded is not None
                and not self.state.devices.fits_variant(app, t.loaded)):
            # Sharded mesh fallback: no migration could relieve the
            # chip, so downgrade until every shard fits its device —
            # the same resolution an unfundable sharded background load
            # feeds into.  Planned as one Downgrade to the first
            # fitting variant.
            v = t.loaded
            while (v is not None
                   and not self.state.devices.fits_variant(app, v)):
                v = t.zoo.next_smaller(v)
            if v is not None and v is not t.loaded:
                self._apply_actions(
                    (A.downgrade_action(app, t.loaded, v),))
                self_downgraded = True
        if (self.state.devices is not None and t.loaded is not None
                and not self.state.devices.fits_variant(app, t.loaded)):
            # Even the smallest shard overflows its chip: reject rather
            # than commit over-budget per-device state (the global-path
            # analogue is an unprocurable plan — a counted weight
            # failure, never an invariant violation later).
            self._apply_actions((A.Unload(app),))
            rec.warm, rec.failed, rec.bits = False, True, None
            rec.accuracy, rec.latency_ms = 0.0, math.inf
            return BatchAdmission(app, now, 0.0, False, True, None,
                                  self_downgraded, kv_rejected=False)
        if self._kv_short(kv_mb, seq) and self.policy is not None:
            # Desperation: rejecting the batch is the worst outcome, so
            # the window/history protections yield before the cache does
            # — and, page-granular, other tenants' cold KV pages join
            # the victim class in the same plan.
            self._desperate_evict(app, kv_mb, seq=seq, now=now)
        if self._kv_short(kv_mb, seq):
            self.kv_rejections += 1
            # The inference never executes: retract the success record
            # on_request logged so Metrics agree with the engine (a
            # rejected request is neither warm nor served).
            rec.warm, rec.failed, rec.bits = False, True, None
            rec.accuracy, rec.latency_ms = 0.0, math.inf
            return BatchAdmission(app, now, 0.0, False, True, None,
                                  self_downgraded, kv_rejected=True)
        # Scavenging/self-downgrade may have swapped the serving variant
        # after on_request recorded it: sync the record to what actually
        # serves so Metrics report the right bits/accuracy.
        final = t.loaded
        if rec.bits != final.bits:
            rec.bits, rec.accuracy = final.bits, final.accuracy
            rec.latency_ms = (
                final.load_ms / LOAD_OVER_INFER if rec.warm
                else final.load_ms + final.load_ms / LOAD_OVER_INFER)
        if demand_cold and rec.warm:
            rec.warm = False
            rec.latency_ms = (final.load_ms
                              + final.load_ms / LOAD_OVER_INFER)
        try:
            self._apply_actions((A.ChargeKV(app, kv_mb, seq=seq),))
        except A.PlanError:
            # Page-granular only: the scalar checks passed but the pool
            # could not fund the rounded page count (e.g. a concurrent
            # holder).  A counted rejection, never an invariant assert.
            self.kv_rejections += 1
            rec.warm, rec.failed, rec.bits = False, True, None
            rec.accuracy, rec.latency_ms = 0.0, math.inf
            return BatchAdmission(app, now, 0.0, False, True, None,
                                  self_downgraded, kv_rejected=True)
        return BatchAdmission(app, now, kv_mb, rec.warm, False,
                              final.bits, self_downgraded)

    def release_kv(self, app: str, kv_mb: float,
                   seq: Optional[int] = None) -> None:
        """A batch retired: return its cache memory to the pool.  With a
        ``seq``, the page pool frees exactly that sequence's pages."""
        self._apply_actions((A.EvictKV(app, kv_mb, seq=seq),))

    # ------------------------------------------------------------------
    def metrics(self) -> "Metrics":
        return Metrics(self.records, self.state)


@dataclass
class Metrics:
    records: List[InferenceRecord]
    state: MemoryState

    @property
    def total(self) -> int:
        return len(self.records)

    @property
    def warm_ratio(self) -> float:
        return (sum(r.warm for r in self.records) / self.total
                if self.total else 0.0)

    @property
    def cold_ratio(self) -> float:
        return (sum((not r.warm) and (not r.failed) for r in self.records)
                / self.total if self.total else 0.0)

    @property
    def fail_ratio(self) -> float:
        return (sum(r.failed for r in self.records) / self.total
                if self.total else 0.0)

    def mean_accuracy(self, normalize: bool = True) -> float:
        """Mean inference accuracy; min-max normalized per app (Fig 6)."""
        vals = []
        for r in self.records:
            if r.failed:
                continue
            if normalize:
                zoo = self.state.tenants[r.app].zoo
                lo = min(v.accuracy for v in zoo.variants)
                hi = max(v.accuracy for v in zoo.variants)
                vals.append((r.accuracy - lo) / max(hi - lo, 1e-9))
            else:
                vals.append(r.accuracy / 100.0)
        return sum(vals) / len(vals) if vals else 0.0

    def robustness(self) -> float:
        """Paper Eq. 4: R = mean_i [ (warm_i / total_i) · ψ_i ]."""
        apps = {r.app for r in self.records}
        terms = []
        for a in apps:
            rs = [r for r in self.records if r.app == a]
            warm = sum(r.warm for r in rs) / len(rs)
            psi = sum(r.expected for r in rs) / len(rs)
            terms.append(warm * psi)
        return sum(terms) / len(terms) if terms else 0.0

    def per_app(self) -> Dict[str, dict]:
        out = {}
        for a in sorted({r.app for r in self.records}):
            rs = [r for r in self.records if r.app == a]
            ok = [r for r in rs if not r.failed]
            zoo = self.state.tenants[a].zoo
            lo = min(v.accuracy for v in zoo.variants)
            hi = max(v.accuracy for v in zoo.variants)
            out[a] = {
                "requests": len(rs),
                "warm_ratio": sum(r.warm for r in rs) / len(rs),
                "cold_ratio": sum(not r.warm and not r.failed
                                  for r in rs) / len(rs),
                "fail_ratio": sum(r.failed for r in rs) / len(rs),
                "accuracy": (sum(r.accuracy for r in ok) / len(ok)
                             if ok else 0.0),
                "norm_accuracy": (sum((r.accuracy - lo) / max(hi - lo, 1e-9)
                                      for r in ok) / len(ok) if ok else 0.0),
                "max_accuracy": hi,
                "mean_latency_ms": (sum(r.latency_ms for r in ok) / len(ok)
                                    if ok else float("inf")),
            }
        return out
