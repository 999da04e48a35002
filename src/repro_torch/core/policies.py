"""The paper's four NN-model eviction policies (§III-B).

Each policy answers one question: application ``app`` needs a model loaded
at time ``now`` — which variant do we load, and which victims' models do we
evict or downgrade to make room?

All policies are pure: they take a :class:`MemoryState` (not mutated) and
return a :class:`ProcurePlan`; the manager enacts plans.  Semantics follow
the paper precisely:

* **LFE** — evict the minimalist app with the *largest* loaded model first,
  repeat; if evicting everything is not enough, retry with the requester's
  next-smaller variant.
* **BFE** — evict the minimalist app whose loaded size is *closest from
  above* to the remaining need (best fit; falls back to largest-below).
* **WS-BFE** — BFE restricted to victims whose request window does NOT
  overlap the requester's, and victims are *downgraded to their
  lowest-precision variant* instead of unloaded — so an unpredicted request
  still warm-starts (the paper's key robustness mechanism).
* **iWS-BFE** (Algorithm 1) — WS-BFE plus an LRU-K-style history filter
  (apps requested during the history window H are not candidates) and a
  Bayesian fitness score (Eq. 3) served from a max-heap:
      Score(A_j) = norm(t_j − now) · [1 − P(r_j | A_i ∈ A*)]

Policies are consumed through the class-based :class:`Policy` protocol
(``plan_procure`` / ``plan_prefetch`` / ``plan_demand`` / ``victim_filter``
hooks) and the ``@register_policy`` registry; new policies plug in without
touching the manager (see :class:`BatchAware` for the first plugin).
Resolve a policy by its paper name with :func:`resolve_policy` and
enumerate what is registered with :func:`available_policies`.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, ClassVar, Dict, List, Optional, Tuple, Union

from repro_torch.core import actions as A
# Policy-level plan records live in repro_torch.core.actions (the IR layer);
# re-exported here because this module is their historical home.
from repro_torch.core.actions import Eviction, ProcurePlan
from repro_torch.core.memory_state import INF, MemoryState
from repro_torch.core.model_zoo import ModelVariant


@dataclass(frozen=True)
class DemandContext:
    """What a demand (cold tenant, requests queued) load is planning for.

    ``kv_head_mb`` is the queued head batch's cache need as it looks right
    now; ``kv_full_mb`` is the cache need of the batch the queue could
    produce *by admission time* (a full ``max_batch``-wide batch at the
    queued shapes — under a burst more requests arrive while the weight
    transfer stages, so the head-batch snapshot undershoots).  The base
    protocol plans with the head batch; :class:`BatchAware` plans with the
    full-queue bound.
    """
    kv_head_mb: float
    kv_full_mb: float
    queue_depth: int
    max_batch: int


def variant_score(variant: ModelVariant, idle_ms: float) -> float:
    """The cost-aware ranking score shared by :class:`CostBFE` and the
    elastic drain planner (``repro_torch.serving.elastic.drain_plan``):

        score(v) = accuracy(v) · min(1, idle_ms / load_ms(v))

    ``idle_ms`` is the gap until the tenant's next predicted request;
    the readiness factor is the fraction of ``v``'s (re)load that gap
    could hide.  An unpredicted tenant (``idle_ms`` = ∞) scores pure
    accuracy — there is no known deadline to miss.
    """
    ready = (1.0 if idle_ms == INF
             else min(1.0, max(idle_ms, 0.0) / max(variant.load_ms, 1e-9)))
    return variant.accuracy * ready


def _free_after(state: MemoryState, app: str,
                evictions: List[Eviction]) -> float:
    """Free memory once evictions are enacted and app's current model (if
    any) is released for replacement."""
    free = state.free_mb + sum(e.freed_mb for e in evictions)
    cur = state.tenants[app].loaded
    if cur is not None:
        free += cur.size_mb
    return free


def _windows_overlap(state: MemoryState, a: str, b: str,
                     delta: float) -> bool:
    ta, tb = state.tenants[a], state.tenants[b]
    lo_a, hi_a = ta.window(delta)
    lo_b, hi_b = tb.window(delta)
    if lo_a is INF or lo_b is INF:
        return False
    return lo_a <= hi_b and lo_b <= hi_a


def _downgrade_candidates(state: MemoryState, app: str, now: float,
                          delta: float, *, require_history: float = 0.0,
                          include_smallest: bool = False) -> List[str]:
    out = []
    for a in state.minimalist_set(now, delta):
        t = state.tenants[a]
        if a == app or t.loaded is None:
            continue
        if t.inflight_mb > 0.0:
            continue  # mid-staging: a background load owns this tenant's
            # residency until it commits or is cancelled; downgrading it
            # underneath the loader would desync the in-flight charge
        if t.loaded is t.zoo.smallest and not include_smallest:
            continue  # nothing to scavenge (unless unloading outright)
        if _windows_overlap(state, app, a, delta):
            continue  # lowest eviction priority: skip (paper §III-B-4)
        if require_history and t.last_request > now - require_history:
            continue  # LRU-K filter: recently-requested apps are exempt
        out.append(a)
    return out


def _scavenge_best_fit(state: MemoryState, cands: List[str],
                       shortfall: Callable[[List[Eviction]], float]
                       ) -> List[Eviction]:
    """Greedy best-fit downgrade selection shared by WS-BFE and the KV
    headroom path: pick the victim whose scavengeable size (loaded −
    smallest) covers the remaining ``shortfall`` with least waste — or
    the largest available when none covers — until the shortfall is met
    or candidates run out."""
    def scavengeable(a: str) -> float:
        t = state.tenants[a]
        return t.loaded.size_mb - t.zoo.smallest.size_mb

    remaining = list(cands)
    evictions: List[Eviction] = []
    while (need := shortfall(evictions)) > 0 and remaining:
        covering = [a for a in remaining if scavengeable(a) >= need]
        pick = (min(covering, key=scavengeable) if covering
                else max(remaining, key=scavengeable))
        remaining.remove(pick)
        t = state.tenants[pick]
        evictions.append(Eviction(pick, t.loaded, t.zoo.smallest))
    return evictions


# ---------------------------------------------------------------------------
# Policy protocol + registry
# ---------------------------------------------------------------------------
class Policy:
    """Class-based policy protocol: the manager (and any host runtime)
    talks to policies exclusively through these four hooks plus the
    headroom planner.  All hooks are pure over the passed state — a
    policy never enacts; the manager does.

    * :meth:`victim_filter` — which tenants this policy may evict or
      downgrade for ``app``'s need (the per-policy candidate rule).
    * :meth:`plan_procure` — the paper's procurement: choose a variant
      for ``app`` plus the evictions that fund it.
    * :meth:`plan_prefetch` — speculative (predictor-driven) plan for a
      background load; the default is eviction-free surplus-only, since
      speculation must never destabilize residents.
    * :meth:`plan_demand` — plan a cold tenant's load with its queued
      batch's cache need staged as a planning charge (via
      :class:`DemandContext`); the default charges the head batch.
    * :meth:`plan_headroom` — scavenge weight memory for a cache that no
      longer fits beside the resident weights.

    Subclasses registered with :func:`register_policy` resolve by name
    through :func:`resolve_policy`; instances are stateless, so one
    instance may serve any number of managers.
    """

    name: ClassVar[str] = "?"

    # -- hooks -----------------------------------------------------------
    def victim_filter(self, state: MemoryState, app: str, now: float, *,
                      delta: float, history: float) -> List[str]:
        raise NotImplementedError

    def plan_procure(self, state: MemoryState, app: str, now: float, *,
                     delta: float, history: float) -> ProcurePlan:
        raise NotImplementedError

    def plan_prefetch(self, state: MemoryState, app: str, now: float, *,
                      delta: float, history: float
                      ) -> Optional[ProcurePlan]:
        """Eviction-free proactive plan for the background loader: the
        largest variant whose *marginal* footprint fits in surplus
        memory.  A prefetch is speculation — it must never destabilize
        residents or out-claim real work, so the default refuses plans
        that need evictions (under pressure the demand path, which can
        reclaim a cancelled prefetch's memory, takes over)."""
        t = state.tenants[app]
        if t.loaded is t.zoo.largest or t.inflight_mb > 0.0:
            return None
        cur = t.loaded.size_mb if t.loaded else 0.0
        for v in t.zoo.variants:  # largest first
            if t.loaded is not None and v.size_mb <= cur:
                break  # downgrades are admission-time decisions
            if v.size_mb - cur <= state.free_mb:
                return ProcurePlan(app, v, ())
        return None

    def demand_charge(self, demand: DemandContext) -> float:
        """How much cache need a demand load plans around.  The base
        protocol charges the head batch as it is queued right now."""
        return demand.kv_head_mb

    def plan_demand(self, state: MemoryState, app: str, now: float,
                    demand: DemandContext, *, delta: float,
                    history: float) -> Optional[ProcurePlan]:
        """Plan a load for a *cold* tenant with requests already queued.
        The cache need is staged as a transient planning charge so the
        chosen variant leaves room for it up front (one weight transfer,
        no load-then-downgrade thrash at admission).  Returns None when
        no variant is fundable; the manager's fallback takes over."""
        with state.pending(self.demand_charge(demand)):
            plan = self.plan_procure(state, app, now, delta=delta,
                                     history=history)
        return plan if plan.ok else None

    def plan_headroom(self, state: MemoryState, app: str, now: float,
                      need_mb: float, *, delta: float,
                      history: float) -> Tuple[Eviction, ...]:
        return kv_headroom_plan(state, app, now, need_mb, delta=delta,
                                history=history)


PolicyLike = Union[str, Policy, type]

_REGISTRY: Dict[str, Callable[[], Policy]] = {}


def register_policy(name: str) -> Callable:
    """Register a :class:`Policy` factory (usually the class itself) under
    ``name`` so configs can resolve it declaratively."""
    def deco(factory):
        if isinstance(factory, type):
            factory.name = name
        _REGISTRY[name] = factory
        return factory
    return deco


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_policy(spec: PolicyLike) -> Policy:
    """Resolve a registry name, a Policy class, or a ready instance to a
    Policy instance.  Unknown names fail loudly with the available set."""
    if isinstance(spec, Policy):
        return spec
    if isinstance(spec, type) and issubclass(spec, Policy):
        return spec()
    if isinstance(spec, str):
        if spec not in _REGISTRY:
            raise KeyError(
                f"unknown policy {spec!r}; registered policies: "
                f"{', '.join(available_policies())}")
        return _REGISTRY[spec]()
    raise TypeError(f"cannot resolve a Policy from {spec!r}")


# ---------------------------------------------------------------------------
# Policy 1: Largest-First Eviction
# ---------------------------------------------------------------------------
@register_policy("lfe")
class LFE(Policy):
    def victim_filter(self, state: MemoryState, app: str, now: float, *,
                      delta: float, history: float) -> List[str]:
        victims = [a for a in state.minimalist_set(now, delta)
                   if a != app and state.tenants[a].loaded is not None
                   and state.tenants[a].inflight_mb == 0.0]
        victims.sort(key=lambda a: -state.tenants[a].loaded.size_mb)
        return victims

    def plan_procure(self, state: MemoryState, app: str, now: float, *,
                     delta: float, history: float) -> ProcurePlan:
        victims = self.victim_filter(state, app, now, delta=delta,
                                     history=history)
        for variant in state.tenants[app].zoo.variants:
            evictions: List[Eviction] = []
            for v in victims:
                if _free_after(state, app, evictions) >= variant.size_mb:
                    break
                evictions.append(Eviction(v, state.tenants[v].loaded, None))
            if _free_after(state, app, evictions) >= variant.size_mb:
                return ProcurePlan(app, variant, tuple(evictions))
        return ProcurePlan(app, None)


# ---------------------------------------------------------------------------
# Policy 2: Best-Fit Eviction
# ---------------------------------------------------------------------------
@register_policy("bfe")
class BFE(Policy):
    def victim_filter(self, state: MemoryState, app: str, now: float, *,
                      delta: float, history: float) -> List[str]:
        return [a for a in state.minimalist_set(now, delta)
                if a != app and state.tenants[a].loaded is not None
                and state.tenants[a].inflight_mb == 0.0]

    @staticmethod
    def _variant_plan(state: MemoryState, app: str,
                      variant: ModelVariant,
                      victims: List[str]) -> Optional[ProcurePlan]:
        """Best-fit eviction set funding one candidate variant: evict the
        victim whose loaded size is closest from above to the remaining
        need (largest-below when none covers), or None when even the
        whole victim pool cannot fund it."""
        evictions: List[Eviction] = []
        remaining = list(victims)
        while (_free_after(state, app, evictions) < variant.size_mb
               and remaining):
            need = variant.size_mb - _free_after(state, app, evictions)
            covering = [a for a in remaining
                        if state.tenants[a].loaded.size_mb >= need]
            if covering:
                pick = min(covering,
                           key=lambda a: state.tenants[a].loaded.size_mb)
            else:
                pick = max(remaining,
                           key=lambda a: state.tenants[a].loaded.size_mb)
            remaining.remove(pick)
            evictions.append(
                Eviction(pick, state.tenants[pick].loaded, None))
        if _free_after(state, app, evictions) >= variant.size_mb:
            return ProcurePlan(app, variant, tuple(evictions))
        return None

    def plan_procure(self, state: MemoryState, app: str, now: float, *,
                     delta: float, history: float) -> ProcurePlan:
        victims = self.victim_filter(state, app, now, delta=delta,
                                     history=history)
        for variant in state.tenants[app].zoo.variants:
            plan = self._variant_plan(state, app, variant, victims)
            if plan is not None:
                return plan
        return ProcurePlan(app, None)


# ---------------------------------------------------------------------------
# Policy 3: Warm-Start-aware Best-Fit Eviction
# ---------------------------------------------------------------------------
@register_policy("ws-bfe")
class WSBFE(Policy):
    def victim_filter(self, state: MemoryState, app: str, now: float, *,
                      delta: float, history: float) -> List[str]:
        # Window-overlap exemption only: WS-BFE has no LRU-K filter.
        return _downgrade_candidates(state, app, now, delta)

    def plan_procure(self, state: MemoryState, app: str, now: float, *,
                     delta: float, history: float) -> ProcurePlan:
        cands = self.victim_filter(state, app, now, delta=delta,
                                   history=history)
        for variant in state.tenants[app].zoo.variants:
            evictions = _scavenge_best_fit(
                state, cands,
                lambda evs: variant.size_mb - _free_after(state, app, evs))
            if _free_after(state, app, evictions) >= variant.size_mb:
                return ProcurePlan(app, variant, tuple(evictions))
            # §III-B-1 "high inference demand" fallback: fully unload the
            # already-downgraded victims (this is what separates WS-BFE
            # from iWS-BFE, which per Algorithm 1 only ever *replaces* —
            # WS-BFE's unloads are the cold-starts Fig 5 charges it with).
            evictions = [Eviction(e.app, e.old, None) for e in evictions]
            if _free_after(state, app, evictions) >= variant.size_mb:
                return ProcurePlan(app, variant, tuple(evictions))
        return ProcurePlan(app, None)


# ---------------------------------------------------------------------------
# Policy 4: Intelligent Warm-Start-aware Best-Fit Eviction (Algorithm 1)
# ---------------------------------------------------------------------------
@register_policy("iws-bfe")
class IWSBFE(Policy):
    def victim_filter(self, state: MemoryState, app: str, now: float, *,
                      delta: float, history: float) -> List[str]:
        # Steps 2–3: τ = A′ not requested during H; E = τ non-overlapping
        # with the requester's window.
        return _downgrade_candidates(state, app, now, delta,
                                     require_history=history)

    def plan_procure(self, state: MemoryState, app: str, now: float, *,
                     delta: float, history: float) -> ProcurePlan:
        cands = self.victim_filter(state, app, now, delta=delta,
                                   history=history)
        if cands:
            # Step 4: fitness score (Eq. 3).
            dists = {}
            for a in cands:
                tj = state.tenants[a].predicted_next
                dists[a] = (tj - now) if tj is not INF else INF
            finite = [d for d in dists.values() if d is not INF and d > 0]
            dmax = max(finite) if finite else 1.0
            scores = {}
            for a in cands:
                d = dists[a]
                norm = 1.0 if d is INF else max(d, 0.0) / max(dmax, 1e-9)
                scores[a] = norm * (1.0 - state.p_unexpected(a))
            # Step 5: max-heap on fitness.
            heap = [(-scores[a], a) for a in cands]
            heapq.heapify(heap)
        else:
            heap = []

        for variant in state.tenants[app].zoo.variants:
            evictions: List[Eviction] = []
            h = list(heap)  # fresh heap per variant attempt (Steps 6–18)
            while _free_after(state, app, evictions) < variant.size_mb and h:
                _, w = heapq.heappop(h)  # Step 7: extract max-fitness root
                t = state.tenants[w]
                # Step 9: scavenge by replacing with the lowest-precision
                # model.
                evictions.append(Eviction(w, t.loaded, t.zoo.smallest))
            if _free_after(state, app, evictions) >= variant.size_mb:
                # Steps 12–14: enact replacements, load m_i.
                return ProcurePlan(app, variant, tuple(evictions))
            # Step 17–18: retry with next smaller model.
        return ProcurePlan(app, None)  # Step 17: inference request fails


# ---------------------------------------------------------------------------
# Plugin: batch-aware procurement (wraps any registered policy)
# ---------------------------------------------------------------------------
class BatchAware(Policy):
    """Batch-aware demand procurement: plan a cold tenant's load for the
    batch the queue will produce *at admission time*, not the head-batch
    snapshot at stage time.

    Under a burst, requests keep arriving while the weight transfer
    stages; head-batch planning sizes the variant beside the cache of
    whatever was queued when staging began, and the (now larger) batch
    that actually admits forces a self-downgrade right after the load
    commits — the exact load-then-downgrade thrash KV-aware procurement
    exists to avoid, reintroduced by queue dynamics.  Planning against
    ``DemandContext.kv_full_mb`` (a full ``max_batch``-wide batch at the
    queued shapes) picks the smaller variant up front: one transfer, no
    wasted large-variant load.

    Every other hook delegates to the wrapped policy, so this composes
    with any registered eviction strategy (``batch-bfe``,
    ``batch-iws-bfe``, or ``BatchAware(MyPolicy())``).
    """

    def __init__(self, inner: PolicyLike = "bfe"):
        self.inner = resolve_policy(inner)
        self.name = f"batch-{self.inner.name}"

    def victim_filter(self, state, app, now, *, delta, history):
        return self.inner.victim_filter(state, app, now, delta=delta,
                                        history=history)

    def plan_procure(self, state, app, now, *, delta, history):
        return self.inner.plan_procure(state, app, now, delta=delta,
                                       history=history)

    def plan_prefetch(self, state, app, now, *, delta, history):
        return self.inner.plan_prefetch(state, app, now, delta=delta,
                                        history=history)

    def plan_headroom(self, state, app, now, need_mb, *, delta, history):
        return self.inner.plan_headroom(state, app, now, need_mb,
                                        delta=delta, history=history)

    def demand_charge(self, demand: DemandContext) -> float:
        return max(demand.kv_head_mb, demand.kv_full_mb)


@register_policy("batch-bfe")
def _batch_bfe() -> Policy:
    return BatchAware("bfe")


@register_policy("batch-iws-bfe")
def _batch_iws_bfe() -> Policy:
    return BatchAware("iws-bfe")


# ---------------------------------------------------------------------------
# Plugin: cost-aware procurement over simulated plan candidates
# ---------------------------------------------------------------------------
@register_policy("cost-bfe")
class CostBFE(BFE):
    """Cost-aware BFE: rank candidate plans by what the variant is
    *worth by the time it is ready*, not just by size.

    BFE always procures the largest fundable variant — even when the
    requester's next predicted request lands mid-transfer, so the big
    load cannot finish in time and a smaller variant would have served
    warmer for free.  This plugin enumerates one candidate plan per zoo
    variant (the same best-fit eviction machinery), validates each with
    ``MemoryState.simulate`` — plans are cheap, frozen data — and scores

        score(v) = accuracy(v) · min(1, idle_ms / load_ms(v))

    where ``idle_ms`` is the gap to the tenant's next predicted request
    (∞ when unpredicted, which makes the score pure accuracy and the
    choice identical to BFE).  The highest-scoring feasible plan wins;
    ties keep the larger variant.  First post-IR payoff: a policy is
    now a pure plan-emitting function ranked by simulate, no enactment
    logic anywhere."""

    def plan_procure(self, state: MemoryState, app: str, now: float, *,
                     delta: float, history: float) -> ProcurePlan:
        victims = self.victim_filter(state, app, now, delta=delta,
                                     history=history)
        t = state.tenants[app]
        pred = t.predicted_next
        idle = INF if pred is INF else (pred - now)
        best: Optional[ProcurePlan] = None
        best_score = -INF
        for variant in t.zoo.variants:  # largest first
            plan = self._variant_plan(state, app, variant, victims)
            if plan is None:
                continue
            rplan = A.ResidencyPlan(
                A.eviction_actions(plan.evictions)
                + (A.staged_load_action(state, app, variant),))
            if state.simulate(rplan) is not None:
                # Not actually fundable as a transfer — e.g. a shard
                # over its chip's budget, which the device-blind
                # eviction math above cannot see.
                continue
            score = variant_score(variant, idle)
            if score > best_score + 1e-12:
                best, best_score = plan, score
        return best if best is not None else ProcurePlan(app, None)


# ---------------------------------------------------------------------------
# KV-cache headroom (serving runtime): scavenge weight memory for caches
# ---------------------------------------------------------------------------
def kv_headroom_plan(state: MemoryState, app: str, now: float,
                     need_mb: float, *, delta: float,
                     history: float = 0.0) -> Tuple[Eviction, ...]:
    """Free ≥ ``need_mb`` of headroom for ``app``'s KV cache by downgrading
    minimalist victims to their smallest variant (same candidate filters as
    iWS-BFE: window-overlap and LRU-K history exempt), best-fit first.

    If downgrades alone cannot cover the need, victims are *unloaded*
    outright — the same "high inference demand" fallback WS-BFE applies
    to weight pressure (§III-B-1), extended to cache pressure: a decode
    cache that cannot fit is a failed inference, which the paper weighs
    strictly worse than a future cold start.  Already-downgraded victims
    go first (their remaining footprint is minimal), then other
    minimalist tenants sitting at their smallest variant, best-fit.

    Unlike the procure policies this never touches the requester's own
    variant — the caller decides whether to self-downgrade if scavenging
    victims is not enough.  The returned evictions may be insufficient;
    the caller re-checks ``free_mb`` after enacting.
    """
    def short(evs: List[Eviction]) -> float:
        return need_mb - state.free_mb - sum(e.freed_mb for e in evs)

    cands = _downgrade_candidates(state, app, now, delta,
                                  require_history=history)
    evictions = list(_scavenge_best_fit(state, cands, short))
    if short(evictions) <= 0:
        return tuple(evictions)
    # Cache-pressure fallback: downgrades were not enough — unload.
    evictions = [Eviction(e.app, e.old, None) for e in evictions]
    taken = {e.app for e in evictions}
    pool = [a for a in _downgrade_candidates(state, app, now, delta,
                                             require_history=history,
                                             include_smallest=True)
            if a not in taken]
    while (need := short(evictions)) > 0 and pool:
        def loaded_mb(a: str) -> float:
            return state.tenants[a].loaded.size_mb
        covering = [a for a in pool if loaded_mb(a) >= need]
        pick = (min(covering, key=loaded_mb) if covering
                else max(pool, key=loaded_mb))
        pool.remove(pick)
        evictions.append(Eviction(pick, state.tenants[pick].loaded, None))
    return tuple(evictions)


def kv_desperation_plan(state: MemoryState, app: str,
                        need_mb: float) -> Tuple[Eviction, ...]:
    """Last resort before rejecting a batch for cache pressure: ignore
    the window-overlap and LRU-K protections and scavenge every other
    tenant — downgrades first (cheapest robustness loss, biggest
    scavengeable first), then outright unloads.  A failed inference
    outranks every warm-start heuristic in the paper's cost model, and
    without this pass a predicting engine is *more* rejection-prone than
    a reactive one (predictions create windows, windows protect victims).
    Tenants mid-staging stay exempt — the loader owns their residency.
    """
    def short(evs: List[Eviction]) -> float:
        return need_mb - state.free_mb - sum(e.freed_mb for e in evs)

    cands = [a for a, t in state.tenants.items()
             if a != app and t.loaded is not None and t.inflight_mb == 0.0]

    def scavengeable(a: str) -> float:
        t = state.tenants[a]
        return t.loaded.size_mb - t.zoo.smallest.size_mb

    evictions: List[Eviction] = []
    for a in sorted(cands, key=scavengeable, reverse=True):
        if short(evictions) <= 0:
            break
        t = state.tenants[a]
        if t.loaded is not t.zoo.smallest:
            evictions.append(Eviction(a, t.loaded, t.zoo.smallest))
    if short(evictions) > 0:
        taken = {e.app for e in evictions}
        evictions = [Eviction(e.app, e.old, None) for e in evictions]
        rest = [a for a in cands if a not in taken]
        for a in sorted(rest, key=lambda a: state.tenants[a].loaded.size_mb,
                        reverse=True):
            if short(evictions) <= 0:
                break
            evictions.append(
                Eviction(a, state.tenants[a].loaded, None))
    return tuple(evictions)


def kv_page_victim_plan(state: MemoryState, app: str, *,
                        need_mb: float, need_pages: int,
                        extra_free_mb: float = 0.0
                        ) -> Tuple["A.EvictKV", ...]:
    """Cold-KV-pages as a victim class: free *other* tenants' sequences'
    pages until ``app``'s charge is fundable — both in MB (the global
    budget) and in pages (the pool's free lists).  Victims are whole
    sequences, youngest allocation first: the sequence with the least
    decode progress loses the least work when the engine requeues it.

    ``extra_free_mb`` is headroom the caller's *same plan* will free
    before these evictions apply (weight downgrades/unloads), so the two
    victim classes compose into one atomic
    :class:`~repro_torch.core.actions.ResidencyPlan`.  Returns ``()`` when the
    pool cannot cover the shortfall — preempting sequences that still
    would not admit the requester is pure thrash.
    """
    pool = state.kv_pool
    if pool is None:
        return ()
    acts: List[A.EvictKV] = []
    freed_pages = 0

    def covered() -> bool:
        free_mb = (state.free_mb + extra_free_mb
                   + freed_pages * pool.page_mb)
        free_pages = pool.free_pages + freed_pages
        return free_mb >= need_mb - 1e-9 and free_pages >= need_pages

    for vapp, seq, pages in pool.victim_seqs(exclude=app):
        if covered():
            break
        acts.append(A.EvictKV(vapp, pages * pool.page_mb, seq=seq))
        freed_pages += pages
    if not covered():
        return ()
    return tuple(acts)


# ---------------------------------------------------------------------------
# Composable fallback: what backstops a policy when its plan is unfundable
# ---------------------------------------------------------------------------
class FallbackPolicy:
    """Protocol for the manager's last-resort eviction source: when the
    configured :class:`Policy` cannot fund a plan (weights or cache), the
    manager asks the fallback for evictions and enacts them.  ``None``
    disables the backstop entirely — failures then surface as counted
    rejections, the pure paper behaviour."""

    name: ClassVar[str] = "?"

    def plan(self, state: MemoryState, app: str,
             need_mb: float) -> Tuple[Eviction, ...]:
        raise NotImplementedError


class DesperationFallback(FallbackPolicy):
    """The serving runtime's default backstop (previously a manager
    special case): window/history protections yield before an inference
    fails — see :func:`kv_desperation_plan` for the full rationale."""

    name = "desperation"

    def plan(self, state: MemoryState, app: str,
             need_mb: float) -> Tuple[Eviction, ...]:
        return kv_desperation_plan(state, app, need_mb)


def resolve_fallback(spec: Union[str, FallbackPolicy, None]
                     ) -> Optional[FallbackPolicy]:
    if spec is None or isinstance(spec, FallbackPolicy):
        return spec
    if spec == "desperation":
        return DesperationFallback()
    if spec == "none":
        return None
    raise KeyError(f"unknown fallback policy {spec!r}; "
                   f"expected 'desperation', 'none', or a FallbackPolicy")
