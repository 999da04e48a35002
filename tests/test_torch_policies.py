"""The port's counterpart of ``tests/test_policies.py`` (the reference's
cases on ``repro_torch``, real tenants on the CPU):

Unit + property tests for the four eviction policies (paper §III-B).

The property section uses ``hypothesis`` when available; without it the
same invariant checkers run over seeded-numpy random states so the module
always collects and the invariants stay guarded.
"""

import numpy as np
import torch
import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # degrade to the seeded-numpy fallback below
    HAVE_HYPOTHESIS = False

from repro_torch.core.memory_state import INF, MemoryState, TenantState
from repro_torch.core.model_zoo import ModelVariant, ModelZoo
from repro_torch.core.policies import kv_headroom_plan, resolve_policy

# The four paper policies (§III-B), resolved through the registry.  Local
# function aliases keep the test bodies reading like the paper's
# pseudocode while exercising the class-based Policy protocol.
PAPER_POLICIES = ("lfe", "bfe", "ws-bfe", "iws-bfe")


def _procure(name):
    def call(state, app, now, *, delta, history=0.0):
        return resolve_policy(name).plan_procure(
            state, app, now, delta=delta, history=history)
    return call


lfe = _procure("lfe")
bfe = _procure("bfe")
ws_bfe = _procure("ws-bfe")
iws_bfe = _procure("iws-bfe")


def zoo(name, sizes, accs=None):
    accs = accs or [90 - 10 * i for i in range(len(sizes))]
    return ModelZoo(
        app_name=name,
        variants=tuple(
            ModelVariant(f"{name}-{i}", bits=32 >> i, size_mb=s,
                         accuracy=a, load_ms=s * 2)
            for i, (s, a) in enumerate(zip(sizes, accs))))


def make_state(budget=1000.0):
    """Three tenants: a (500/300/100), b (400/200/50), c (300/100/30)."""
    st_ = MemoryState(budget_mb=budget, tenants={
        "a": TenantState(zoo=zoo("a", [500, 300, 100])),
        "b": TenantState(zoo=zoo("b", [400, 200, 50])),
        "c": TenantState(zoo=zoo("c", [300, 100, 30])),
    })
    return st_


def apply_plan(state, plan):
    for ev in plan.evictions:
        state.load(ev.app, ev.new)
    state.load(plan.app, plan.variant)


class TestLFE:
    def test_loads_largest_when_memory_free(self):
        s = make_state()
        plan = lfe(s, "a", now=0.0, delta=10.0)
        assert plan.ok and plan.variant.size_mb == 500
        assert plan.evictions == ()

    def test_evicts_largest_first(self):
        s = make_state(budget=900.0)
        s.load("b", s.tenants["b"].zoo.largest)  # 400
        s.load("c", s.tenants["c"].zoo.largest)  # 300
        # b and c are minimalist (no predictions); a requests 500.
        plan = lfe(s, "a", now=0.0, delta=10.0)
        assert plan.ok and plan.variant.size_mb == 500
        assert plan.evictions[0].app == "b"  # largest loaded model first
        assert all(e.new is None for e in plan.evictions)  # full unloads

    def test_downgrades_requester_when_eviction_insufficient(self):
        s = make_state(budget=220.0)
        # nothing loaded; 500 and 300 don't fit; 100 does
        plan = lfe(s, "a", now=0.0, delta=10.0)
        assert plan.ok and plan.variant.size_mb == 100

    def test_fails_when_nothing_fits(self):
        s = make_state(budget=20.0)
        plan = lfe(s, "a", now=0.0, delta=10.0)
        assert not plan.ok


class TestBFE:
    def test_best_fit_prefers_smallest_covering(self):
        s = make_state(budget=1000.0)
        s.load("b", s.tenants["b"].zoo.largest)  # 400
        s.load("c", s.tenants["c"].zoo.largest)  # 300
        # free = 300; a wants 500 -> needs 200 more; c(300) covers with
        # less waste than b(400)
        plan = bfe(s, "a", now=0.0, delta=10.0)
        assert plan.ok
        assert plan.evictions[0].app == "c"


class TestWSBFE:
    def test_downgrade_not_unload(self):
        s = make_state(budget=800.0)
        s.load("b", s.tenants["b"].zoo.largest)  # 400
        s.load("c", s.tenants["c"].zoo.largest)  # 300
        plan = ws_bfe(s, "a", now=0.0, delta=10.0)
        assert plan.ok
        for ev in plan.evictions:
            assert ev.new is not None
            assert ev.new is s.tenants[ev.app].zoo.smallest

    def test_skips_overlapping_windows(self):
        s = make_state(budget=800.0)
        s.load("b", s.tenants["b"].zoo.largest)
        s.load("c", s.tenants["c"].zoo.largest)
        # b's predicted window overlaps the requester's current time
        s.tenants["b"].predicted_next = 5.0
        s.tenants["a"].predicted_next = 5.0
        plan = ws_bfe(s, "a", now=0.0, delta=100.0)
        assert all(ev.app != "b" for ev in plan.evictions)


class TestIWSBFE:
    def test_history_filter(self):
        s = make_state(budget=800.0)
        s.load("b", s.tenants["b"].zoo.largest)
        s.load("c", s.tenants["c"].zoo.largest)
        s.tenants["b"].last_request = -1.0  # requested just now
        plan = iws_bfe(s, "a", now=0.0, delta=10.0, history=100.0)
        assert all(ev.app != "b" for ev in plan.evictions)

    def test_prefers_far_future_victims(self):
        s = make_state(budget=730.0)
        s.load("b", s.tenants["b"].zoo.by_bits(16))  # 200
        s.load("c", s.tenants["c"].zoo.by_bits(16))  # 100
        s.tenants["b"].predicted_next = 10_000.0  # far future
        s.tenants["c"].predicted_next = INF
        s.tenants["b"].last_request = -10_000.0
        s.tenants["c"].last_request = -10_000.0
        # free = 430; a wants 500: scavenging either victim's downgrade
        # suffices (b frees 150, c frees 70 -> only b's suffices); the
        # heap should try the highest-score (c: no prediction => norm 1)
        # first but keep popping until covered.
        plan = iws_bfe(s, "a", now=0.0, delta=10.0, history=100.0)
        assert plan.ok and plan.variant.size_mb == 500

    def test_algorithm1_failure_path(self):
        s = make_state(budget=25.0)
        plan = iws_bfe(s, "a", now=0.0, delta=10.0, history=100.0)
        assert not plan.ok  # Step 17: request fails


class TestKVHeadroom:
    def test_scavenges_victims_not_requester(self):
        s = make_state(budget=800.0)
        s.load("a", s.tenants["a"].zoo.smallest)  # 100
        s.load("b", s.tenants["b"].zoo.largest)   # 400
        s.load("c", s.tenants["c"].zoo.largest)   # 300
        # free = 0; a needs 200MB of KV headroom
        evs = kv_headroom_plan(s, "a", now=0.0, need_mb=200.0, delta=10.0)
        assert evs, "must scavenge"
        assert all(ev.app != "a" for ev in evs)
        assert all(ev.new is s.tenants[ev.app].zoo.smallest for ev in evs)
        assert s.free_mb + sum(ev.freed_mb for ev in evs) >= 200.0

    def test_best_fit_prefers_smallest_sufficient(self):
        s = make_state(budget=700.0)
        s.load("b", s.tenants["b"].zoo.largest)  # 400, scavenge 350
        s.load("c", s.tenants["c"].zoo.largest)  # 300, scavenge 270
        # free = 0; need 100 — c's 270 covers with less waste than b's 350
        evs = kv_headroom_plan(s, "a", now=0.0, need_mb=100.0, delta=10.0)
        assert [ev.app for ev in evs] == ["c"]

    def test_may_be_insufficient(self):
        s = make_state(budget=430.0)
        s.load("b", s.tenants["b"].zoo.largest)  # 400
        evs = kv_headroom_plan(s, "a", now=0.0, need_mb=1000.0, delta=10.0)
        # caller re-checks free_mb: all scavengeable freed, still short
        assert s.free_mb + sum(ev.freed_mb for ev in evs) < 1000.0

    def test_respects_window_and_history_filters(self):
        s = make_state(budget=800.0)
        s.load("b", s.tenants["b"].zoo.largest)
        s.load("c", s.tenants["c"].zoo.largest)
        s.tenants["b"].predicted_next = 5.0
        s.tenants["a"].predicted_next = 5.0  # b overlaps the requester
        s.tenants["c"].last_request = -1.0   # c requested just now
        evs = kv_headroom_plan(s, "a", now=0.0, need_mb=500.0,
                               delta=100.0, history=50.0)
        assert evs == ()

    def test_kv_charge_shrinks_policy_view(self):
        """Policies see free memory net of live KV caches."""
        s = make_state(budget=600.0)
        plan = lfe(s, "a", now=0.0, delta=10.0)
        assert plan.ok and plan.variant.size_mb == 500
        s.reserve_kv("b", 250.0)
        plan = lfe(s, "a", now=0.0, delta=10.0)
        assert plan.ok and plan.variant.size_mb == 300  # 500 no longer fits


# ---------------------------------------------------------------------------
# Random-state invariants: hypothesis properties when available, seeded
# numpy fallback otherwise (same checkers either way).
# ---------------------------------------------------------------------------
def _repair_overcommit(s: MemoryState) -> MemoryState:
    """Repair overcommitted starting states (simulate prior valid history)."""
    while s.used_mb > s.budget_mb:
        loaded = [a for a, t in s.tenants.items() if t.loaded is not None]
        if loaded:
            s.tenants[loaded[0]].loaded = None
        else:
            for t in s.tenants.values():
                t.kv_mb = 0.0
    return s


def _check_policy_invariants(state, policy_name, now, delta, history):
    app = sorted(state.tenants)[0]
    plan = resolve_policy(policy_name).plan_procure(
        state, app, now, delta=delta, history=history)
    if not plan.ok:
        return
    minimalist = set(state.minimalist_set(now, delta))
    for ev in plan.evictions:
        assert ev.app != app, "policy evicted the requester"
        assert ev.app in minimalist, "evicted a maximalist tenant"
        assert state.tenants[ev.app].loaded is not None
        if policy_name == "iws-bfe":
            assert ev.new is state.tenants[ev.app].zoo.smallest
            assert state.tenants[ev.app].last_request <= now - history
    # Enacting the plan must respect the memory budget (the invariant).
    apply_plan(state, plan)  # raises AssertionError on violation
    assert state.loaded_variant(app) is plan.variant


def _check_iws_maximality(state, now, delta):
    """If iWS-BFE picks a non-largest variant, the largest must not fit
    even after downgrading every eligible candidate."""
    from repro_torch.core.policies import _downgrade_candidates, _free_after, \
        Eviction

    app = sorted(state.tenants)[0]
    plan = iws_bfe(state, app, now, delta=delta, history=100.0)
    if not plan.ok:
        return
    largest = state.tenants[app].zoo.largest
    if plan.variant is largest:
        return
    cands = _downgrade_candidates(state, app, now, delta,
                                  require_history=100.0)
    evs = [Eviction(a, state.tenants[a].loaded,
                    state.tenants[a].zoo.smallest) for a in cands]
    assert _free_after(state, app, evs) < largest.size_mb


def _random_state_np(rng: np.random.Generator) -> MemoryState:
    """Seeded-numpy mirror of the hypothesis ``random_state`` strategy."""
    n_apps = int(rng.integers(2, 7))
    budget = float(rng.uniform(50, 3000))
    tenants = {}
    for i in range(n_apps):
        n_var = int(rng.integers(1, 5))
        sizes = sorted(rng.uniform(1, 600, n_var), reverse=True)
        sizes = [float(s) + (n_var - j) for j, s in enumerate(sizes)]
        t = TenantState(zoo=zoo(f"app{i}", sizes))
        if rng.random() < 0.5:
            t.predicted_next = float(rng.uniform(0, 1000))
        if rng.random() < 0.5:
            t.loaded = t.zoo.variants[int(rng.integers(0, n_var))]
        if rng.random() < 0.3:
            t.kv_mb = float(rng.uniform(0, 100))
        t.last_request = float(rng.uniform(-1000, 0))
        t.requests = int(rng.integers(0, 51))
        t.unexpected = int(rng.integers(0, t.requests + 1))
        tenants[f"app{i}"] = t
    return _repair_overcommit(MemoryState(budget_mb=budget, tenants=tenants))


if HAVE_HYPOTHESIS:
    @st.composite
    def random_state(draw):
        n_apps = draw(st.integers(2, 6))
        budget = draw(st.floats(50, 3000))
        tenants = {}
        for i in range(n_apps):
            n_var = draw(st.integers(1, 4))
            sizes = sorted(
                draw(st.lists(st.floats(1, 600), min_size=n_var,
                              max_size=n_var)), reverse=True)
            # strictly decreasing to keep variants distinct
            sizes = [s + (n_var - j) for j, s in enumerate(sizes)]
            t = TenantState(zoo=zoo(f"app{i}", sizes))
            if draw(st.booleans()):
                t.predicted_next = draw(st.floats(0, 1000))
            if draw(st.booleans()):
                idx = draw(st.integers(0, n_var - 1))
                t.loaded = t.zoo.variants[idx]
            if draw(st.booleans()):
                t.kv_mb = draw(st.floats(0, 100))
            t.last_request = draw(st.floats(-1000, 0))
            t.requests = draw(st.integers(0, 50))
            t.unexpected = draw(st.integers(0, t.requests))
            tenants[f"app{i}"] = t
        return _repair_overcommit(
            MemoryState(budget_mb=budget, tenants=tenants))

    @settings(max_examples=200, deadline=None)
    @given(random_state(), st.sampled_from(PAPER_POLICIES),
           st.floats(0, 500), st.floats(1, 200), st.floats(1, 500))
    def test_policy_invariants(state, policy_name, now, delta, history):
        _check_policy_invariants(state, policy_name, now, delta, history)

    @settings(max_examples=100, deadline=None)
    @given(random_state(), st.floats(0, 500), st.floats(1, 200))
    def test_iws_maximality(state, now, delta):
        _check_iws_maximality(state, now, delta)


@pytest.mark.parametrize("seed", range(80))
def test_policy_invariants_seeded(seed):
    rng = np.random.default_rng(seed)
    state = _random_state_np(rng)
    policy_name = PAPER_POLICIES[int(rng.integers(0, len(PAPER_POLICIES)))]
    _check_policy_invariants(
        state, policy_name, now=float(rng.uniform(0, 500)),
        delta=float(rng.uniform(1, 200)),
        history=float(rng.uniform(1, 500)))


@pytest.mark.parametrize("seed", range(40))
def test_iws_maximality_seeded(seed):
    rng = np.random.default_rng(1000 + seed)
    state = _random_state_np(rng)
    _check_iws_maximality(state, now=float(rng.uniform(0, 500)),
                          delta=float(rng.uniform(1, 200)))
