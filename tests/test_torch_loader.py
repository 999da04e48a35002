"""The port's counterpart of ``tests/test_loader.py`` (the reference's
cases on ``repro_torch``, real tenants on the CPU):

Background model-loading pipeline tests: in-flight memory charges,
prefetch commit/cancel lifecycle, predictor-driven warm hits in the
engine, and the per-event budget invariant with loads in flight.

Synthetic-zoo tests drive the manager + loader directly (no models, the
no-op stage function); engine tests use real reduced configs with the
stub executor, as in tests/test_engine.py.
"""
import numpy as np
import torch
import pytest


from repro_torch.configs import get_config
from repro_torch.core import EdgeMultiAI
from repro_torch.core.model_zoo import ModelVariant, ModelZoo
from repro_torch.core.policies import resolve_policy
from repro_torch.core.predictor import SeriesPredictor
from repro_torch.models import transformer as T
from repro_torch.serving import (BackgroundLoader, EdgeServer, Request,
                           poisson_trace)

TENANTS = ["tinyllama-1.1b", "mamba2-780m"]


def _zoo(name, sizes):
    return ModelZoo(app_name=name, variants=tuple(
        ModelVariant(f"{name}-{i}", bits=32 >> i, size_mb=s,
                     accuracy=90.0 - 10 * i, load_ms=s * 2)
        for i, s in enumerate(sizes)))


def make_manager(budget_mb=1000.0, **zoos):
    zoos = zoos or {"a": _zoo("a", [500, 300]), "b": _zoo("b", [400, 200])}
    return EdgeMultiAI(zoos, budget_mb=budget_mb, policy="iws-bfe",
                       delta_ms=10.0)


def stub_executor(runtime, batch, extra=None):
    return np.zeros((len(batch.requests), batch.max_new), np.int32)


def make_server(budget_mb=1e9, **kw):
    srv = EdgeServer(budget_mb=budget_mb, policy="iws-bfe",
                     delta_ms=1000.0, **kw, device="cpu")
    for name in TENANTS:
        cfg = get_config(name, reduced=True)
        srv.register(name, cfg, T.init_params(
            cfg, hash(name) % 2 ** 31, torch.float32, device="cpu"))
    return srv


# ---------------------------------------------------------------------------
# In-flight charge lifecycle (manager + loader, no models)
# ---------------------------------------------------------------------------
def test_enqueue_charges_inflight_and_commit_releases():
    mgr = make_manager()
    loader = BackgroundLoader(mgr)
    plan = mgr.plan_demand("a", now=0.0)
    ld = loader.enqueue(plan, now_ms=0.0, demand=True)
    assert ld is not None and ld.charge_mb == 500.0
    st = mgr.state
    assert st.tenants["a"].inflight_mb == 500.0
    assert st.inflight_mb == 500.0
    assert st.free_mb == pytest.approx(500.0), "charge claims the pool"
    assert st.tenants["a"].loaded is None, "not committed yet"
    assert loader.reap(ld.ready_ms - 1.0) == []
    recs = loader.reap(ld.ready_ms)
    assert [r.app for r in recs] == ["a"]
    assert st.tenants["a"].loaded.size_mb == 500.0
    assert st.inflight_mb == 0.0, "commit converts the claim to weights"
    assert st.free_mb == pytest.approx(500.0)
    loader.close()


def test_procurement_cannot_double_book_inflight_memory():
    """While a's 500MB prefetch is staging, b's procurement must not
    plan into that memory."""
    mgr = make_manager(budget_mb=800.0)
    loader = BackgroundLoader(mgr)
    loader.enqueue(mgr.plan_demand("a", now=0.0), now_ms=0.0)
    assert mgr.state.free_mb == pytest.approx(300.0)
    plan = resolve_policy("iws-bfe").plan_procure(
        mgr.state, "b", 0.0, delta=10.0, history=10.0)
    assert plan.ok
    assert plan.variant.size_mb <= 300.0, \
        "policy sized b's variant inside the remaining free pool"
    # And the mid-staging tenant is never a victim.
    assert all(ev.app != "a" for ev in plan.evictions)
    loader.close()


def test_wrong_prediction_cancel_releases_charge():
    mgr = make_manager()
    loader = BackgroundLoader(mgr)
    plan = mgr.plan_proactive("a", now=0.0)
    ld = loader.enqueue(plan, now_ms=0.0, predicted_ms=2000.0)
    assert mgr.state.inflight_mb == 500.0
    # Inside the window: nothing to cancel yet.
    loader.cancel_stale(ld.ready_ms + 1.0, delta_ms=50.0,
                        has_queued=lambda a: False)
    assert "a" in loader.inflight
    # Window long past, no request in sight: the guess is wrong.
    n = loader.cancel_stale(3000.0, delta_ms=50.0,
                            has_queued=lambda a: False)
    assert n == 1
    assert loader.prefetch_wasted == 1
    assert mgr.state.inflight_mb == 0.0, "cancelled claim returned"
    assert mgr.state.free_mb == pytest.approx(1000.0)
    assert mgr.state.tenants["a"].loaded is None
    loader.close()


def test_cancel_restores_device_to_accounted_variant():
    """If the wall-clock staging already ran, cancel re-stages whatever
    the accounting says is loaded so device and state agree."""
    staged = []
    mgr = make_manager()
    loader = BackgroundLoader(
        mgr, stage_fn=lambda app, v: staged.append((app, v)))
    ld = loader.enqueue(mgr.plan_proactive("a", 0.0), now_ms=0.0,
                        predicted_ms=10.0)
    ld.future.result()  # wall-clock staging lands
    loader.cancel("a", now_ms=500.0)
    loader.close()  # drain the restore task
    assert staged[-1] == ("a", None), "device restored to unloaded"


def test_enqueue_skips_resident_downgrades_and_duplicates():
    mgr = make_manager()
    loader = BackgroundLoader(mgr)
    big = mgr.state.tenants["a"].zoo.largest
    mgr.state.load("a", big)
    assert loader.enqueue(mgr.plan_proactive("a", 0.0), 0.0) is None
    mgr.state.load("a", None)
    ld = loader.enqueue(mgr.plan_demand("a", 0.0), 0.0)
    assert ld is not None
    assert loader.enqueue(mgr.plan_demand("a", 0.0), 0.0) is None, \
        "plan_demand refuses while mid-staging"
    loader.close()


# ---------------------------------------------------------------------------
# Engine integration (real configs, stub executor)
# ---------------------------------------------------------------------------
def test_predictor_driven_prefetch_produces_warm_hit():
    """Teach the RNN predictor a cadence, evict the tenant, and let the
    prediction-triggered background load restore it before the next
    request: the admission must be a warm prefetch hit."""
    srv = make_server()
    srv.start()
    srv.engine._executor = stub_executor
    app = TENANTS[0]
    cfg = get_config(app, reduced=True)
    rng = np.random.default_rng(0)

    def req(t):
        return Request(app=app, prompt=rng.integers(
            0, cfg.vocab_size, 5).astype(np.int32), max_new=2,
            arrival_ms=t)

    # A regular 1000ms cadence the mean-gap predictor nails.
    for t in (0.0, 1000.0, 2000.0, 3000.0, 4000.0):
        srv.engine.submit(req(t), t)
        batch = srv.engine.batcher.next_batch()
        srv.engine.execute_batch(batch, t)
    # Simulate an eviction between requests (another tenant's pressure).
    srv.manager.state.load(app, None)
    srv.tenants[app].set_variant(None)
    # Next request predicted at ~5000: the trigger fires early enough...
    t_trig = srv.next_prefetch_trigger(3500.0)
    assert 3500.0 < t_trig < 5000.0
    srv.predict_and_preload(t_trig)
    assert app in srv.loader.inflight, "prefetch staged in background"
    srv.engine._reap_loads(t_trig + 1000.0)
    assert srv.manager.state.tenants[app].loaded is not None
    # ... and the predicted request warm-starts.
    srv.engine.submit(req(5000.0), 5000.0)
    batch = srv.engine.batcher.next_batch()
    results, _, toks = srv.engine.execute_batch(batch, 5000.0)
    assert toks is not None and results[0].warm
    assert srv.loader.prefetch_hits == 1
    assert srv.loader.load_overlap_ms >= 0.0
    srv.engine.check_event_invariant()
    srv.close()


def test_demand_load_admits_cold_not_warm():
    """A load triggered by an already-queued request is not a prefetch:
    the batch waited out the transfer and must be recorded cold."""
    srv = make_server()
    srv.start()
    srv.engine._executor = stub_executor
    app = TENANTS[1]
    cfg = get_config(app, reduced=True)
    rng = np.random.default_rng(1)
    trace = [Request(app=app, prompt=rng.integers(
        0, cfg.vocab_size, 5).astype(np.int32), max_new=2,
        arrival_ms=t) for t in (10.0, 4000.0)]
    stats = srv.engine.run_trace(trace)
    assert stats.demand_loads == 1
    assert stats.prefetch_hits == 0
    first, second = sorted(srv.engine.results, key=lambda r: r.arrival_ms)
    assert not first.failed and not first.warm, "waited out its own load"
    assert not second.failed and second.warm, "resident by then"
    srv.close()


def _speculation_fixture(pending_mb):
    """a's 500MB prefetch in flight on an 800MB budget; b has a queued
    request whose demand load is unfundable until speculation yields."""
    mgr = make_manager(budget_mb=800.0)
    srv = make_server()  # engine/batcher shell; manager swapped below
    srv.start()
    srv.engine._executor = stub_executor
    loader = BackgroundLoader(mgr)
    srv.loader.close()  # replace the real loader with the synthetic one
    srv.manager = mgr
    srv.engine.loader = srv.loader = loader
    loader.enqueue(mgr.plan_proactive("a", 0.0), 0.0, predicted_ms=600.0)
    assert mgr.state.free_mb == pytest.approx(300.0)
    mgr.state.pending_mb += pending_mb  # leave < b.smallest free
    assert mgr.plan_demand("b", 0.0) is None

    class FakeTenant:
        cfg = get_config(TENANTS[0], reduced=True)
    srv.tenants["b"] = FakeTenant()
    srv.engine.batcher.submit(
        Request(app="b", prompt=np.arange(4, dtype=np.int32),
                max_new=2, arrival_ms=0.0))
    return mgr, srv, loader


def test_speculation_shrinks_before_cancelling_for_demand():
    """A speculative prefetch's in-flight claim must never starve a real
    queued request — but yielding is graduated: the guess is first
    *shrunk* to its smallest variant (keeping a degraded warm start)
    and only cancelled outright when that still cannot fund demand."""
    mgr, srv, loader = _speculation_fixture(pending_mb=250.0)
    srv.engine._stage_demand_loads(0.0)
    # Shrinking a 500 -> 300 freed 200MB: b's 200MB smallest now fits.
    ld = loader.inflight.get("a")
    assert ld is not None, "shrunk, not cancelled"
    assert ld.variant.size_mb == 300.0
    assert ld.charge_mb == 300.0
    assert loader.prefetch_shrunk == 1
    assert loader.prefetch_wasted == 0
    assert "b" in loader.inflight, "demand load funded"
    assert loader.inflight["b"].demand
    mgr.state.pending_mb -= 250.0
    loader.close()
    srv.close()


def test_speculation_cancelled_when_shrink_is_not_enough():
    """When even the shrunk claim starves the demand load, the guess is
    cancelled outright (shrink first, then cancel)."""
    # pending 450: free after shrink = 800 - 300 - 450 = 50 < 200, so
    # only a full cancel (free 350) funds b's smallest.
    mgr, srv, loader = _speculation_fixture(pending_mb=450.0)
    srv.engine._stage_demand_loads(0.0)
    assert "a" not in loader.inflight, "speculative claim cancelled"
    assert "b" in loader.inflight, "demand load funded"
    assert loader.prefetch_shrunk == 1, "shrink was tried first"
    assert loader.prefetch_wasted == 1
    mgr.state.pending_mb -= 450.0
    loader.close()
    srv.close()


def test_shrink_inflight_lifecycle():
    """shrink_inflight releases the claim difference, restages the
    smaller transfer, and the shrunk load commits/cancels normally."""
    mgr = make_manager()
    loader = BackgroundLoader(mgr)
    ld = loader.enqueue(mgr.plan_proactive("a", 0.0), now_ms=0.0,
                        predicted_ms=2000.0)
    assert ld.charge_mb == 500.0
    small = mgr.state.tenants["a"].zoo.smallest  # 300MB
    out = loader.shrink_inflight("a", small, now_ms=100.0)
    assert out is ld
    assert ld.variant is small and ld.charge_mb == 300.0
    assert ld.t_enqueue_ms == 100.0, \
        "overlap window restarts with the smaller transfer"
    assert ld.ready_ms == pytest.approx(100.0 + small.load_ms)
    assert mgr.state.inflight_mb == pytest.approx(300.0)
    assert mgr.state.free_mb == pytest.approx(700.0)
    # Idempotence/guards: same-or-larger target and demand loads refuse.
    assert loader.shrink_inflight("a", small, 150.0) is None
    assert loader.shrink_inflight("a", None, 150.0) is None
    recs = loader.reap(ld.ready_ms)
    assert [r.bits for r in recs] == [small.bits]
    assert mgr.state.tenants["a"].loaded is small
    assert mgr.state.inflight_mb == 0.0
    assert loader.prefetch_shrunk == 1
    loader.close()


def test_shrink_inflight_refuses_demand_loads():
    mgr = make_manager()
    loader = BackgroundLoader(mgr)
    loader.enqueue(mgr.plan_demand("a", 0.0), 0.0, demand=True)
    small = mgr.state.tenants["a"].zoo.smallest
    assert loader.shrink_inflight("a", small, 10.0) is None, \
        "a demand load's variant was planned against a waiting batch"
    assert loader.prefetch_shrunk == 0
    loader.close()


def test_event_invariant_holds_with_loads_in_flight():
    """The per-event budget invariant (used + in-flight ≤ budget) holds
    through a contended prefetching run, admits balance retires, and no
    KV or in-flight charge leaks."""
    srv = make_server(max_batch=4)
    srv.budget_mb = srv.contention_budget(0.05)
    srv.start()
    srv.engine._executor = stub_executor
    cfgs = {n: get_config(n, reduced=True) for n in TENANTS}
    trace, _ = poisson_trace(cfgs, requests_per_app=15,
                             mean_iat_ms=300.0, seed=3)
    stats = srv.engine.run_trace(trace)
    assert stats.requests == len(trace)
    srv.engine.check_event_invariant()
    kinds = [e.kind for e in srv.engine.events]
    assert kinds.count("admit") == kinds.count("retire")
    assert "prefetch" in kinds or stats.demand_loads > 0
    assert srv.manager.state.kv_mb == 0.0
    assert srv.manager.state.inflight_mb == 0.0, "no stranded claims"
    srv.close()


# ---------------------------------------------------------------------------
# Predictor normalizer fix
# ---------------------------------------------------------------------------
def test_predict_normalizes_by_trailing_context_not_stale_mean():
    """After fit() the history keeps growing; a drifted series must be
    normalized by the trailing context, not the fit-time mean."""
    p = SeriesPredictor(context=8, hidden=16, seed=0)
    for _ in range(40):
        p.observe(100.0)
    loss = p.fit(steps=300)
    assert loss < 0.05
    assert p.predict() == pytest.approx(100.0, rel=0.25)
    # The series shifts scale by 10x after the last fit.
    for _ in range(20):
        p.observe(1000.0)
    assert p.mean == pytest.approx(100.0), "fit-time mean is stale"
    pred = p.predict()
    assert pred == pytest.approx(1000.0, rel=0.35), \
        f"stale normalizer would predict ~100, got {pred}"


def test_predict_untrained_falls_back_to_trailing_mean():
    p = SeriesPredictor(context=4, hidden=8, seed=0)
    for v in (10.0, 20.0, 30.0, 40.0, 50.0, 60.0):
        p.observe(v)
    assert p.losses is None
    assert p.predict() == pytest.approx(np.mean([30.0, 40.0, 50.0, 60.0]))
