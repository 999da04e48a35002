"""The port's cluster tier (warm-aware routing across a fleet of edge
servers) against the JAX package's.

Ports ``test_cluster``: the config round trip and validation, the router
registry and the three built-ins over synthetic views, fleet runs on the
flash-crowd trace, the transactional tenant hand-off, and the trace
generators.  Each scenario runs once on the reference and once on the
port, in this process: the reference test's assertions hold on both, and
per-server audit trails and fleet stats must be equal.  The benchmark's
cluster A/B (warm-aware 0.98 against round-robin 0.919) equals the
reference benchmark's live run.
"""
import importlib
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

TEN = ["tinyllama-1.1b", "mamba2-780m", "gemma2-2b"]


def _pkg(name):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")

    return SimpleNamespace(
        name=name, cluster=mod("cluster"), routers=mod("cluster.routers"),
        sim=mod("core.simulator"), serving=mod("serving"),
        api=mod("serving.api"), batcher=mod("serving.batcher"))


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def both(fn, *args, **kw):
    """``fn`` on the reference and on the port; their observations must
    be equal.  Returns the port's."""
    want = fn(REF, *args, **kw)
    got = fn(PORT, *args, **kw)
    assert got == want
    return got


def _stats_equal(got: dict, want: dict) -> None:
    """Every stat equal, bit for bit.  ``prediction_hit_rate`` is read off
    the fitted RNN predictors, which start from each package's own
    initializer (the runs' decisions and audit trails still agree); the
    pre-fit case holds it exactly."""
    strip = ("prediction_hit_rate",)
    assert ({k: v for k, v in got.items() if k not in strip}
            == {k: v for k, v in want.items() if k not in strip})


def sim_config(M, service_ms=None, **kw):
    api = M.api
    return api.ServingConfig(
        tenants=tuple(api.TenantSpec(t, service_ms=service_ms)
                      for t in TEN),
        policy="bfe", executor="sim", **kw)


def _req(M, app, t, rid=None):
    return M.batcher.Request(app=app, prompt=np.zeros(8, np.int32),
                             max_new=4, arrival_ms=t, rid=rid)


def flash_trace(M, cluster, seed=7):
    wl = M.sim.generate_flash_crowd(
        TEN, requests_per_app=36, base_iat_ms=8000.0, burst_app=TEN[0],
        burst_requests=40, burst_iat_ms=100.0, seed=seed)
    cfgs = {t.name: t.cfg for t in cluster.servers[0].tenants.values()}
    return M.serving.trace_from_workload(wl, cfgs, seed=3,
                                         prompt_len=(8, 9), max_new=4)


def _trails(cl):
    return [[(e.kind.value, e.t, e.app, e.detail) for e in tr]
            for tr in cl.audit_trails()]


# ---------------------------------------------------------------------------
# Config round trip + validation
# ---------------------------------------------------------------------------
def test_cluster_config_round_trip():
    def run(M):
        C, api = M.cluster, M.api
        base = sim_config(
            M, batching=api.BatchingSpec(max_batch=4, window_ms=20.0),
            loader=api.LoaderSpec(prefetch=True, sharded=True,
                                  mesh_shape=(4,)),
            fault=api.FaultSpec(events=((3000.0, 1, "down"),), prob=0.25,
                                seed=5))
        cfg = C.ClusterConfig.uniform(
            3, base, C.RouterSpec(name="least-loaded", spill_penalty=2.0,
                                  handoff_queue=6))
        d = cfg.to_dict()
        back = C.ClusterConfig.from_dict(d)
        assert back == cfg
        assert back.servers[0].fault == base.fault
        assert back.servers[0].loader == base.loader
        assert back.router.handoff_queue == 6
        assert C.ClusterConfig.from_dict(json.loads(json.dumps(d))) == cfg
        return json.dumps(d, sort_keys=True)

    both(run)


def test_cluster_config_validation():
    def run(M):
        C, api = M.cluster, M.api
        base = sim_config(M)
        for match, make in (
                ("at least one server",
                 lambda: C.ClusterConfig(servers=())),
                ("executor='sim'", lambda: C.ClusterConfig(servers=(
                    api.ServingConfig(tenants=(api.TenantSpec(TEN[0]),)),))),
                ("prefetch", lambda: C.ClusterConfig(servers=(sim_config(
                    M, loader=api.LoaderSpec(prefetch=False)),))),
                ("continuous", lambda: C.ClusterConfig(servers=(sim_config(
                    M, batching=api.BatchingSpec(continuous=True)),))),
                ("same tenant set", lambda: C.ClusterConfig(servers=(
                    base, api.ServingConfig(tenants=(api.TenantSpec(
                        TEN[0]),), executor="sim")))),
                ("unknown router", lambda: C.RouterSpec(name="psychic")),
                ("spill_penalty", lambda: C.RouterSpec(spill_penalty=-1.0)),
                ("handoff_queue", lambda: C.RouterSpec(handoff_queue=-1))):
            with pytest.raises(ValueError, match=match):
                make()
        names = C.ClusterConfig.uniform(2, base).tenant_names
        assert names == tuple(sorted(TEN))
        with pytest.raises(ValueError, match="at least one server"):
            C.ClusterConfig.uniform(0, base)
        return names

    both(run)


# ---------------------------------------------------------------------------
# Router registry + built-ins (synthetic views)
# ---------------------------------------------------------------------------
def _view(M, i, pending=0, resident=None, staging=None, queued=None):
    return M.cluster.ServerView(index=i, pending=pending, served=0, warm=0,
                                queued=queued or {},
                                resident=resident or {},
                                staging=staging or {})


def test_router_registry_and_protocol():
    def run(M):
        C = M.cluster
        assert {"round-robin", "least-loaded", "warm-aware"} <= set(
            C.available_routers())
        for name in ("round-robin", "least-loaded", "warm-aware"):
            r = C.resolve_router(name)
            assert isinstance(r, C.Router) and r.name == name
        bad = C.RouterSpec.__new__(C.RouterSpec)
        object.__setattr__(bad, "name", "psychic")
        with pytest.raises(KeyError, match="unknown router"):
            C.resolve_router(bad)
        return C.available_routers()

    both(run)


def test_register_router_decorator():
    def run(M):
        C = M.cluster

        @C.register_router("always-two")
        class AlwaysTwo:
            def __init__(self, spec=None):
                pass

            def route(self, app, views, now_ms):
                return 2

        try:
            r = C.resolve_router("always-two")
            assert r.name == "always-two"
            return r.route("x", [_view(M, i) for i in range(3)], 0.0)
        finally:
            del M.routers._ROUTERS["always-two"]

    assert both(run) == 2


def test_round_robin_rotates():
    def run(M):
        r = M.cluster.resolve_router("round-robin")
        views = [_view(M, i) for i in range(3)]
        return [r.route("a", views, 0.0) for _ in range(5)]

    assert both(run) == [0, 1, 2, 0, 1]


def test_least_loaded_picks_shortest_queue():
    def run(M):
        r = M.cluster.resolve_router("least-loaded")
        return r.route("a", [_view(M, 0, pending=3), _view(M, 1, pending=1),
                             _view(M, 2, pending=1)], 0.0)

    assert both(run) == 1


def test_warm_aware_prefers_residency_then_spills():
    def run(M):
        r = M.cluster.resolve_router(
            M.cluster.RouterSpec(name="warm-aware", spill_penalty=5.0))
        return [r.route("a", views, 0.0) for views in (
            [_view(M, 0, resident={"a": 95.0}), _view(M, 1), _view(M, 2)],
            [_view(M, 0), _view(M, 1, staging={"a": 95.0}), _view(M, 2)],
            [_view(M, 0, pending=20, resident={"a": 95.0}), _view(M, 1)],
            [_view(M, 0, resident={"b": 90.0}), _view(M, 1)])]

    assert both(run) == [0, 1, 1, 1]


# ---------------------------------------------------------------------------
# Cluster runs: determinism + routing A/B
# ---------------------------------------------------------------------------
def _run_fleet(M, router, n=3, handoff=0, seed=7, **predictor):
    C = M.cluster
    cfg = C.ClusterConfig.uniform(
        n, sim_config(M, predictor=M.api.PredictorSpec(**predictor)),
        C.RouterSpec(name=router, handoff_queue=handoff))
    cl = C.EdgeCluster.build(cfg)
    stats = cl.run_trace(flash_trace(M, cl, seed=seed))
    cl.check_event_invariant()
    trails = _trails(cl)
    cl.close()
    return stats, trails


def test_cluster_two_builds_bit_identical():
    """Two port builds agree bit for bit, and with the reference's: the
    per-server audit trails event for event and every stat (the
    predictors held pre-fit, where both compute the same numpy mean)."""
    kw = dict(min_fit_samples=10**6)
    s1, t1 = _run_fleet(PORT, "warm-aware", **kw)
    s2, t2 = _run_fleet(PORT, "warm-aware", **kw)
    assert t1 == t2 and s1 == s2
    assert len(t1) == 3 and all(tr for tr in t1)
    js, jt = _run_fleet(REF, "warm-aware", **kw)
    assert t1 == jt and s1.to_dict() == js.to_dict()


@pytest.mark.parametrize("router", ["warm-aware", "round-robin"])
def test_fleet_run_equals_the_reference(router):
    stats, trails = _run_fleet(PORT, router)
    ref_stats, ref_trails = _run_fleet(REF, router)
    assert trails == ref_trails
    _stats_equal(stats.to_dict(), ref_stats.to_dict())


def test_warm_aware_beats_round_robin_on_flash_crowd():
    warm, _ = _run_fleet(PORT, "warm-aware")
    rr, _ = _run_fleet(PORT, "round-robin")
    assert warm.requests == rr.requests > 0
    assert warm.warm_ratio > rr.warm_ratio
    assert all(n > 0 for n in warm.cluster["per_server_requests"])
    assert warm.cluster["spilled"] == 0
    assert rr.cluster["spilled"] > 0
    assert warm.cluster["router"] == "warm-aware"
    assert warm.cluster["routed"] == warm.requests


def test_cluster_stats_block_shape():
    stats, _ = _run_fleet(PORT, "round-robin")
    c = stats.cluster
    assert c["servers"] == 3
    assert sum(c["per_server_requests"]) == stats.requests
    assert len(c["per_server_warm_ratio"]) == 3
    assert stats.to_dict()["cluster"] == c
    assert set(stats.per_tenant) == set(TEN)


# ---------------------------------------------------------------------------
# Transactional hand-off
# ---------------------------------------------------------------------------
def _handoff_trace(M):
    reqs = [_req(M, TEN[0], 0.0), _req(M, TEN[2], 1.0),
            _req(M, TEN[1], 2.0)]
    t = 500.0
    for _ in range(20):
        for app in (TEN[0], TEN[1]):
            reqs.append(_req(M, app, t))
            t += 2.0
    return reqs


def _handoff_fleet(M, handoff=4):
    C = M.cluster
    return C.EdgeCluster.build(C.ClusterConfig.uniform(
        2, sim_config(M, service_ms=30.0),
        C.RouterSpec(name="warm-aware", handoff_queue=handoff)))


def _handoff_run(M):
    cl = _handoff_fleet(M)
    stats = cl.run_trace(_handoff_trace(M))
    cl.check_event_invariant()
    trails = _trails(cl)
    cl.close()
    assert stats.cluster["handoffs"] >= 1
    assert stats.requests == 43
    kinds = [(k, app) for tr in trails for k, _, app, _ in tr]
    assert kinds.count(("handoff", TEN[0])) >= 2
    return stats.to_dict(), trails


def test_handoff_fires_and_stays_deterministic():
    got = both(_handoff_run)
    assert got == _handoff_run(PORT)


def _handoff_mid_flight(M):
    cl = _handoff_fleet(M)
    reqs = _handoff_trace(M)
    for i, r in enumerate(reqs):
        r.rid = i
    engines = [srv.engine for srv in cl.servers]
    for r in sorted(reqs, key=lambda r: r.arrival_ms):
        t = r.arrival_ms
        for eng in engines:
            eng.cluster_advance(t)
        views = cl.views()
        target = cl.router.route(r.app, views, t)
        target = cl._maybe_handoff(r.app, target, views, t)
        engines[target].cluster_submit(r)
        if cl.handoffs:
            break
    assert cl.handoffs == 1
    donor, recv = cl.servers
    moved = [a for a in (TEN[0], TEN[1])
             if donor.manager.state.tenants[a].loaded is None]
    assert len(moved) == 1
    app = moved[0]
    assert donor.engine.batcher.queued(app) == 0
    assert (app in recv.loader.inflight
            or recv.manager.state.tenants[app].loaded is not None)
    assert recv.engine.batcher.queued(app) >= 4
    queued = recv.engine.batcher.queued(app)
    while True:
        nxt = [eng.cluster_advance(math.inf) for eng in engines]
        if all(x == math.inf for x in nxt):
            break
    for eng in engines:
        eng.cluster_finish()
    served = [r.rid for srv in cl.servers for r in srv.engine.results]
    assert len(served) == len(set(served))
    cl.close()
    return app, queued, sorted(served), _trails(cl)


def test_handoff_moves_queue_and_drains_donor():
    both(_handoff_mid_flight)


def _handoff_abort(M):
    C, api = M.cluster, M.api
    tiny = api.ServingConfig(
        tenants=tuple(api.TenantSpec(t, service_ms=30.0) for t in TEN),
        policy="bfe", executor="sim", budget_mb=0.01)
    cl = C.EdgeCluster.build(C.ClusterConfig(
        servers=(sim_config(M, service_ms=30.0), tiny),
        router=C.RouterSpec(name="warm-aware", handoff_queue=4)))
    donor = cl.servers[0]
    for i in range(6):
        donor.engine.cluster_submit(_req(M, TEN[0], float(i), rid=i))
    donor.engine.cluster_advance(50.0)
    assert donor.manager.state.tenants[TEN[0]].loaded is not None
    before_q = donor.engine.batcher.queued(TEN[0])
    assert not cl._handoff(TEN[0], 0, 1, 100.0)
    assert cl.handoffs == 0
    assert donor.manager.state.tenants[TEN[0]].loaded is not None
    assert donor.engine.batcher.queued(TEN[0]) == before_q
    assert not cl.servers[1].loader.inflight
    cl.close()
    return before_q, _trails(cl)


def test_handoff_aborts_clean_when_receiver_cannot_host():
    both(_handoff_abort)


def _own_crowd(M):
    cl = _handoff_fleet(M)
    reqs = [_req(M, TEN[0], 0.0)]
    t = 500.0
    for _ in range(30):
        reqs.append(_req(M, TEN[0], t))
        t += 2.0
    stats = cl.run_trace(reqs)
    assert stats.cluster["handoffs"] == 0
    cl.close()
    return stats.to_dict(), _trails(cl)


def test_handoff_not_triggered_by_own_crowd():
    both(_own_crowd)


# ---------------------------------------------------------------------------
# Trace generators
# ---------------------------------------------------------------------------
def test_flash_crowd_deterministic_and_burst_unpredicted():
    def run(M):
        gen = M.sim.generate_flash_crowd
        a = gen(TEN, burst_app=TEN[0], seed=3)
        b = gen(TEN, burst_app=TEN[0], seed=3)
        c = gen(TEN, burst_app=TEN[0], seed=4)
        assert a.requests == b.requests and a.predictions == b.predictions
        assert a.requests != c.requests
        assert sum(1 for _, app in a.requests if app == TEN[0]) - 20 == 40
        assert len(a.predictions[TEN[0]]) <= 20
        assert all(t1 <= t2 for (t1, _), (t2, _) in
                   zip(a.requests, a.requests[1:]))
        with pytest.raises(ValueError, match="burst_app"):
            gen(TEN, burst_app="nobody")
        return a.requests, a.predictions

    both(run)


def test_diurnal_deterministic_and_validated():
    def run(M):
        gen = M.sim.generate_diurnal
        a = gen(TEN, requests_per_app=30, seed=11)
        b = gen(TEN, requests_per_app=30, seed=11)
        c = gen(TEN, requests_per_app=30, seed=12)
        assert a.requests == b.requests and a.predictions == b.predictions
        assert a.requests != c.requests
        assert {app for _, app in a.requests} == set(TEN)
        with pytest.raises(ValueError, match="amplitude"):
            gen(TEN, amplitude=1.5)
        return a.requests, a.predictions

    both(run)


def test_generate_workload_unchanged_by_refactor():
    def run(M):
        wl = M.sim.generate_workload(TEN[:2], requests_per_app=10, seed=0)
        wl2 = M.sim.generate_workload(TEN[:2], requests_per_app=10, seed=0)
        assert wl.requests == wl2.requests
        assert wl.delta_D == wl2.delta_D and wl.kl == wl2.kl
        return wl.requests, wl.delta_D, wl.kl

    both(run)


# ---------------------------------------------------------------------------
# The benchmark's cluster A/B: serving/cluster/warm_ratio
# ---------------------------------------------------------------------------
def test_cluster_ab_equals_the_reference_benchmark():
    """``serving/cluster/warm_ratio`` 0.98 (warm-aware, hand-off armed)
    against round-robin's 0.919: the port's fleet stats equal the
    reference benchmark's live run."""
    from benchmarks import serving_throughput as bench

    def run(M, router):
        C = M.cluster
        base = M.api.ServingConfig(
            tenants=tuple(M.api.TenantSpec(n) for n in TEN),
            policy="bfe", executor="sim")
        cl = C.EdgeCluster.build(C.ClusterConfig.uniform(
            3, base, C.RouterSpec(name=router, handoff_queue=4)))
        stats = cl.run_trace(flash_trace(M, cl))
        cl.check_event_invariant()
        cl.close()
        return stats.to_dict()

    warm = run(PORT, "warm-aware")
    rr = run(PORT, "round-robin")
    _stats_equal(warm, bench._run_cluster("warm-aware"))
    _stats_equal(rr, bench._run_cluster("round-robin"))
    assert round(warm["warm_ratio"], 3) == 0.98
    assert round(rr["warm_ratio"], 3) == 0.919
