"""The port's elastic mesh (chip loss and recovery as transactional drain
plans) against the JAX package's.

Ports ``test_elastic_serving``: the drain planner's three outcomes, KV
preemption, the all-or-nothing applier, the rebalance, the controller's
ranking, re-promotion and injector gating on synthetic zoos, and the
faulted sim engine runs.  Each scenario runs once on the reference and
once on the port, in this process: the reference test's assertions hold
on both, and plans, ledgers, events, audit trails and stats must be
equal exactly.  Also: the failure injector fires on the reference's
steps, a charged CUDA-graph pool does not push a drain onto the
pure-shed fallback, and the benchmark's elastic A/B (and its 8-seed p95
dip) equals the reference benchmark's live run.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

N_DEV = 4


def _pkg(name):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")

    return SimpleNamespace(
        name=name, A=mod("core.actions"), core=mod("core"),
        ms=mod("core.memory_state"), mz=mod("core.model_zoo"),
        SH=mod("distributed.sharding"), serving=mod("serving"),
        api=mod("serving.api"), el=mod("serving.elastic"),
        stats=mod("serving.stats"), ft=mod("distributed.fault_tolerance"),
        configs=mod("configs"))


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def both(fn, *args, **kw):
    """``fn`` on the reference and on the port; their observations must
    be equal.  Returns the port's."""
    want = fn(REF, *args, **kw)
    got = fn(PORT, *args, **kw)
    assert got == want
    return got


def _zoo(M, name, sizes):
    return M.mz.ModelZoo(app_name=name, variants=tuple(
        M.mz.ModelVariant(f"{name}-{i}", bits=32 >> i, size_mb=s,
                          accuracy=90.0 - 10 * i, load_ms=s * 2)
        for i, s in enumerate(sizes)))


def make_manager(M, budgets, budget_mb=4000.0, **zoos):
    zoos = {k: _zoo(M, k, v) for k, v in zoos.items()} or {
        "a": _zoo(M, "a", [400, 200]), "b": _zoo(M, "b", [400, 200])}
    mgr = M.core.EdgeMultiAI(zoos, budget_mb=budget_mb, policy="iws-bfe",
                             delta_ms=10.0, migrate=True)
    mgr.state.devices = M.ms.DeviceLedger(
        tuple(budgets),
        split_fn=lambda app, v: M.SH.variant_shard_mb(v.size_mb,
                                                      len(budgets)))
    return mgr


def _load(M, st, *apps):
    for app in apps:
        st.apply(M.A.plan_of(M.A.Load(app, st.tenants[app].zoo.largest)))


def _acts(acts):
    return [(type(a).__name__, a.app,
             getattr(a, "variant", None) and a.variant.name,
             getattr(a, "src", None), getattr(a, "dst", None),
             getattr(a, "mb", None), getattr(a, "seq", None))
            for a in acts]


def _weights(st):
    return {a: tuple(w) for a, w in st.devices.weights.items()}


# ---------------------------------------------------------------------------
# FaultSpec and the failure injector
# ---------------------------------------------------------------------------
def test_fault_spec_normalizes_and_validates():
    def run(M):
        FS = M.api.FaultSpec
        spec = FS(events=[[9000.0, 3, "up"], (3000, 3, "down")])
        assert spec.events == ((3000.0, 3, "down"), (9000.0, 3, "up"))
        for bad in (((0.0, 0, "explode"),), ((-1.0, 0, "down"),)):
            with pytest.raises(ValueError):
                FS(events=bad)
        return spec.events, spec.with_seed(4).seed

    both(run)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_failure_injector_fires_on_the_reference_steps(seed):
    """Scheduled steps fire once; with ``prob`` the counter-based
    ``(seed, step)`` stream fires on the same steps as the reference's."""
    def run(M):
        fired = []
        inj = M.ft.FailureInjector(fail_at_steps=(2, 5), prob=0.3,
                                   seed=seed)
        for step in list(range(40)) + [2, 5]:
            try:
                inj.check(step)
            except M.ft.NodeFailure as e:
                fired.append((step, str(e)))
        return fired

    fired = both(run)
    assert [s for s, msg in fired if "injected" in msg] == [2, 5]


def test_controller_rejects_chip_beyond_mesh_and_ledgerless_state():
    def run(M):
        mgr = make_manager(M, budgets=(500.0,) * N_DEV)
        FS = M.api.FaultSpec
        with pytest.raises(ValueError, match="chip 9"):
            M.el.ElasticController(FS(events=((0.0, 9, "down"),)), mgr)
        mgr.state.devices = None
        with pytest.raises(ValueError, match="device ledger"):
            M.el.ElasticController(FS(), mgr)
        return True

    both(run)


# ---------------------------------------------------------------------------
# The drain planner: simulate == apply, three outcomes
# ---------------------------------------------------------------------------
def _drain_migrates(M):
    A = M.A
    mgr = make_manager(M, budgets=(500.0,) * N_DEV)
    st = mgr.state
    _load(M, st, "a", "b")
    st.devices.offline(1)
    acts, counters, preempted, vacated = M.el.drain_plan(st, 1)
    assert counters == {"migrations": 2, "downgrades": 0, "unloads": 0}
    assert preempted == () and vacated == pytest.approx(200.0)
    assert st.simulate(A.ResidencyPlan(acts)) is None
    st.apply(A.ResidencyPlan(acts))
    st.devices.check_invariant()
    assert st.devices.weights["a"][1] == 0.0
    assert st.tenants["a"].loaded.size_mb == 400.0
    return _acts(acts), counters, vacated, _weights(st)


def test_drain_migrates_dead_shard_and_simulate_matches_apply():
    both(_drain_migrates)


def _drain_downgrades(M):
    A = M.A
    mgr = make_manager(M, budgets=(130.0,) * N_DEV, a=[480, 200])
    st = mgr.state
    _load(M, st, "a")
    st.devices.offline(0)
    acts, counters, _, _ = M.el.drain_plan(st, 0)
    assert counters["downgrades"] == 1 and counters["unloads"] == 0
    assert counters["migrations"] >= 1
    assert st.simulate(A.ResidencyPlan(acts)) is None
    st.apply(A.ResidencyPlan(acts))
    st.devices.check_invariant()
    assert st.tenants["a"].loaded.size_mb == 200.0
    assert st.devices.weights["a"][0] == 0.0
    return _acts(acts), counters, _weights(st)


def test_drain_downgrades_when_survivors_cannot_absorb_full_share():
    both(_drain_downgrades)


def _drain_unloads(M):
    A = M.A
    mgr = make_manager(M, budgets=(100.0,) * N_DEV, a=[400, 399])
    st = mgr.state
    _load(M, st, "a")
    st.devices.offline(2)
    acts, counters, _, _ = M.el.drain_plan(st, 2)
    assert counters == {"migrations": 0, "downgrades": 0, "unloads": 1}
    assert st.simulate(A.ResidencyPlan(acts)) is None
    st.apply(A.ResidencyPlan(acts))
    st.devices.check_invariant()
    assert st.tenants["a"].loaded is None
    assert "a" not in st.devices.weights
    return _acts(acts)


def test_drain_unloads_when_nothing_fits():
    both(_drain_unloads)


def _drain_kv(M):
    A = M.A
    mgr = make_manager(M, budgets=(500.0,) * N_DEV)
    st = mgr.state
    st.kv_pool = M.ms.KVPagePool(page_mb=1.0, device_pages=(4,) * N_DEV)
    _load(M, st, "a")
    st.apply(A.plan_of(A.ChargeKV("a", 4.0, seq=1, pages=4)))
    st.apply(A.plan_of(A.ChargeKV("a", 4.0, seq=2, pages=4)))
    pool = st.kv_pool
    dead = next(d for d in range(N_DEV)
                if any(pool._starts[d] <= pid
                       < pool._starts[d] + pool.device_pages[d]
                       for pid in pool.tables["a"][2]))
    st.devices.offline(dead)
    pool.offline_device(dead)
    acts, _, preempted, _ = M.el.drain_plan(st, dead)
    assert ("a", 2) in preempted or ("a", 1) in preempted
    assert st.simulate(A.ResidencyPlan(acts)) is None
    st.apply(A.ResidencyPlan(acts))
    pool.check_invariant()
    assert pool.seqs_on_device(dead) == []
    return dead, preempted, _acts(acts)


def test_drain_evicts_kv_pages_homed_on_the_dead_chip():
    both(_drain_kv)


def _all_or_nothing(M):
    A = M.A
    mgr = make_manager(M, budgets=(500.0,) * N_DEV)
    st = mgr.state
    _load(M, st, "a")
    st.devices.offline(1)
    acts, _, _, _ = M.el.drain_plan(st, 1)
    poisoned = A.ResidencyPlan(acts + (A.MigrateShard("a", 1, 0, 999.0),))
    before = (_weights(st), st.used_mb, st.devices.shards_migrated)
    assert st.simulate(poisoned) is not None
    with pytest.raises(A.PlanError):
        st.apply(poisoned)
    assert (_weights(st), st.used_mb, st.devices.shards_migrated) == before
    st.apply(A.ResidencyPlan(acts))
    st.devices.check_invariant()
    return before, _weights(st)


def test_apply_is_all_or_nothing_on_mid_plan_failure():
    both(_all_or_nothing)


def _rebalance(M):
    A = M.A
    mgr = make_manager(M, budgets=(500.0,) * N_DEV)
    st = mgr.state
    _load(M, st, "a")
    st.devices.offline(1)
    acts, _, _, _ = M.el.drain_plan(st, 1)
    st.apply(A.ResidencyPlan(acts))
    st.devices.online(1)
    back = M.el.rebalance_plan(st, 1)
    assert back and all(isinstance(a, A.MigrateShard) and a.dst == 1
                        for a in back)
    assert st.simulate(A.ResidencyPlan(back)) is None
    st.apply(A.ResidencyPlan(back))
    st.devices.check_invariant()
    canon = st.devices.split("a", st.tenants["a"].loaded)
    assert st.devices.weights["a"] == pytest.approx(list(canon))
    return _acts(back), _weights(st)


def test_rebalance_moves_surplus_back_toward_canonical():
    both(_rebalance)


# ---------------------------------------------------------------------------
# Ranking, re-promotion, the injector's gate
# ---------------------------------------------------------------------------
def _ranked(M, busy, idle):
    A = M.A
    mgr = make_manager(M, budgets=(240.0,) * N_DEV)
    st = mgr.state
    _load(M, st, "a", "b")
    st.tenants[busy].predicted_next = 100.0
    st.tenants[idle].predicted_next = None
    st.devices.offline(3)
    acts, counters, _, _ = M.el.drain_plan(st, 3, now=100.0)
    assert counters["downgrades"] == 1
    assert st.simulate(A.ResidencyPlan(acts)) is None
    st.apply(A.ResidencyPlan(acts))
    st.devices.check_invariant()
    assert st.tenants[idle].loaded.size_mb == 400.0
    assert st.tenants[busy].loaded.size_mb == 200.0
    return _acts(acts), _weights(st)


@pytest.mark.parametrize("busy,idle", [("a", "b"), ("b", "a")])
def test_drain_ranks_by_accuracy_times_readiness(busy, idle):
    both(_ranked, busy, idle)


def _repromote(M):
    mgr = make_manager(M, budgets=(130.0,) * N_DEV, a=[480, 200])
    st = mgr.state
    _load(M, st, "a")
    ctl = M.el.ElasticController(M.api.FaultSpec(
        events=((10.0, 0, "down"), (50.0, 0, "up"))), mgr)
    ctl.poll(10.0)
    assert ctl.drain_downgrades == 1 and ctl.repromotions == 0
    assert st.tenants["a"].loaded.size_mb == 200.0
    mid = _weights(st)
    ctl.poll(50.0)
    assert ctl.repromotions == 1
    assert st.tenants["a"].loaded.size_mb == 480.0
    assert not ctl._demoted
    st.devices.check_invariant()
    assert ctl.next_event_ms() == float("inf")
    return mid, _weights(st)


def test_chip_up_repromotes_demoted_variant():
    both(_repromote)


def _repromote_dropped(M):
    mgr = make_manager(M, budgets=(130.0,) * N_DEV, a=[480, 200])
    st = mgr.state
    _load(M, st, "a")
    ctl = M.el.ElasticController(M.api.FaultSpec(
        events=((10.0, 0, "down"), (20.0, 1, "down"), (50.0, 0, "up"))),
        mgr)
    ctl.poll(20.0)
    assert st.tenants["a"].loaded.size_mb == 200.0
    ctl.poll(50.0)
    assert ctl.repromotions == 0 and not ctl._demoted
    assert st.tenants["a"].loaded.size_mb == 200.0
    st.devices.check_invariant()
    return _weights(st), ctl.chips_lost, ctl.chips_recovered


def test_repromotion_dropped_when_capacity_never_returns():
    both(_repromote_dropped)


def test_fault_prob_validates_and_gates_the_schedule():
    def run(M):
        FS = M.api.FaultSpec
        for bad in (1.5, -0.1):
            with pytest.raises(ValueError, match="prob"):
                FS(prob=bad)
        out = []
        for prob, lost in ((1.0, 1), (1e-12, 0)):
            mgr = make_manager(M, budgets=(500.0,) * N_DEV)
            ctl = M.el.ElasticController(
                FS(events=((10.0, 1, "down"),), prob=prob, seed=5), mgr)
            ctl.poll(10.0)
            assert ctl.chips_lost == lost, prob
            out.append(ctl.chips_lost)
        return out

    both(run)


def _pool_drain(M):
    """Two tenants at 16 bits on a (4,) mesh whose survivors can absorb
    one dead-chip share but not both; chip 3 goes down after three rounds
    of batches.  On the port the tenants keep CUDA-graph pools by
    ``tests/test_torch_serving.py``'s ``_PoolStub`` rules, charged
    through the engine; the reference's tenants keep none."""
    from test_torch_serving import _PoolStub

    names = ("tinyllama-1.1b", "mamba2-780m")
    kw = dict(device="cpu") if M is PORT else {}
    srv = M.serving.EdgeServer(budget_mb=0.0, max_batch=4,
                               sharded_mesh=(N_DEV,), **kw)
    for name in names:
        srv.register_tenant(name, _PoolStub(name, 0.01, 0.008)
                            if M is PORT else M.api.SimTenant(
                                name, M.configs.get_config(
                                    name, reduced=True), service_ms=5.0))
    mesh = M.SH.serving_mesh((N_DEV,))
    big = [srv.tenants[n].zoo.largest.size_mb
           * M.SH.weight_shard_fraction(srv.tenants[n].cfg, mesh)
           for n in names]
    srv.budget_mb = 2 * sum(t.zoo.largest.size_mb
                            for t in srv.tenants.values())
    # Room on the three survivors for the larger share, not for both.
    srv.device_budget_mb = sum(big) + 1.1 * max(big) / (N_DEV - 1)
    srv.sync_predictor_fits = True
    srv.fault = M.api.FaultSpec(events=((1000.0, 3, "down"),))
    srv.start()
    st = srv.manager.state
    prompts = np.zeros((2, 6), np.int32)
    for i in range(3):  # eager, capture (a pool charged), replay
        for j, name in enumerate(names):
            r = srv.serve(name, prompts, max_new=4, now_ms=10.0 * i + j)
            assert not r.failed and r.bits == 16
    pools = {n: st.tenants[n].pool_mb for n in names} \
        if M is PORT else {}
    srv.engine._now = 1000.0
    srv.elastic.poll(1000.0)
    ctl = srv.elastic
    srv.engine.check_event_invariant()
    st.devices.check_invariant()
    out = (ctl.chips_lost, ctl.drain_migrations, ctl.drain_downgrades,
           ctl.drain_unloads, _weights(st),
           {n: st.tenants[n].loaded.bits for n in names})
    if M is PORT:
        assert all(p > 0 for p in pools.values())
        for name in names:
            if st.tenants[name].loaded.bits == 8:
                assert st.tenants[name].pool_mb == 0.0
                assert srv.tenants[name].pool_mb == 0.0
    srv.close()
    return out


def test_charged_graph_pool_does_not_force_the_pure_shed_fallback():
    """A pool charged on the card is global only (the ledger's chips never
    see it), and a drain's ``Downgrade`` clears it inside ``simulate`` as
    in ``apply``: the port applies the drain the reference applies to the
    same weights (one tenant migrated, the other downgraded), not the
    pure-shed fallback's unloads, and the downgraded tenant's pool charge
    is 0 afterwards."""
    lost, migrations, downgrades, unloads, _, bits = both(_pool_drain)
    assert lost == 1 and unloads == 0
    assert downgrades == 1 and migrations >= 1
    assert sorted(bits.values()) == [8, 16]


# ---------------------------------------------------------------------------
# The controller in the engine loop (declarative sim stack)
# ---------------------------------------------------------------------------
ELASTIC_TENANTS = ("tinyllama-1.1b", "mamba2-780m")
FAULT_EVENTS = ((3000.0, 3, "down"), (9000.0, 3, "up"))


def _run_elastic(M, fault, continuous=False, requests=30, **predictor):
    api = M.api
    srv = api.EdgeServer.build(api.ServingConfig(
        tenants=tuple(api.TenantSpec(n) for n in ELASTIC_TENANTS),
        executor="sim", policy="iws-bfe", delta_ms=750.0,
        batching=api.BatchingSpec(max_batch=4, window_ms=20.0,
                                  continuous=continuous),
        loader=api.LoaderSpec(sharded=True, mesh_shape=(N_DEV,)),
        predictor=api.PredictorSpec(**predictor),
        kv_headroom_shape=(2, 12),
        fault=None if fault is None else api.FaultSpec(**fault)))
    cfgs = {t.name: t.cfg for t in srv.tenants.values()}
    trace, _ = M.serving.poisson_trace(cfgs, requests_per_app=requests,
                                       mean_iat_ms=400.0, seed=7)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    events = [(ev.t_ms, str(ev.kind), ev.app, ev.kv_mb, ev.used_mb,
               ev.device_mb, ev.device_budget_mb)
              for ev in srv.engine.events]
    trail = [(e.kind.value, e.t, e.app, e.detail)
             for e in srv.engine.audit_trail]
    srv.close()
    return stats, events, trail


PREFIT = dict(min_fit_samples=10**6)
FAULT = dict(events=FAULT_EVENTS)


def _same_run(fault, **kw):
    """The run on both packages: equal events, trail and stats (the
    predictors held pre-fit, where both compute the same numpy mean)."""
    got = _run_elastic(PORT, fault, **kw, **PREFIT)
    want = _run_elastic(REF, fault, **kw, **PREFIT)
    assert got[1:] == want[1:]
    assert got[0].to_dict() == want[0].to_dict()
    return got


def test_faulted_run_holds_event_invariant_and_counts_the_cycle():
    stats, events, _ = _same_run(FAULT)
    assert stats.chips_lost == 1 and stats.chips_recovered == 1
    assert stats.drain_migrations >= 1
    kinds = [e[1] for e in events]
    assert kinds.index("chip_down") < kinds.index("drain") \
        < kinds.index("chip_up")
    down = kinds.index("chip_down")
    up = kinds.index("chip_up")
    assert events[down][6][3] > 0.0
    for t, kind, app, kv, used, dev, budget in events[down + 1:up]:
        if dev is not None:
            assert budget[3] == 0.0
            assert dev[3] <= PORT.A.EPS, (kind, app, dev)


def test_serving_continues_during_drain_and_recovery_restores_warm():
    faulted, _, _ = _same_run(FAULT)
    clean, _, _ = _same_run(None)
    assert faulted.requests == clean.requests
    assert faulted.weight_failures == 0
    assert faulted.warm_ratio >= clean.warm_ratio - 0.1
    assert clean.chips_lost is None


def test_faulted_sim_run_is_bit_deterministic():
    s1, e1, t1 = _run_elastic(PORT, FAULT)
    s2, e2, t2 = _run_elastic(PORT, FAULT)
    assert s1 == s2 and e1 == e2 and t1 == t2


def test_continuous_engine_preempts_and_requeues_across_loss():
    stats, events, _ = _same_run(FAULT, continuous=True)
    assert stats.chips_lost == 1 and stats.chips_recovered == 1
    assert stats.kv_pages_used == 0
    assert stats.kv_overrelease_mb == 0.0
    assert {"chip_down", "chip_up", "drain"} <= {e[1] for e in events}


def test_stats_to_dict_carries_elastic_block_only_when_configured():
    faulted, _, _ = _run_elastic(PORT, FAULT, **PREFIT)
    clean, _, _ = _run_elastic(PORT, None, **PREFIT)
    d = faulted.to_dict()
    assert d["chips_lost"] == 1 and d["drain_downgrades"] >= 0
    assert d["repromotions"] >= 0
    assert "chips_lost" not in clean.to_dict()
    assert str(PORT.stats.EventKind.CHIP_DOWN) == "chip_down"


def test_stochastic_fault_run_is_bit_deterministic():
    spec = dict(events=FAULT_EVENTS, prob=0.5, seed=3)
    s1, e1, t1 = _same_run(spec)
    s2, e2, t2 = _run_elastic(PORT, spec, **PREFIT)
    assert s1 == s2 and e1 == e2 and t1 == t2
    assert PORT.api.FaultSpec(events=FAULT_EVENTS) == \
        PORT.api.FaultSpec(**FAULT)


# ---------------------------------------------------------------------------
# The benchmark's elastic A/B: serving/elastic/warm_ratio and p95 dip
# ---------------------------------------------------------------------------
def _stats_equal(got: dict, want: dict) -> None:
    """Every stat equal, bit for bit.  ``prediction_hit_rate`` is read off
    the fitted RNN predictors, which start from each package's own
    initializer (the runs' decisions and audit trails still agree); the
    pre-fit cases above hold it exactly."""
    strip = ("prediction_hit_rate",)
    assert ({k: v for k, v in got.items() if k not in strip}
            == {k: v for k, v in want.items() if k not in strip})


def test_elastic_ab_equals_the_reference_benchmark():
    """``serving/elastic/warm_ratio`` 0.967 (faulted, with the clean run
    beside it) and ``p95_warm_dip`` 0.367 over the 8-seed sweep: the
    port's runs equal the reference benchmark's live ones, trails and
    stats."""
    from benchmarks import serving_throughput as bench

    def run(spec):
        fault = None if spec is None else dict(
            events=spec.events, seed=spec.seed, prob=spec.prob)
        stats, _, trail = _run_elastic(PORT, fault)
        assert trail == _run_elastic(REF, fault)[2]
        _stats_equal(stats.to_dict(), bench._run_elastic(spec))
        return stats.warm_ratio

    faulted = run(bench.FAULT_SCHEDULE)
    clean = run(None)
    dips = [clean - run(bench.FAULT_SWEEP_SCHEDULE.with_seed(s))
            for s in bench.FAULT_SWEEP_SEEDS]
    assert round(faulted, 3) == 0.967 and round(clean, 3) == 0.967
    assert round(float(np.percentile(dips, 95)), 3) == 0.367
