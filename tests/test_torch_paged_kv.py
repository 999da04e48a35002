"""Paged KV cache + continuous batching, on the port.

The cases of ``test_paged_kv.py`` run against ``repro_torch``: the page
pool's conservation invariant under charge / evict / crash-release,
simulate ≡ apply for page-granular actions on a device ledger, the
over-release accounting, the per-instance batcher counter, per-request
retirement in the scalar engine, and the continuous-batching engine's
join/leave determinism, KV-rejection advantage and page preemption path.
Where a case runs one trace, the same ``ServingConfig`` and trace go
through the JAX package too, and the ``ServingStats``, the audit trail
and the per-request results must be equal; the pool's page tables and
per-device partitions are held to the reference's the same way.
"""
import numpy as np
import pytest

from repro.core import memory_state as jms
from repro.serving import EdgeServer as JServer
from repro.serving import api as japi
from repro.serving import poisson_trace as jtrace
from repro_torch.configs import get_config
from repro_torch.core import actions as A
from repro_torch.core.memory_state import (DeviceLedger, KVPagePool,
                                           MemoryState, TenantState)
from repro_torch.core.model_zoo import ModelVariant, ModelZoo
from repro_torch.serving import EdgeServer, poisson_trace
from repro_torch.serving import api as tapi
from repro_torch.serving.api import BatchingSpec, ServingConfig, TenantSpec
from repro_torch.serving.batcher import Batcher, Request

TENANTS = ["tinyllama-1.1b", "mamba2-780m"]


def _zoo(name, sizes):
    return ModelZoo(app_name=name, variants=tuple(
        ModelVariant(f"{name}-{i}", bits=32 >> i, size_mb=s,
                     accuracy=90.0 - 10 * i, load_ms=s * 2)
        for i, s in enumerate(sizes)))


@pytest.fixture(scope="module")
def cfgs():
    return {n: get_config(n, reduced=True) for n in TENANTS}


def sim_config(*, continuous, max_batch=4, budget_mb=None,
               kv_headroom_shape=(4, 128), kv_page_mb=0.0,
               window_ms=0.0, fallback="desperation", api=tapi):
    return api.ServingConfig(
        tenants=tuple(api.TenantSpec(n) for n in TENANTS),
        executor="sim",
        budget_mb=budget_mb,
        kv_headroom_shape=kv_headroom_shape,
        fallback=fallback,
        batching=api.BatchingSpec(max_batch=max_batch, continuous=continuous,
                                  kv_page_mb=kv_page_mb,
                                  window_ms=window_ms),
    )


# ---------------------------------------------------------------------------
# KVPagePool: conservation under charge / evict / crash-release
# ---------------------------------------------------------------------------
def test_page_conservation_and_id_reuse():
    pool = KVPagePool(2.0, 8)
    a = pool.allocate("a", 1, 3)
    b = pool.allocate("b", 7, 2)
    pool.check_invariant()
    assert pool.free_pages == 3 and pool.used_pages == 5
    assert a == (0, 1, 2) and b == (3, 4)  # lowest free id first
    assert pool.release("a", 1) == 3
    pool.check_invariant()
    # Freed ids go back to the front of the free list and are reused.
    c = pool.allocate("c", 9, 2)
    assert c == (0, 1)
    # Unknown sequence releases nothing (the caller accounts the drift).
    assert pool.release("a", 999) == 0
    # Crash-release drops every sequence a tenant holds.
    pool.allocate("b", 8, 1)
    assert pool.release_app("b") == 3
    pool.check_invariant()
    assert pool.free_pages == 6 and pool.held_pages("b") == 0


def test_pool_rejects_double_charge_and_exhaustion():
    pool = KVPagePool(1.0, 4)
    pool.allocate("a", 1, 2)
    with pytest.raises(A.PlanError, match="already holds"):
        pool.allocate("a", 1, 1)
    with pytest.raises(A.PlanError, match="exhausted"):
        pool.allocate("b", 2, 3)
    pool.check_invariant()
    assert pool.free_pages == 2, "failed allocation must not leak"


def test_pool_pages_for_rounding():
    pool = KVPagePool(2.0, 4)
    assert pool.pages_for(0.0) == 0
    assert pool.pages_for(0.1) == 1
    assert pool.pages_for(2.0) == 1  # exact fit does not round up
    assert pool.pages_for(2.1) == 2
    assert pool.pages_for(4.0) == 2


def test_pool_device_partition_and_balance():
    pool = KVPagePool(1.0, device_pages=(2, 4))
    assert [pool.device_of(p) for p in range(6)] == [0, 0, 1, 1, 1, 1]
    # Allocation drains the device with the most free pages first.
    got = pool.allocate("a", 1, 3)
    assert got == (2, 3, 0), "most-free device first, ties to lowest"
    pool.check_invariant()


def test_pool_victims_youngest_first():
    pool = KVPagePool(1.0, 8)
    pool.allocate("a", 1, 2)
    pool.allocate("b", 2, 3)
    pool.allocate("a", 3, 1)
    assert pool.victim_seqs(exclude="c") == [
        ("a", 3, 1), ("b", 2, 3), ("a", 1, 2)]
    assert pool.victim_seqs(exclude="a") == [("b", 2, 3)]


def _pool_digest(pool):
    return (pool.device_pages, [list(f) for f in pool.free],
            {a: dict(t) for a, t in pool.tables.items()},
            [pool.device_of(p) for p in range(pool.n_pages)],
            pool.victim_seqs())


@pytest.mark.parametrize("device_pages", [(8,), (2, 4), (3, 3, 5, 1)])
def test_pool_tables_and_partitions_match_reference(device_pages):
    """A seeded schedule of allocations, releases and crash-releases on
    the port's pool and the reference's, one step at a time: equal page
    ids, free lists, tables, per-device partitions and victim order, and
    equal refusals."""
    pools = (KVPagePool(1.0, device_pages=device_pages),
             jms.KVPagePool(1.0, device_pages=device_pages))
    rng = np.random.default_rng(sum(device_pages))
    for step in range(60):
        op = rng.choice(["alloc", "alloc", "release", "release_app"])
        app = str(rng.choice(["a", "b", "c"]))
        seq = int(rng.integers(0, 6))
        n = int(rng.integers(1, 4))
        outs = []
        for pool in pools:
            try:
                if op == "alloc":
                    outs.append(pool.allocate(app, seq, n))
                elif op == "release":
                    outs.append(pool.release(app, seq))
                else:
                    outs.append(pool.release_app(app))
            except Exception as e:  # the same refusal on both sides
                outs.append(type(e).__name__)
            pool.check_invariant()
        assert outs[0] == outs[1], (step, op, outs)
        assert _pool_digest(pools[0]) == _pool_digest(pools[1]), step


# ---------------------------------------------------------------------------
# simulate ≡ apply for page actions (device-ledger state)
# ---------------------------------------------------------------------------
def _paged_state(n_pages=6, page_mb=10.0, devices=False):
    st = MemoryState(budget_mb=1000.0, tenants={
        "a": TenantState(zoo=_zoo("a", [300, 150])),
        "b": TenantState(zoo=_zoo("b", [200, 100]))})
    if devices:
        st.devices = DeviceLedger(
            (500.0, 500.0),
            split_fn=lambda app, v: (v.size_mb / 2,) * 2)
        st.kv_pool = KVPagePool(page_mb,
                                device_pages=(n_pages // 2, n_pages // 2))
    else:
        st.kv_pool = KVPagePool(page_mb, n_pages)
    return st


def _digest(st):
    pool = st.kv_pool
    return ({a: (t.loaded, t.kv_mb, t.inflight_mb)
             for a, t in st.tenants.items()},
            st.pending_mb, st.kv_overrelease_mb,
            tuple(tuple(f) for f in pool.free),
            {a: dict(t) for a, t in pool.tables.items()})


@pytest.mark.parametrize("devices", [False, True])
def test_simulate_matches_apply_for_page_actions(devices):
    st = _paged_state(devices=devices)
    plan = A.ResidencyPlan((
        A.ChargeKV("a", 25.0, seq=1),   # 3 pages
        A.ChargeKV("b", 10.0, seq=2),   # 1 page
        A.EvictKV("a", 0.0, seq=1),
    ))
    before = _digest(st)
    assert st.simulate(plan) is None
    assert _digest(st) == before, "simulate must not mutate"
    st.apply(plan)
    st.check_invariant()
    assert st.kv_pool.held_pages("a") == 0
    assert st.kv_pool.held_pages("b") == 1
    assert st.tenants["b"].kv_mb == pytest.approx(10.0)
    assert st.tenants["a"].kv_mb == 0.0


@pytest.mark.parametrize("devices", [False, True])
def test_infeasible_page_plan_rolls_back(devices):
    st = _paged_state(devices=devices)
    st.apply(A.ResidencyPlan((A.ChargeKV("a", 40.0, seq=1),)))  # 4 of 6
    before = _digest(st)
    bad = A.ResidencyPlan((
        A.ChargeKV("b", 10.0, seq=2),
        A.ChargeKV("b", 20.0, seq=3),   # 1 + 2 pages > 2 free
    ))
    assert st.simulate(bad) is not None
    assert _digest(st) == before, "failed simulate must not mutate"
    with pytest.raises(A.PlanError):
        st.apply(bad)
    assert _digest(st) == before, "failed apply must roll back the pool"
    st.check_invariant()


def test_charge_is_page_rounded():
    st = _paged_state(n_pages=6, page_mb=10.0)
    st.apply(A.ResidencyPlan((A.ChargeKV("a", 11.0, seq=1),)))
    assert st.kv_pool.held_pages("a") == 2
    assert st.tenants["a"].kv_mb == pytest.approx(20.0), \
        "the charge is the page-rounded footprint, not the raw need"
    st.apply(A.ResidencyPlan((A.EvictKV("a", 0.0, seq=1),)))
    assert st.tenants["a"].kv_mb == 0.0 and st.kv_overrelease_mb == 0.0


# ---------------------------------------------------------------------------
# Over-release accounting (the drift a scalar clamp would hide)
# ---------------------------------------------------------------------------
def test_overrelease_counted_and_audited():
    st = MemoryState(budget_mb=100.0, tenants={
        "a": TenantState(zoo=_zoo("a", [50, 20]))})
    audits = []
    st.on_audit = lambda kind, app, mb: audits.append((kind, app, mb))
    st.reserve_kv("a", 30.0)
    st.release_kv("a", 50.0)  # 20 MB of drift
    assert st.tenants["a"].kv_mb == 0.0, "still clamps (compat)"
    assert st.kv_overrelease_mb == pytest.approx(20.0)
    assert audits == [("kv_overrelease", "a", pytest.approx(20.0))]


def test_overrelease_raises_under_strict():
    st = MemoryState(budget_mb=100.0, tenants={
        "a": TenantState(zoo=_zoo("a", [50, 20]))})
    st.strict_kv = True
    st.reserve_kv("a", 30.0)
    with pytest.raises(AssertionError, match="over-release"):
        st.release_kv("a", 50.0)


def test_overrelease_in_plan_is_plan_error_and_rolls_back():
    st = _paged_state()
    st.strict_kv = True
    st.apply(A.ResidencyPlan((A.ChargeKV("a", 10.0, seq=1),)))
    before = _digest(st)
    bad = A.ResidencyPlan((A.EvictKV("a", 50.0),))  # scalar over-release
    assert st.simulate(bad) is not None, "strict drift fails simulate"
    with pytest.raises(A.PlanError):
        st.apply(bad)
    assert _digest(st) == before
    st.check_invariant()


# ---------------------------------------------------------------------------
# Batcher: per-instance request ids (two builds, one process)
# ---------------------------------------------------------------------------
def test_batcher_ids_are_per_instance():
    b1, b2 = Batcher(), Batcher()
    r1 = b1.assign(Request(app="a", prompt=np.zeros(4, np.int32),
                           max_new=4, arrival_ms=0.0))
    r2 = b2.assign(Request(app="a", prompt=np.zeros(4, np.int32),
                           max_new=4, arrival_ms=0.0))
    assert r1.rid == 0 and r2.rid == 0, \
        "a second build must not inherit the first stack's counter"
    assert b1.assign(r1).rid == 0, "assign is idempotent"


# ---------------------------------------------------------------------------
# One trace through both packages
# ---------------------------------------------------------------------------
def _results(srv):
    return [(r.rid, r.app, r.arrival_ms, r.done_ms, r.warm, r.failed,
             r.kv_mb) for r in srv.engine.results]


def _trail(srv):
    return [(e.kind.value, e.t, e.app, e.detail)
            for e in srv.engine.audit_trail]


def _run_pkg(server_cls, api, trace_fn, *, continuous, seed=3, n=20,
             iat=300.0, max_new=8, **kw):
    srv = server_cls.build(sim_config(continuous=continuous, api=api, **kw))
    tcfgs = {t.name: t.cfg for t in srv.tenants.values()}
    trace, _ = trace_fn(tcfgs, requests_per_app=n, mean_iat_ms=iat,
                        seed=seed, max_new=max_new)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    srv.close()
    return srv, stats


def _run(cfgs, **kw):
    """Run the trace on the port and on the reference: the port's server
    and stats, after checking the two runs are equal."""
    tsrv, tstats = _run_pkg(EdgeServer, tapi, poisson_trace, **kw)
    jsrv, jstats = _run_pkg(JServer, japi, jtrace, **kw)
    assert tstats.to_dict() == jstats.to_dict()
    assert _trail(tsrv) == _trail(jsrv)
    assert _results(tsrv) == _results(jsrv)
    return tsrv, tstats


def test_two_builds_one_process_identical(cfgs):
    """Two EdgeServer.build stacks in one process replay the same trace
    to identical results (request ids are per instance), and both equal
    the reference's."""
    outs = []
    for _ in range(2):
        srv, _ = _run(cfgs, continuous=False, n=12, iat=250.0, seed=5)
        outs.append([(r.rid, r.app, r.arrival_ms, r.done_ms, r.warm,
                      r.failed) for r in srv.engine.results])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Scalar engine: per-request retirement (no whole-batch max_new hold)
# ---------------------------------------------------------------------------
def test_short_requests_retire_before_long(cfgs):
    from repro.serving.batcher import Batch as JBatch
    from repro.serving.batcher import Request as JRequest
    from repro_torch.serving.batcher import Batch

    outs = []
    for server_cls, api, batch_cls, req_cls in (
            (EdgeServer, tapi, Batch, Request),
            (JServer, japi, JBatch, JRequest)):
        srv = server_cls.build(sim_config(continuous=False, api=api))
        app = TENANTS[0]
        prompts = np.zeros((3, 6), np.int32)
        reqs = [srv.engine.batcher.assign(
            req_cls(app=app, prompt=prompts[i], max_new=mn, arrival_ms=0.0))
            for i, mn in enumerate((2, 16, 4))]
        batch = batch_cls(app, reqs, prompts, max(r.max_new for r in reqs))
        results, _, toks = srv.engine.execute_batch(batch, now_ms=0.0)
        assert toks is not None
        by_new = {r.rid: res for r, res in zip(reqs, results)}
        assert by_new[reqs[0].rid].done_ms < by_new[reqs[1].rid].done_ms
        assert by_new[reqs[2].rid].done_ms < by_new[reqs[1].rid].done_ms
        # The per-request shares drain the charge exactly (no residue).
        assert srv.manager.state.kv_mb == 0.0
        assert all(res.kv_mb > 0 for res in results)
        assert srv.manager.state.kv_overrelease_mb == 0.0
        srv.engine.check_event_invariant()
        srv.close()
        outs.append([(res.done_ms, res.kv_mb, res.warm, res.failed)
                     for res in results])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Continuous batching: determinism, fewer rejections, preemption
# ---------------------------------------------------------------------------
def test_continuous_join_leave_deterministic(cfgs):
    outs = []
    for _ in range(2):
        srv, stats = _run(cfgs, continuous=True)
        assert stats.requests == 40
        outs.append(_results(srv))
    assert outs[0] == outs[1]


def test_continuous_pool_drains_on_completion(cfgs):
    srv, stats = _run(cfgs, continuous=True)
    assert stats.kv_pages_used == 0, "every retired seq freed its pages"
    assert srv.manager.state.kv_mb == 0.0
    assert stats.kv_overrelease_mb == 0.0, \
        "page-granular release cannot drift from its charge"


# The contention regime of the reference's A/B gate: a KV budget too small
# for whole max_batch batches, arrivals dense enough that the 50 ms
# batching window forms full batches.
CONTENTION = dict(budget_mb=0.30, max_batch=8, window_ms=50.0,
                  n=24, iat=1.0, max_new=120, seed=11)


def test_continuous_fewer_kv_rejections_than_scalar(cfgs):
    """Under a KV budget too small for whole batches, page-granular
    admission keeps accepting single requests where the batch-scalar
    path rejects wholesale."""
    _, scalar = _run(cfgs, continuous=False, **CONTENTION)
    _, paged = _run(cfgs, continuous=True, **CONTENTION)
    assert scalar.kv_rejections > 0, "the scenario actually contends"
    assert scalar.kv_rejections > paged.kv_rejections
    assert paged.warm_ratio >= scalar.warm_ratio


def test_manager_preempts_cold_kv_pages_in_one_plan():
    """Desperation composes weight evictions and cold-KV-page evictions
    in a single transactional plan: tenant b's admission preempts a's
    youngest sequence and the victim surfaces through take_preempted()."""
    from repro_torch.core import EdgeMultiAI

    mgr = EdgeMultiAI({"a": _zoo("a", [10.0, 5.0]),
                       "b": _zoo("b", [10.0, 5.0])},
                      budget_mb=100.0, policy="iws-bfe", delta_ms=10.0)
    mgr.state.kv_pool = KVPagePool(10.0, 4)
    mgr.admit_batch("a", now=0.0, kv_mb=10.0, seq=1)
    mgr.admit_batch("a", now=1.0, kv_mb=10.0, seq=2)
    mgr.admit_batch("a", now=2.0, kv_mb=10.0, seq=3)
    assert mgr.state.kv_pool.free_pages == 1
    adm = mgr.admit_batch("b", now=3.0, kv_mb=20.0, seq=4)  # needs 2
    assert not adm.failed and adm.kv_mb == pytest.approx(20.0)
    assert mgr.kv_preemptions == 1
    assert mgr.take_preempted() == (("a", 3),), "youngest victim first"
    assert mgr.take_preempted() == (), "drained"
    assert mgr.state.kv_pool.held_pages("a") == 2
    assert mgr.state.kv_pool.held_pages("b") == 2
    mgr.state.check_invariant()


def test_own_pages_are_never_preempted():
    """A tenant cannot evict its own sequences to admit a new one — the
    admission is rejected instead (the caller decides scheduling)."""
    from repro_torch.core import EdgeMultiAI

    mgr = EdgeMultiAI({"a": _zoo("a", [10.0, 5.0])},
                      budget_mb=100.0, policy="iws-bfe", delta_ms=10.0)
    mgr.state.kv_pool = KVPagePool(10.0, 2)
    mgr.admit_batch("a", now=0.0, kv_mb=10.0, seq=1)
    mgr.admit_batch("a", now=1.0, kv_mb=10.0, seq=2)
    adm = mgr.admit_batch("a", now=2.0, kv_mb=10.0, seq=3)
    assert adm.failed and adm.kv_rejected
    assert mgr.kv_preemptions == 0
    assert mgr.state.kv_pool.held_pages("a") == 2
    mgr.state.check_invariant()


def test_continuous_on_sharded_mesh_waits_for_the_sharded_loader():
    """The continuous engine on a (4,) sharded mesh, once refused while
    the sharded loader was not ported, now served: the page pool is
    partitioned across the chips in proportion to their ledger budgets,
    as the reference's is, and the same trace gives equal stats, audit
    trail, results, per-device partitions and free lists."""
    def run(server_cls, api, trace_fn):
        srv = server_cls.build(api.ServingConfig(
            tenants=tuple(api.TenantSpec(n) for n in TENANTS),
            executor="sim", kv_headroom_shape=(4, 128),
            loader=api.LoaderSpec(sharded=True, mesh_shape=(4,)),
            batching=api.BatchingSpec(max_batch=4, continuous=True)))
        tcfgs = {t.name: t.cfg for t in srv.tenants.values()}
        trace, _ = trace_fn(tcfgs, requests_per_app=20, mean_iat_ms=300.0,
                            seed=3, max_new=8)
        stats = srv.engine.run_trace(trace)
        srv.engine.check_event_invariant()
        srv.close()
        pool = srv.manager.state.kv_pool
        pool.check_invariant()
        return (stats.to_dict(), _trail(srv), _results(srv),
                pool.device_pages, [list(f) for f in pool.free],
                srv.manager.state.devices.budgets_mb)

    got = run(EdgeServer, tapi, poisson_trace)
    assert got == run(JServer, japi, jtrace)
    stats, _, _, device_pages, _, budgets = got
    assert len(device_pages) == 4 and len(set(budgets)) == 1
    assert max(device_pages) - min(device_pages) <= sum(device_pages) % 4
    assert stats["requests"] == 40 and stats["kv_pages_used"] == 0


def test_preempted_request_requeues_in_engine(cfgs):
    """End to end: a saturating burst with coarse pages triggers page
    preemption inside the continuous loop; the victim re-queues (a
    "preempt" event, not a lost request) and every request still reaches
    a result with the pool fully drained."""
    srv, stats = _run(cfgs, continuous=True, budget_mb=0.30,
                      kv_page_mb=0.03, max_batch=8, window_ms=50.0,
                      n=24, iat=0.01, max_new=120, seed=11)
    assert stats.requests == 48, "every request reaches a result"
    assert stats.kv_preemptions >= 1
    assert "preempt" in [e.kind for e in srv.engine.events]
    assert stats.kv_pages_used == 0
    assert stats.kv_overrelease_mb == 0.0

