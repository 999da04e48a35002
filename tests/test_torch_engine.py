"""The port's counterpart of ``tests/test_engine.py`` (the reference's
cases on ``repro_torch``, real tenants on the CPU):

Serving-engine tests: KV-cache residency accounting and the
admit→execute→retire protocol.

Model execution is stubbed (injectable executor) so these exercise the
full admission/accounting path — real configs, real zoos, real manager —
without touching XLA; the end-to-end engine-with-real-models path is
covered by tests/test_serving.py and the serving_throughput benchmark.
"""
import asyncio

import numpy as np
import torch
import pytest

from repro_torch.configs import get_config
from repro_torch.core import EdgeMultiAI
from repro_torch.core.memory_state import MemoryState, TenantState
from repro_torch.core.model_zoo import ModelVariant, ModelZoo
from repro_torch.models import transformer as T
from repro_torch.serving import (Batch, EdgeServer, Request,
                           kv_cache_mb, poisson_trace)

TENANTS = ["tinyllama-1.1b", "mamba2-780m"]


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


@pytest.fixture(scope="module")
def cfgs():
    return {n: get_config(n, reduced=True) for n in TENANTS}


def one_batch(app, cfg, batch_size=2, plen=6, max_new=4):
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch_size, plen)).astype(np.int32)
    reqs = [Request(app=app, prompt=prompts[i], max_new=max_new,
                    arrival_ms=0.0) for i in range(batch_size)]
    return Batch(app, reqs, prompts, max_new)


# ---------------------------------------------------------------------------
# Charge / release protocol
# ---------------------------------------------------------------------------
def test_kv_charged_during_execution_released_after(cfgs):
    srv = make_server()
    srv.start()
    app = TENANTS[0]
    kv_expect = kv_cache_mb(cfgs[app], 2, 6 + 4)
    seen = {}

    def probing_executor(runtime, batch, extra=None):
        seen["kv_during"] = srv.manager.state.kv_mb
        return stub_executor(runtime, batch)

    srv.engine._executor = probing_executor
    results, _, toks = srv.engine.execute_batch(
        one_batch(app, cfgs[app]), now_ms=0.0)
    assert toks is not None and not results[0].failed
    assert seen["kv_during"] == pytest.approx(kv_expect)
    # Retirement is per request: each result carries its own share of
    # the charge (equal max_new -> equal split), summing to the total.
    assert sum(r.kv_mb for r in results) == pytest.approx(kv_expect)
    assert results[0].kv_mb == pytest.approx(kv_expect / 2)
    assert srv.manager.state.kv_mb == 0.0, "released on retirement"
    assert srv.manager.state.tenants[app].kv_mb == 0.0


def test_kv_released_when_executor_raises(cfgs):
    """A crashed batch (XLA OOM, bad inputs) must not leak its charge."""
    srv = make_server()
    srv.start()

    def boom(runtime, batch, extra=None):
        raise RuntimeError("simulated XLA OOM")

    srv.engine._executor = boom
    with pytest.raises(RuntimeError):
        srv.engine.execute_batch(one_batch(TENANTS[0], cfgs[TENANTS[0]]),
                                 now_ms=0.0)
    assert srv.manager.state.kv_mb == 0.0, "charge released on crash"
    assert srv.engine.events[-1].kind == "retire", "audit trail balances"
    # The crashed batch's requests are recorded as failures, not lost.
    assert len(srv.engine.results) == 2
    assert all(r.failed and not r.warm for r in srv.engine.results)
    srv.engine.check_event_invariant()


def test_kv_sized_from_real_cache_pytree(cfgs):
    cfg = cfgs[TENANTS[0]]
    cache = T.init_cache(cfg, 2, 10)
    nbytes = sum(leaf.numel() * leaf.element_size()
                 for leaf in cache.values())
    assert kv_cache_mb(cfg, 2, 10) == pytest.approx(nbytes / (1024 * 1024))


def test_event_invariant_covers_devices_with_sharded_loads(cfgs):
    """On a sharded mesh every audit event snapshots per-device weights
    + shard claims, and ``check_event_invariant`` holds them to the
    per-chip budgets while sharded loads are in flight."""
    from repro_torch.serving.api import SimTenant

    srv = EdgeServer(budget_mb=0.0, policy="iws-bfe", delta_ms=1000.0,
                     max_batch=4, sharded_mesh=(4,), device="cpu")
    for name in TENANTS:
        srv.register_tenant(name, SimTenant(name, cfgs[name]))
    srv.budget_mb = srv.contention_budget(0.05)
    srv.start()
    trace, _ = poisson_trace(cfgs, requests_per_app=15,
                             mean_iat_ms=300.0, seed=3)
    stats = srv.engine.run_trace(trace)
    assert stats.requests == len(trace)
    assert stats.shards_landed > 0, "the mesh path actually staged"
    srv.engine.check_event_invariant()
    loads = [e for e in srv.engine.events
             if e.kind in ("prefetch", "demand")]
    assert loads and all(e.device_mb is not None for e in loads)
    assert any(max(e.device_mb) > 0 for e in loads), \
        "claims visible per device while loads are in flight"
    # A tampered snapshot must trip the per-device check.
    bad = srv.engine.events[-1]
    bad.device_mb = tuple(b + 1.0
                          for b in srv.manager.state.devices.budgets_mb)
    with pytest.raises(AssertionError, match="device"):
        srv.engine.check_event_invariant()
    srv.close()


def test_event_log_and_invariant_under_contention(cfgs):
    srv = make_server(max_batch=4)
    srv.budget_mb = srv.contention_budget(0.1)
    srv.start()
    srv.engine._executor = stub_executor
    trace, _ = poisson_trace(cfgs, requests_per_app=15,
                             mean_iat_ms=300.0, seed=3)
    stats = srv.engine.run_trace(trace)
    assert stats.requests == len(trace)
    srv.engine.check_event_invariant()  # used_mb ≤ budget at every event
    kinds = {e.kind for e in srv.engine.events}
    assert {"submit", "admit", "retire"} <= kinds
    admits = sum(e.kind == "admit" for e in srv.engine.events)
    retires = sum(e.kind == "retire" for e in srv.engine.events)
    assert admits == retires, "every admitted batch must retire"
    assert srv.manager.state.kv_mb == 0.0


# ---------------------------------------------------------------------------
# Over-budget admission: downgrade or counted failure, never an assert
# ---------------------------------------------------------------------------
def test_overbudget_admit_downgrades_at_procure_without_thrash(cfgs):
    app = TENANTS[0]
    srv = make_server()
    zoo = srv.tenants[app].zoo
    kv = kv_cache_mb(cfgs[app], 2, 6 + 4)
    # bf16 fits but not bf16+cache; int8+cache fits
    srv.budget_mb = zoo.by_bits(16).size_mb + 0.5 * kv
    assert (zoo.by_bits(16).size_mb - zoo.by_bits(8).size_mb) > 0.5 * kv
    srv.start()
    srv.engine._executor = stub_executor
    loads = []
    orig = srv.tenants[app].set_variant
    srv.tenants[app].set_variant = lambda v: (loads.append(v), orig(v))
    results, _, toks = srv.engine.execute_batch(
        one_batch(app, cfgs[app]), now_ms=0.0)
    assert toks is not None and not results[0].failed
    assert results[0].bits == 8, "requester downgraded to fit its cache"
    # KV-aware procurement picks int8 directly: ONE weight transfer, not
    # a bf16 load immediately thrashed down to int8.
    assert [v.bits for v in loads] == [8]
    srv.engine.check_event_invariant()


def test_overbudget_admit_counted_failure_not_assert(cfgs):
    app = TENANTS[0]
    srv = make_server()
    zoo = srv.tenants[app].zoo
    big_kv = kv_cache_mb(cfgs[app], 8, 64)
    srv.budget_mb = zoo.by_bits(8).size_mb + 0.25 * big_kv
    srv.start()
    srv.engine._executor = stub_executor
    batch = one_batch(app, cfgs[app], batch_size=8, plen=32, max_new=32)
    results, _, toks = srv.engine.execute_batch(batch, now_ms=0.0)
    assert toks is None
    assert all(r.failed for r in results)
    assert srv.engine.kv_rejections == 1
    assert srv.manager.kv_rejections == 1
    assert srv.manager.state.kv_mb == 0.0
    srv.engine.check_event_invariant()  # rejection never overcommits


# ---------------------------------------------------------------------------
# Manager-level protocol (synthetic zoos, no models)
# ---------------------------------------------------------------------------
def _zoo(name, sizes):
    return ModelZoo(app_name=name, variants=tuple(
        ModelVariant(f"{name}-{i}", bits=32 >> i, size_mb=s,
                     accuracy=90.0 - 10 * i, load_ms=s * 2)
        for i, s in enumerate(sizes)))


def test_manager_admit_release_cycle():
    mgr = EdgeMultiAI({"a": _zoo("a", [500, 300]),
                       "b": _zoo("b", [400, 200])},
                      budget_mb=1000.0, policy="iws-bfe", delta_ms=10.0)
    adm = mgr.admit_batch("a", now=0.0, kv_mb=120.0)
    assert not adm.failed and adm.kv_mb == 120.0
    assert mgr.state.tenants["a"].kv_mb == 120.0
    assert mgr.state.used_mb == pytest.approx(500.0 + 120.0)
    mgr.release_kv("a", adm.kv_mb)
    assert mgr.state.kv_mb == 0.0
    assert mgr.state.used_mb == pytest.approx(500.0)


def test_manager_kv_pressure_scavenges_victim():
    mgr = EdgeMultiAI({"a": _zoo("a", [500, 300]),
                       "b": _zoo("b", [400, 200])},
                      budget_mb=950.0, policy="iws-bfe", delta_ms=10.0,
                      history_ms=10.0)
    mgr.state.load("b", mgr.state.tenants["b"].zoo.largest)  # 400
    mgr.state.tenants["b"].last_request = -1000.0  # outside LRU-K history
    # a loads 500 -> free 50; KV of 150 forces scavenging b down to 200
    adm = mgr.admit_batch("a", now=0.0, kv_mb=150.0)
    assert not adm.failed
    assert mgr.state.tenants["b"].loaded.size_mb == 200.0
    assert mgr.state.used_mb <= mgr.state.budget_mb + 1e-6


def test_manager_warm_tenant_self_downgrades_for_cache():
    """A tenant already warm at a large variant shrinks itself when its
    next batch's cache no longer fits beside the big weights."""
    mgr = EdgeMultiAI({"a": _zoo("a", [500, 300])},
                      budget_mb=520.0, policy="iws-bfe", delta_ms=10.0)
    mgr.state.load("a", mgr.state.tenants["a"].zoo.largest)  # warm at 500
    adm = mgr.admit_batch("a", now=0.0, kv_mb=100.0)
    assert not adm.failed and adm.warm
    assert adm.self_downgraded
    served = mgr.state.tenants["a"].loaded
    assert served.size_mb == 300.0
    assert mgr.state.used_mb == pytest.approx(400.0)
    # The inference record describes the variant that actually serves.
    rec = mgr.records[-1]
    assert rec.bits == served.bits == adm.bits
    assert rec.accuracy == served.accuracy


def test_manager_rejects_impossible_kv_without_assert():
    mgr = EdgeMultiAI({"a": _zoo("a", [500, 300])},
                      budget_mb=600.0, policy="iws-bfe", delta_ms=10.0)
    adm = mgr.admit_batch("a", now=0.0, kv_mb=1e6)
    assert adm.failed and adm.kv_mb == 0.0
    assert adm.kv_rejected, "weights were procurable; the cache was not"
    assert mgr.kv_rejections == 1
    assert mgr.state.kv_mb == 0.0
    mgr.state.check_invariant()  # state stayed consistent
    # Metrics must agree with the admission outcome: no phantom success.
    rec = mgr.records[-1]
    assert rec.failed and not rec.warm and rec.bits is None
    assert mgr.metrics().fail_ratio == 1.0


def test_manager_warm_rejection_retracts_success_record():
    """A warm tenant whose cache cannot fit even after self-downgrade is
    rejected — and the success record on_request logged is retracted so
    Metrics agree with the engine's view."""
    mgr = EdgeMultiAI({"a": _zoo("a", [500, 300])},
                      budget_mb=520.0, policy="iws-bfe", delta_ms=10.0)
    mgr.state.load("a", mgr.state.tenants["a"].zoo.largest)  # warm at 500
    adm = mgr.admit_batch("a", now=0.0, kv_mb=300.0)  # 220 free after dgrade
    assert adm.failed and adm.kv_rejected
    assert not adm.warm, "a rejected request is not a warm serve"
    rec = mgr.records[-1]
    assert rec.failed and not rec.warm and rec.bits is None
    assert mgr.metrics().fail_ratio == 1.0


def test_manager_weight_failure_not_counted_as_kv():
    """A tenant whose smallest variant cannot fit at all is a weight
    failure, not a KV rejection."""
    mgr = EdgeMultiAI({"a": _zoo("a", [500, 300])},
                      budget_mb=100.0, policy="iws-bfe", delta_ms=10.0)
    adm = mgr.admit_batch("a", now=0.0, kv_mb=1.0)
    assert adm.failed and not adm.kv_rejected
    assert mgr.kv_rejections == 0


def test_memory_state_kv_reserve_release_invariants():
    s = MemoryState(budget_mb=100.0,
                    tenants={"a": TenantState(zoo=_zoo("a", [50, 20]))})
    s.reserve_kv("a", 30.0)
    assert s.kv_mb == 30.0 and s.used_mb == 30.0 and s.free_mb == 70.0
    with pytest.raises(ValueError):
        s.reserve_kv("a", -1.0)
    s.release_kv("a", 100.0)  # over-release clamps at zero
    assert s.tenants["a"].kv_mb == 0.0


# ---------------------------------------------------------------------------
# Async entry + stats schema
# ---------------------------------------------------------------------------
def test_run_async_and_stats_schema(cfgs):
    srv = make_server()
    srv.start()
    srv.engine._executor = stub_executor
    trace, _ = poisson_trace(cfgs, requests_per_app=5,
                             mean_iat_ms=500.0, seed=1)
    stats = asyncio.run(srv.engine.run_async(trace))
    assert stats.requests == len(trace)
    assert stats.requests_per_sec is not None
    assert "requests_per_sec" in stats.to_dict()
    for app in TENANTS:
        s = stats.per_tenant[app]
        for key in ("p50_ms", "p95_ms", "p99_ms", "warm_ratio",
                    "fail_ratio", "throughput_rps", "mean_batch"):
            assert key in s
        assert s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    # server.stats() surfaces the engine view
    sstats = srv.stats()
    assert sstats.per_tenant.keys() == stats.per_tenant.keys()
    assert sstats.kv_mb == 0.0
