"""The port's counterpart of ``tests/test_api.py`` (the reference's
cases on ``repro_torch``, real tenants on the CPU):

Tests for the declarative serving API (`repro_torch.serving.api`) and the
policy registry: config round-trip build, registry resolution, the
deprecation shims, background predictor fits, and the batch-aware
procurement plugin beating head-batch planning on a burst trace.
"""
import functools

import numpy as np
import torch
import pytest

from repro_torch.configs import get_config
from repro_torch.core import EdgeMultiAI
from repro_torch.core.policies import (BatchAware, DesperationFallback,
                                 Policy, available_policies,
                                 register_policy, resolve_policy)
from repro_torch.serving import (EdgeServer, Request,
                           kv_cache_mb, poisson_trace)
from repro_torch.serving.api import (BatchingSpec, LoaderSpec, PredictorSpec,
                               ServingConfig, SimTenant, TenantSpec)

TENANTS = ("tinyllama-1.1b", "mamba2-780m")


def sim_config(**kw):
    base = dict(
        tenants=tuple(TenantSpec(n) for n in TENANTS),
        policy="iws-bfe", executor="sim", delta_ms=750.0,
        batching=BatchingSpec(max_batch=4, window_ms=20.0),
        kv_headroom_shape=(2, 12))
    base.update(kw)
    return ServingConfig(**base)


def stub_executor(runtime, batch, extra=None):
    return np.zeros((len(batch.requests), batch.max_new), np.int32)


# ---------------------------------------------------------------------------
# ServingConfig: declarative round trip + build wiring
# ---------------------------------------------------------------------------
def test_config_dict_round_trip():
    cfg = sim_config(policy="batch-bfe", budget_mb=12.5)
    assert ServingConfig.from_dict(cfg.to_dict()) == cfg


def test_config_validation():
    with pytest.raises(ValueError, match="at least one"):
        ServingConfig(tenants=())
    with pytest.raises(ValueError, match="duplicate"):
        ServingConfig(tenants=(TenantSpec("a", arch=TENANTS[0]),
                               TenantSpec("a", arch=TENANTS[0])))
    with pytest.raises(KeyError, match="registered policies"):
        sim_config(policy="not-a-policy")
    with pytest.raises(ValueError, match="executor"):
        sim_config(executor="quantum")


def test_build_wires_whole_stack():
    """One build call: tenants registered, predictors installed per spec,
    budget derived with KV headroom, policy resolved through the
    registry, loader + engine attached and started."""
    cfg = sim_config(predictor=PredictorSpec(context=4, hidden=8))
    srv = EdgeServer.build(cfg, device="cpu")
    try:
        assert set(srv.tenants) == set(TENANTS)
        assert all(isinstance(t, SimTenant) for t in srv.tenants.values())
        assert all(t.predictor.context == 4 for t in srv.tenants.values())
        assert srv.manager is not None and srv.engine is not None
        assert srv.loader is not None
        assert srv.manager.policy.name == "iws-bfe"
        assert isinstance(srv.manager.fallback, DesperationFallback)
        # Derived budget: contention plus the (2, 12)-shaped cache.
        kv = max(kv_cache_mb(t.cfg, 2, 12) for t in srv.tenants.values())
        assert srv.budget_mb == pytest.approx(srv.contention_budget(kv))
        total16 = sum(t.zoo.largest.size_mb for t in srv.tenants.values())
        assert total16 > srv.budget_mb, "derived budget forces contention"
    finally:
        srv.close()


def test_sim_executor_run_is_deterministic():
    """The sim-time executor makes a full engine run reproducible
    bit-for-bit: no XLA, no wall clock in the virtual timeline."""
    def one_run():
        srv = EdgeServer.build(sim_config(), device="cpu")
        cfgs = {t.name: t.cfg for t in srv.tenants.values()}
        trace, _ = poisson_trace(cfgs, requests_per_app=10,
                                 mean_iat_ms=400.0, seed=0)
        stats = srv.engine.run_trace(trace)
        srv.engine.check_event_invariant()
        done = [r.done_ms for r in srv.engine.results]
        srv.close()
        return stats, done

    (s1, d1), (s2, d2) = one_run(), one_run()
    assert d1 == d2
    assert s1.warm_ratio == s2.warm_ratio
    assert s1.requests == len(d1)


def test_reactive_loader_spec():
    srv = EdgeServer.build(sim_config(loader=LoaderSpec(prefetch=False)), device="cpu")
    try:
        assert srv.loader is None, "prefetch=False => no background loader"
    finally:
        srv.close()


def test_config_expresses_unmanaged_baseline():
    """policy="none" (the paper's no-framework baseline) must be
    declarable through the front door, not just the imperative path."""
    cfg = sim_config(policy="none", budget_mb=100.0)
    assert ServingConfig.from_dict(cfg.to_dict()) == cfg
    srv = EdgeServer.build(cfg, device="cpu")
    try:
        assert srv.manager.policy is None
        assert srv.manager.fallback is None, "baseline: no eviction power"
    finally:
        srv.close()


def test_to_dict_rejects_unregistered_policy_loudly():
    class Anonymous(Policy):
        pass

    cfg = sim_config(policy=Anonymous())
    with pytest.raises(ValueError, match="register_policy"):
        cfg.to_dict()


def test_fit_steps_plumbed_to_background_fit():
    srv = EdgeServer.build(sim_config(
        predictor=PredictorSpec(fit_steps=7)), device="cpu")
    try:
        tr = next(iter(srv.tenants.values()))
        assert tr.predictor.fit_steps == 7
        for _ in range(30):
            tr.predictor.observe(100.0)
        fut = srv.loader.submit_fit(tr.predictor)
        fut.result()
        assert tr.predictor.losses is not None
        assert len(tr.predictor.losses) == 7, "configured steps ran"
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Policy registry
# ---------------------------------------------------------------------------
def test_registry_has_paper_policies_and_plugins():
    assert {"lfe", "bfe", "ws-bfe", "iws-bfe",
            "batch-bfe", "batch-iws-bfe"} <= set(available_policies())


def test_resolve_policy_unknown_name_is_clear():
    with pytest.raises(KeyError) as ei:
        resolve_policy("wfe")
    msg = str(ei.value)
    assert "wfe" in msg and "iws-bfe" in msg, "error lists what exists"


def test_resolve_policy_accepts_instance_class_and_name():
    inst = resolve_policy("bfe")
    assert resolve_policy(inst) is inst
    assert resolve_policy(type(inst)).name == "bfe"
    with pytest.raises(TypeError):
        resolve_policy(42)


def test_register_policy_plugin_reaches_manager():
    """A user-registered policy resolves by name straight into the
    manager — policy as plugin, not manager special case."""
    @register_policy("test-always-smallest")
    class AlwaysSmallest(Policy):
        def victim_filter(self, state, app, now, *, delta, history):
            return []

        def plan_procure(self, state, app, now, *, delta, history):
            from repro_torch.core.policies import ProcurePlan
            t = state.tenants[app]
            small = t.zoo.smallest
            if state.free_mb + (t.loaded.size_mb if t.loaded else 0.0) \
                    >= small.size_mb:
                return ProcurePlan(app, small)
            return ProcurePlan(app, None)

    from repro_torch.core.model_zoo import ModelVariant, ModelZoo
    zoo = ModelZoo(app_name="a", variants=(
        ModelVariant("a-16", 16, 100.0, 99.0, 10.0),
        ModelVariant("a-8", 8, 50.0, 95.0, 5.0)))
    mgr = EdgeMultiAI({"a": zoo}, budget_mb=500.0,
                      policy="test-always-smallest", delta_ms=10.0)
    adm = mgr.admit_batch("a", now=0.0, kv_mb=1.0)
    assert not adm.failed and adm.bits == 8


def test_batch_aware_wraps_any_policy():
    ba = BatchAware("iws-bfe")
    assert ba.name == "batch-iws-bfe"
    assert ba.inner.name == "iws-bfe"
    from repro_torch.core.policies import DemandContext
    ctx = DemandContext(kv_head_mb=1.0, kv_full_mb=4.0, queue_depth=1,
                        max_batch=4)
    assert ba.demand_charge(ctx) == 4.0
    assert resolve_policy("bfe").demand_charge(ctx) == 1.0


# ---------------------------------------------------------------------------
# Background predictor fits (satellite: ROADMAP open item)
# ---------------------------------------------------------------------------
def test_background_fit_scheduled_and_hit_rate_reported():
    srv = EdgeServer.build(sim_config(
        tenants=(TenantSpec(TENANTS[0]),),
        predictor=PredictorSpec(context=4, hidden=8, min_fit_samples=6,
                                refit_interval=4)), device="cpu")
    cfg = get_config(TENANTS[0], reduced=True)
    rng = np.random.default_rng(0)
    trace = [Request(app=TENANTS[0],
                     prompt=rng.integers(0, cfg.vocab_size, 5)
                     .astype(np.int32),
                     max_new=2, arrival_ms=250.0 * i)
             for i in range(12)]
    stats = srv.engine.run_trace(trace)
    srv.close()  # drains the staging worker: scheduled fits complete
    assert stats.fits_scheduled >= 1, "fit handed to the loader worker"
    tr = srv.tenants[TENANTS[0]]
    assert tr.predictor.fits >= 1, "background fit completed"
    sstats = srv.stats()
    assert 0.0 <= sstats.prediction_hit_rate <= 1.0
    assert sstats.predictor_fits == tr.predictor.fits
    # A steady 250ms cadence: after warmup most arrivals are predicted.
    assert stats.prediction_hit_rate > 0.5


def test_fit_due_schedule():
    from repro_torch.core.predictor import SeriesPredictor
    p = SeriesPredictor(context=4, hidden=8, min_fit_samples=6,
                        refit_interval=4)
    for v in (10.0,) * 5:
        p.observe(v)
    assert not p.fit_due(), "below min_fit_samples"
    p.observe(10.0)
    assert p.fit_due()
    p.fit(steps=5)
    assert not p.fit_due(), "refit only after refit_interval new samples"
    for v in (10.0,) * 4:
        p.observe(v)
    assert p.fit_due()


# ---------------------------------------------------------------------------
# Batch-aware procurement beats head-batch planning on a burst trace
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _real_zoo(name):
    """The quantized zoo a served tenant will get — sizes come from the
    actual quantized params (seed-independent: shapes decide size), so
    budgets derived here match the built server exactly."""
        
    from repro_torch.models import transformer as T
    from repro_torch.serving import TenantRuntime
    cfg = get_config(name, reduced=True)
    params = T.init_params(cfg, 0, torch.float32, device="cpu")
    return TenantRuntime(name, cfg, params, device="cpu").zoo


def _burst_run(policy: str):
    """One cold tenant; a single queued request triggers the demand load
    and a burst fills the batch while the transfer stages."""
    name = TENANTS[0]
    cfg = get_config(name, reduced=True)
    zoo = _real_zoo(name)
    plen, max_new = 6, 4
    kv1 = kv_cache_mb(cfg, 1, plen + max_new)
    kv4 = kv_cache_mb(cfg, 4, plen + max_new)
    bf16, int8 = zoo.by_bits(16).size_mb, zoo.by_bits(8).size_mb
    budget = bf16 + (kv1 + kv4) / 2
    # Premises of the scenario: head-batch planning picks bf16 (fits
    # beside one request's cache), the full batch's cache does not fit
    # beside bf16, and int8 fits beside the full batch's cache.
    assert bf16 + kv1 <= budget < bf16 + kv4
    assert int8 + kv4 <= budget

    srv = EdgeServer.build(ServingConfig(
        tenants=(TenantSpec(name),), budget_mb=budget, policy=policy,
        batching=BatchingSpec(max_batch=4)), device="cpu")
    srv.engine._executor = stub_executor
    rng = np.random.default_rng(1)
    load_ms = zoo.largest.load_ms
    # One request at t=0 stages the demand load; three more land inside
    # the staging interval, so the admitted batch is 4 wide.
    arrivals = [0.0] + [load_ms * f for f in (0.2, 0.4, 0.6)]
    trace = [Request(app=name,
                     prompt=rng.integers(0, cfg.vocab_size, plen)
                     .astype(np.int32),
                     max_new=max_new, arrival_ms=t) for t in arrivals]
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    srv.close()
    assert stats.requests == 4
    assert all(not r.failed for r in srv.engine.results)
    return stats


def test_batch_aware_avoids_self_downgrade_thrash_under_burst():
    head = _burst_run("bfe")
    aware = _burst_run("batch-bfe")
    # Head-batch planning loads bf16 for the lone queued request, then
    # the 4-wide batch's cache forces an immediate self-downgrade — a
    # wasted large-variant transfer.  Batch-aware plans the full-batch
    # bound and lands on int8 in one transfer.
    assert head.kv_downgrades >= 1
    assert aware.kv_downgrades == 0
    assert aware.warm_ratio >= head.warm_ratio
