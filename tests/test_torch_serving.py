"""The port's serving stack against the JAX package's.

Sim executors: the same ``ServingConfig`` and trace through both packages
give equal ``ServingStats`` and audit trails (the arrival predictors are
kept on their pre-fit path, where both compute the same numpy mean).
Real executor: the port serves real requests end to end on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import EdgeServer as JServer
from repro.serving import api as japi
from repro.serving import poisson_trace as jtrace
from repro_torch.serving import EdgeServer as TServer
from repro_torch.serving import api as tapi
from repro_torch.serving import poisson_trace as ttrace

TENANTS = ("tinyllama-1.1b", "mamba2-780m", "gemma2-2b")


def _config(api, *, continuous, policy, scheduler):
    return api.ServingConfig(
        tenants=tuple(api.TenantSpec(n) for n in TENANTS),
        executor="sim", policy=policy, delta_ms=750.0,
        batching=api.BatchingSpec(max_batch=4, window_ms=50.0,
                                  continuous=continuous),
        predictor=api.PredictorSpec(min_fit_samples=10**6),
        kv_headroom_shape=(2, 12), scheduler=scheduler)


def _run(server_cls, api, trace_fn, **kw):
    srv = server_cls.build(_config(api, **kw))
    cfgs = {t.name: t.cfg for t in srv.tenants.values()}
    trace, _ = trace_fn(cfgs, requests_per_app=12, mean_iat_ms=1000.0,
                        deviation=0.3, seed=0, prompt_len=(8, 9),
                        max_new=4)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    trail = [(e.kind.value, e.t, e.app, e.detail)
             for e in srv.engine.audit_trail]
    reqs = [(r.app, r.arrival_ms, r.max_new, r.prompt.tolist())
            for r in trace]
    srv.close()
    return stats.to_dict(), trail, reqs, srv.budget_mb


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("policy", ["bfe", "iws-bfe"])
@pytest.mark.parametrize("scheduler", ["indexed", "linear"])
def test_sim_engine_matches_reference(continuous, policy, scheduler):
    kw = dict(continuous=continuous, policy=policy, scheduler=scheduler)
    j_stats, j_trail, j_reqs, j_budget = _run(JServer, japi, jtrace, **kw)
    t_stats, t_trail, t_reqs, t_budget = _run(TServer, tapi, ttrace, **kw)
    assert t_reqs == j_reqs
    assert t_budget == j_budget
    assert t_trail == j_trail
    assert t_stats == j_stats
    assert j_stats["requests"] == 3 * 12


def test_config_round_trip_matches_reference():
    cfg = _config(tapi, continuous=True, policy="iws-bfe",
                  scheduler="indexed")
    assert cfg.to_dict() == _config(
        japi, continuous=True, policy="iws-bfe",
        scheduler="indexed").to_dict()
    assert tapi.ServingConfig.from_dict(cfg.to_dict()) == cfg
    assert [f.name for f in dataclasses.fields(tapi.ServingConfig)] == \
        [f.name for f in dataclasses.fields(japi.ServingConfig)]


def test_real_server_serves_on_cpu():
    """Two contended tinyllama tenants, real prefill/decode on the CPU
    through the engine: every request served, the event invariant holds,
    and contention puts a tenant on its 8-bit variant."""
    srv = TServer.build(tapi.ServingConfig(
        tenants=(tapi.TenantSpec("a", arch="tinyllama-1.1b", seed=1),
                 tapi.TenantSpec("b", arch="tinyllama-1.1b", seed=2)),
        executor="real", kv_headroom_shape=(4, 20),
        batching=tapi.BatchingSpec(max_batch=4)), device="cpu")
    cfgs = {t.name: t.cfg for t in srv.tenants.values()}
    trace, _ = ttrace(cfgs, requests_per_app=4, mean_iat_ms=200.0, seed=3,
                      prompt_len=(4, 12), max_new=8)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    results = srv.engine.results
    srv.close()
    assert stats.requests == len(results) == 8
    assert not any(r.failed for r in results)
    assert 8 in {r.bits for r in results}
    for tr in srv.tenants.values():
        assert set(tr.host) == {16, 8}
        assert tr.host[8]["layers"]["wq"]["q"].dtype == torch.int8


def test_real_server_serves_the_three_tenant_mix_on_cpu():
    """The serving benchmark's tenants (tinyllama, mamba2, gemma2) at
    reduced size through the Batcher on the CPU: every request served,
    the event invariant holds, and each mamba2 batch's ids equal the
    port's own greedy decode of the same prompts on the variant served."""
    from repro_torch.serving import Batcher, Request
    from repro_torch.serving.server import _generate_tokens

    srv = TServer.build(tapi.ServingConfig(
        tenants=tuple(tapi.TenantSpec(n) for n in TENANTS),
        executor="real", kv_headroom_shape=(4, 20),
        batching=tapi.BatchingSpec(max_batch=4)), device="cpu")
    rng = np.random.default_rng(4)
    batcher = Batcher(max_batch=4)
    results = []
    now = 0.0
    for i in range(12):
        app = TENANTS[i % 3]
        vocab = srv.tenants[app].cfg.vocab_size
        plen = int(rng.integers(4, 13))
        batcher.submit(Request(app=app, prompt=rng.integers(
            0, vocab, plen).astype(np.int32), max_new=6, arrival_ms=now))
        now += 300.0
        if batcher.pending() >= 3 or i == 11:
            while (b := batcher.next_batch()) is not None:
                srv.predict_and_preload(now)
                results.append((b, srv.serve(b.app, b.prompts, b.max_new,
                                             now_ms=now)))
    srv.engine.check_event_invariant()
    stats = srv.stats()
    srv.close()
    assert stats.requests == sum(len(b.requests) for b, _ in results) == 12
    assert not any(r.failed for _, r in results)
    assert {b.app for b, _ in results} == set(TENANTS)
    mamba = srv.tenants["mamba2-780m"]
    for b, r in results:
        assert r.tokens.shape == (len(b.requests), 6)
        if b.app != "mamba2-780m":
            continue
        with torch.inference_mode():
            want = _generate_tokens(
                mamba.cfg, mamba.host[r.bits], torch.from_numpy(b.prompts),
                max_new=6, max_len=b.prompts.shape[1] + 6)
        np.testing.assert_array_equal(r.tokens, want.numpy())


def test_real_server_generate_shapes_on_cpu():
    srv = TServer.build(tapi.ServingConfig(
        tenants=(tapi.TenantSpec("tinyllama-1.1b"),), executor="real",
        budget_mb=64.0), device="cpu")
    prompts = np.arange(10, dtype=np.int32).reshape(2, 5)
    r = srv.serve("tinyllama-1.1b", prompts, max_new=3, now_ms=0.0)
    srv.close()
    assert not r.failed and r.tokens.shape == (2, 3)
    assert r.tokens.dtype == np.int32 and r.bits == 16


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TServer.build(tapi.ServingConfig(
            tenants=(tapi.TenantSpec("tinyllama-1.1b"),), executor="real",
            budget_mb=64.0))


@pytest.mark.parametrize("kw", [
    dict(loader=dict(sharded=True, mesh_shape=(4,))),
    dict(loader=dict(sharded=True, mesh_shape=(4,)),
         fault=dict(events=((10.0, 1, "down"),)))])
def test_unported_serving_modes_raise(kw):
    """The two serving modes the port once refused, the sharded loader
    and a chip-fault schedule on it, now serve: the same configuration
    and trace through both packages give equal stats, audit trails and
    per-device ledgers (the predictors kept pre-fit, as above)."""
    def run(server_cls, api, trace_fn):
        srv = server_cls.build(api.ServingConfig(
            tenants=(api.TenantSpec("tinyllama-1.1b"),), executor="sim",
            loader=api.LoaderSpec(**kw["loader"]),
            fault=api.FaultSpec(**kw["fault"]) if "fault" in kw else None,
            predictor=api.PredictorSpec(min_fit_samples=10**6)))
        cfgs = {t.name: t.cfg for t in srv.tenants.values()}
        trace, _ = trace_fn(cfgs, requests_per_app=12, mean_iat_ms=100.0,
                            seed=2, prompt_len=(8, 9), max_new=4)
        stats = srv.engine.run_trace(trace)
        srv.engine.check_event_invariant()
        srv.close()
        led = srv.manager.state.devices
        return (stats.to_dict(),
                [(e.kind.value, e.t, e.app, e.detail)
                 for e in srv.engine.audit_trail],
                led.budgets_mb, {a: tuple(w) for a, w in led.weights.items()})

    got = run(TServer, tapi, ttrace)
    assert got == run(JServer, japi, jtrace)
    assert got[0]["requests"] == 12
    assert got[0].get("chips_lost", 0) == ("fault" in kw)


class _CardTenant(tapi.SimTenant):
    """A sim tenant that says it serves from a card."""
    device = torch.device("cuda")


@pytest.mark.parametrize("cards,mesh,raises", [
    (4, (4,), True), (8, (2, 4), True), (1, (4,), False), (3, (4,), False),
    (4, (1,), False)])
def test_multi_card_mesh_raises_rather_than_serving_from_one_card(
        monkeypatch, cards, mesh, raises):
    """A sharded mesh that the process's cards could hold, with tenants on
    the card, needs tensor-parallel placement across the cards, which the
    port lacks: ``start`` raises naming the ROADMAP item.  With fewer
    cards than the mesh (one H100 and a (4,) mesh) placement is skipped,
    as the reference skips it, and the ledger keeps the accounts."""
    from repro_torch.configs import get_config

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    srv = TServer(budget_mb=1.0, sharded_mesh=mesh, device="cpu")
    srv.register_tenant("tinyllama-1.1b", _CardTenant(
        "tinyllama-1.1b", get_config("tinyllama-1.1b", reduced=True)))
    if raises:
        with pytest.raises(NotImplementedError, match="ROADMAP A13"):
            srv.start()
        return
    srv.start()
    assert srv.manager.state.devices.n_devices == int(np.prod(mesh))
    srv.close()


def test_sim_tenants_skip_placement_on_any_card_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    srv = TServer.build(tapi.ServingConfig(
        tenants=(tapi.TenantSpec("tinyllama-1.1b"),), executor="sim",
        loader=tapi.LoaderSpec(sharded=True, mesh_shape=(8,))))
    assert srv.manager.state.devices.n_devices == 8
    srv.close()


@pytest.mark.parametrize("arch", TENANTS)
def test_cpu_runtime_generate_builds_no_graph(arch):
    """On the CPU ``generate`` is the eager loop: equal ids, no capture, no
    replay, no pool, at each variant and two batch shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving.server import TenantRuntime, _generate_tokens

    cfg = get_config(arch, reduced=True)
    rt = TenantRuntime(arch, cfg, TT.init_params(cfg, 0, torch.float32,
                                                 device="cpu"), device="cpu")
    rng = np.random.default_rng(7)
    for bits in (16, 8):
        rt.set_variant(rt.zoo.by_bits(bits))
        for B, S, max_new in ((2, 5, 4), (3, 9, 2)):
            prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            got = rt.generate(prompts, max_new)
            with torch.inference_mode():
                want = _generate_tokens(cfg, rt.device_params,
                                        torch.from_numpy(prompts),
                                        max_new=max_new, max_len=S + max_new)
            np.testing.assert_array_equal(got, want.numpy())
    assert rt.captures == rt.replays == 0
    assert rt.pool is None and not rt._graphs


def test_cpu_runtime_batches_with_extras_stay_eager():
    """A batch with extra modality inputs (a vision stub's patch embeddings)
    runs the eager loop with them, as in the reference."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving.server import TenantRuntime, _generate_tokens

    cfg = get_config("internvl2-1b", reduced=True)
    rt = TenantRuntime("vlm", cfg, TT.init_params(cfg, 0, torch.float32,
                                                  device="cpu"), device="cpu")
    rt.set_variant(rt.zoo.by_bits(8))
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    vis = rng.standard_normal((2, cfg.num_vision_tokens,
                               cfg.d_model)).astype(np.float32)
    got = rt.generate(prompts, 4, extra={"patch_embeds": vis})
    with torch.inference_mode():
        want = _generate_tokens(
            cfg, rt.device_params, torch.from_numpy(prompts), max_new=4,
            max_len=10, extra={"patch_embeds": torch.from_numpy(vis)})
    np.testing.assert_array_equal(got, want.numpy())
    assert got.shape == (2, 4)
    assert rt.captures == rt.replays == 0 and rt.pool is None


# ---------------------------------------------------------------------------
# CUDA-graph pools charged to the memory budget (a stub runtime on the CPU)
# ---------------------------------------------------------------------------
class _PoolStub(tapi.SimTenant):
    """A sim tenant that keeps a graph pool by ``TenantRuntime``'s rules:
    a batch shape's first call eager (``est_mb`` its peak), the second a
    capture (reserve ``est_mb`` more, then true the charge up to the pool,
    which grew by ``grow_mb``; drop every graph where that does not fit),
    later calls replays; a variant change drops the pool."""

    def __init__(self, name, est_mb, grow_mb):
        from repro_torch.configs import get_config

        super().__init__(name, get_config(name, reduced=True),
                         service_ms=5.0)
        self.est_mb, self.grow_mb = est_mb, grow_mb
        self.pool_ledger = None
        self.pool_mb = 0.0
        self.seen, self.graphs = set(), set()
        self.captures = self.replays = self.eager = 0

    def set_variant(self, variant):
        super().set_variant(variant)
        self.seen.clear()
        self.graphs.clear()
        self.pool_mb = 0.0

    def _charge(self, mb):
        if not self.pool_ledger(mb):
            return False
        self.pool_mb = mb
        return True

    def execute(self, batch, extra=None):
        key = (self.loaded_bits, batch.prompts.shape, batch.max_new)
        if key in self.graphs:
            self.replays += 1
        elif key in self.seen and self._charge(self.pool_mb + self.est_mb):
            self.captures += 1
            if self._charge(self.pool_mb - self.est_mb + self.grow_mb):
                self.graphs.add(key)
            else:
                self.graphs.clear()
                self._charge(0.0)
        else:
            self.seen.add(key)
            self.eager += 1
        return super().execute(batch, extra)


def _pool_server(budget_mb, est_mb, grow_mb):
    srv = TServer(budget_mb=budget_mb, max_batch=4, device="cpu")
    for name in ("tinyllama-1.1b", "mamba2-780m"):
        srv.register_tenant(name, _PoolStub(name, est_mb, grow_mb))
    srv.sync_predictor_fits = True
    srv.start()
    return srv


def _state_mb(srv):
    st = srv.manager.state
    return st.weights_mb, st.kv_mb, st.pool_mb, st.used_mb


def test_graph_pool_is_charged_from_capture_to_eviction():
    """A batch shape's first call charges no pool, its second reserves
    the estimate and trues it up to the pool, its third replays and
    charges nothing; used_mb counts the pool, every event stays within
    budget, and an eviction through the loader returns the charge."""
    from repro_torch.core import actions as RA

    srv = _pool_server(2.0, est_mb=0.05, grow_mb=0.04)
    stub = srv.tenants["tinyllama-1.1b"]
    prompts = np.zeros((2, 6), np.int32)
    for i in range(3):
        r = srv.serve("tinyllama-1.1b", prompts, max_new=4,
                      now_ms=100.0 * i)
        assert not r.failed
        pools = [e for e in srv.engine.events if e.kind == "pool"]
        if i == 0:
            assert not pools and stub.eager == 1
        elif i == 1:
            assert stub.captures == 1
            assert [round(e.kv_mb, 9) for e in pools] == [0.05, -0.01]
            assert pools[0].pool_mb == pytest.approx(0.05)
        else:
            assert stub.replays == 1 and len(pools) == 2
    weights, kv, pool, used = _state_mb(srv)
    assert kv == 0.0 and pool == pytest.approx(0.04) == stub.pool_mb
    assert used == pytest.approx(weights + 0.04)
    assert srv.manager.state.tenants["tinyllama-1.1b"].pool_mb == \
        pytest.approx(0.04)
    srv.engine.check_event_invariant()
    srv.loader.execute(RA.ResidencyPlan((RA.Unload("tinyllama-1.1b"),)),
                       400.0)
    srv.close()  # the staging worker drops the stub's graphs
    weights_after, _, pool_after, used_after = _state_mb(srv)
    assert pool_after == 0.0 and stub.pool_mb == 0.0 and not stub.graphs
    assert used_after == pytest.approx(weights_after)
    assert weights_after < weights


def test_graph_pool_that_does_not_fit_leaves_the_batch_eager():
    """An estimate the free budget cannot take captures nothing; a pool
    that outgrows its reservation past the budget is dropped.  Neither
    ever shows an event over budget."""
    srv = _pool_server(2.0, est_mb=50.0, grow_mb=0.01)
    stub = srv.tenants["tinyllama-1.1b"]
    prompts = np.zeros((1, 5), np.int32)
    for i in range(3):
        srv.serve("tinyllama-1.1b", prompts, max_new=2, now_ms=50.0 * i)
    assert stub.captures == 0 and stub.eager == 3
    assert not [e for e in srv.engine.events if e.kind == "pool"]
    srv.close()
    srv = _pool_server(2.0, est_mb=0.01, grow_mb=50.0)
    stub = srv.tenants["tinyllama-1.1b"]
    for i in range(3):
        srv.serve("tinyllama-1.1b", prompts, max_new=2, now_ms=50.0 * i)
    assert stub.captures == 2 and not stub.graphs and stub.pool_mb == 0.0
    assert srv.manager.state.pool_mb == 0.0
    srv.engine.check_event_invariant()
    srv.close()


@pytest.mark.parametrize("budget_mb", [0.6, 1.0, 3.0])
def test_graph_pools_keep_every_event_within_budget(budget_mb):
    """A Poisson trace over two stub tenants whose captures grow their
    pools: contention, evictions and upgrades around the charges, and
    the budget holds at every event with the pools counted."""
    srv = _pool_server(budget_mb, est_mb=0.03, grow_mb=0.035)
    cfgs = {n: t.cfg for n, t in srv.tenants.items()}
    trace, _ = ttrace(cfgs, requests_per_app=24, mean_iat_ms=150.0,
                      seed=5, prompt_len=(4, 6), max_new=4)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    srv.close()
    assert stats.requests == 48
    events = srv.engine.events
    assert any(e.kind == "pool" for e in events)
    assert all(e.used_mb + e.inflight_mb <= budget_mb + 1e-6
               for e in events)
    assert any(e.pool_mb > 0 for e in events)


# ---------------------------------------------------------------------------
# A demoted variant's pool and its repromotion (phase 9 of chip_smoke.py)
# ---------------------------------------------------------------------------
# The graph pools the card measured (PERF.md section 5, PR 19): MB by
# tenant and bits, each variant's first captured key.
PHASE9_POOLS = {"tinyllama-1.1b": {8: 528.0, 16: 6.0},
                "mamba2-780m": {8: 334.0, 16: 334.0}}
_SIM = tapi.SimTenant


class _VariantPoolStub(_PoolStub):
    """A stub runtime whose loaded variant keeps the pool the card's
    captures of that variant kept: its first batch on a variant charges
    the pool (when the budget takes it; else it runs eagerly and tries
    again at the next); a variant change drops it, and a staged load of
    another variant drops it at once (``hold_graphs``), the tenant then
    running eagerly until the load commits or is cancelled."""

    def __init__(self, name, cfg, precisions=(16, 8), predictor=None,
                 service_ms=None):
        _SIM.__init__(self, name, cfg, precisions=precisions,
                      predictor=predictor, service_ms=service_ms)
        self.pool_ledger = None
        self.pool_mb = 0.0
        self.seen, self.graphs = set(), set()
        self.captures = self.replays = self.eager = 0
        self.held = False

    def hold_graphs(self, hold):
        self.held = hold
        if hold:
            self.graphs.clear()
            self.pool_mb = 0.0

    def execute(self, batch, extra=None):
        if self.graphs:
            self.replays += 1
        elif not self.held and self._charge(
                PHASE9_POOLS[self.name][self.loaded_bits]):
            self.graphs.add(self.loaded_bits)
            self.captures += 1
        else:
            self.eager += 1
        return _SIM.execute(self, batch, extra)


def _phase9(api, server_cls, budget_mb, stub=None):
    """``chip_smoke.py``'s phase 9 plan in sim time: the serving
    benchmark's elastic A/B configuration (faulted), its two tenants at
    full width, 30 Poisson requests a tenant (seed 7)."""
    config = api.ServingConfig(
        tenants=tuple(api.TenantSpec(a, reduced=False)
                      for a in ("tinyllama-1.1b", "mamba2-780m")),
        executor="sim", policy="iws-bfe", delta_ms=750.0,
        batching=api.BatchingSpec(max_batch=4, window_ms=20.0),
        loader=api.LoaderSpec(sharded=True, mesh_shape=(4,)),
        predictor=api.PredictorSpec(min_fit_samples=10**6),
        kv_headroom_shape=(2, 12), budget_mb=budget_mb,
        fault=api.FaultSpec(events=((3000.0, 3, "down"),
                                    (9000.0, 3, "up"))))
    if stub is not None:
        sim, api.SimTenant = api.SimTenant, stub
    try:
        srv = server_cls.build(config)
    finally:
        if stub is not None:
            api.SimTenant = sim
    cfgs = {t.name: t.cfg for t in srv.tenants.values()}
    trace, _ = (jtrace if api is japi else ttrace)(
        cfgs, requests_per_app=30, mean_iat_ms=400.0, seed=7)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    srv.close()
    return srv, stats


def test_demoted_pool_does_not_block_its_repromotion():
    """Phase 9's plan in sim time with stub pools of the card's sizes, at
    the sim's derived budget + 10% (3456.8 MB; sim zoo sizes come from
    parameter math, and the card's derived budget is 3454.0 MB): the drain
    of chip 3 downgrades tinyllama to 8 bits, whose first batch there
    charges a 528 MB pool; at chip_up the repromotion's staged 16-bit
    load drops that pool with the ledger's charge (the runtime eager
    until the commit), so its claim fits and 16 bits come back.  Before,
    the pool stayed charged until the commit, the claim did not fit, and
    tinyllama stayed at 8 bits (as on the card at + 5% in PR 20).  With
    pools out of the way, the port's trail (pool events aside) equals
    the reference's sim trail at the same budget."""
    derived = _phase9(japi, JServer, None)[0].budget_mb
    budget = derived * 1.10
    srv, stats = _phase9(tapi, TServer, budget, stub=_VariantPoolStub)
    ctl = srv.elastic
    stub = srv.tenants["tinyllama-1.1b"]
    assert ctl.drain_downgrades >= 1 and ctl.repromotions >= 1
    assert stub.captures >= 2 and not stub.held
    assert stats.chips_lost == stats.chips_recovered == 1
    pools = [e for e in srv.engine.events if e.kind == "pool"]
    assert pools and any(e.pool_mb >= 528.0 for e in pools)
    assert all(e.used_mb + e.inflight_mb <= budget + 1e-6
               for e in srv.engine.events)
    jsrv, jstats = _phase9(japi, JServer, budget)
    assert jsrv.elastic.repromotions == ctl.repromotions
    # MB to 1e-9: the pools' charges and refunds pass through the same
    # float sums, which then round in the last bits.
    trail = [(e.kind.value, e.t, e.app, round(e.detail, 9))
             for e in srv.engine.audit_trail if e.kind.value != "pool"]
    assert trail == [(e.kind.value, e.t, e.app, round(e.detail, 9))
                     for e in jsrv.engine.audit_trail]
