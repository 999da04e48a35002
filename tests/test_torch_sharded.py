"""The port's sharding rules, sharded loader, cross-device migration and
wire compression against the JAX package's.

Ports ``test_sharded_loader``, the serving layout's part of
``test_sharding`` (the training specs are ``test_torch_sharding.py``'s),
``test_migration`` and
``test_wire_compression``.  Each scenario runs once on the reference and
once on the port, in this process, on the same synthetic zoos or sim
config: the reference test's own assertions hold on both, and what each
run observes (claims, schedules, records, audit trails, stats) must be
equal exactly.  The reference's two real-placement tests (8 fake CPU
devices) have no counterpart: the port places no shards across cards
(``tests/test_torch_serving.py`` holds it to raising instead).
"""
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro.quant import quantize as JQ
from repro_torch.distributed import sharding as TSH

N_DEV = 4
MESHES = ((1,), (2,), (4,), (8,), (2, 4))


def _pkg(name):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")

    return SimpleNamespace(
        name=name, A=mod("core.actions"), core=mod("core"),
        ms=mod("core.memory_state"), mz=mod("core.model_zoo"),
        SH=mod("distributed.sharding"), serving=mod("serving"),
        api=mod("serving.api"), loader=mod("serving.loader"),
        SL=mod("serving.sharded_loader"), configs=mod("configs"),
        comp=mod("distributed.compression"))


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


def make_manager(M, budget_mb=1000.0, device_budget_mb=None, budgets=None,
                 migrate=True, devices=True, **zoos):
    zoos = zoos or {"a": _zoo(M, "a", [500, 300]),
                    "b": _zoo(M, "b", [400, 200])}
    mgr = M.core.EdgeMultiAI(zoos, budget_mb=budget_mb, policy="iws-bfe",
                             delta_ms=10.0, migrate=migrate)
    if devices:
        per_dev = (budget_mb / N_DEV if device_budget_mb is None
                   else device_budget_mb)
        mgr.state.devices = M.ms.DeviceLedger(
            tuple(budgets) if budgets else (per_dev,) * N_DEV,
            split_fn=lambda app, v: M.SH.variant_shard_mb(v.size_mb, N_DEV))
    return mgr


def _ledger(led):
    return ({a: tuple(w) for a, w in led.weights.items()},
            {a: tuple(c) for a, c in led.inflight.items()},
            led.shards_migrated)


def _rec(r):
    return (r.app, r.bits, r.load_ms, r.t_enqueue_ms, r.t_ready_ms,
            r.demand, r.shard_intervals, r.partial)


# ---------------------------------------------------------------------------
# Sharding rules (the logical part of test_sharding)
# ---------------------------------------------------------------------------
class FakeMesh:
    """Duck-typed mesh: shape mapping + axis names (specs are pure)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_leaf_specs_match_param_specs(arch):
    """Every leaf's partition, plain and quantized, at full width, equals
    the reference's ``param_specs`` (the serving layout, ``fsdp=False``)
    on a 16 x 16 mesh and on the serving meshes; every sharded dimension
    divides, and no axis appears twice."""
    from repro.configs import get_config

    cfg = get_config(arch)
    plain = JT.abstract_params(cfg, jnp.bfloat16)
    quant = jax.eval_shape(
        lambda p: JQ.quantize_params(p, bits=8, group=32),
        JT.abstract_params(cfg, jnp.float32))
    meshes = [FakeMesh({"data": 16, "model": 16})] + [
        FakeMesh({"data": 1, **TSH.serving_mesh(s).shape}) for s in MESHES]
    for mesh in meshes:
        for tree in (plain, quant):
            specs = JSH.param_specs(cfg, tree, mesh, fsdp=False)
            leaves = jax.tree_util.tree_leaves_with_path(tree)
            want = jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))
            for (path, leaf), spec in zip(leaves, want):
                got = TSH.leaf_spec(JSH._path_str(path), leaf.shape, mesh)
                want_t = tuple(spec) + (None,) * (len(leaf.shape)
                                                  - len(spec))
                assert got == want_t, (arch, JSH._path_str(path))
                axes = [e for e in got if e is not None]
                assert len(axes) == len(set(axes))
                for dim, e in zip(leaf.shape, got):
                    assert e is None or dim % mesh.shape[e] == 0


def test_expert_weights_sharded_on_expert_dim():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT

    mesh = FakeMesh({"data": 16, "model": 16})
    for arch in ("llama4-scout-17b-a16e", "olmoe-1b-7b"):
        params = TT.init_params(get_config(arch), 0, torch.bfloat16,
                                device="meta")
        spec = TSH.leaf_spec("layers/we_g", params["layers"]["we_g"].shape,
                             mesh)
        assert spec[1] == "model", (arch, spec)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_weight_shard_fraction_equals_reference(arch, reduced):
    """Bit for bit, on every serving mesh: the fraction sets per-device
    budgets, and a last-bit difference would move a sim trail."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    for shape in MESHES:
        got = TSH.weight_shard_fraction(tget(arch, reduced=reduced),
                                        TSH.serving_mesh(shape))
        want = JSH.weight_shard_fraction(jget(arch, reduced=reduced),
                                         JSH.serving_mesh(shape))
        assert got == want, (arch, reduced, shape)
        assert got >= 1.0 / TSH.serving_mesh(shape).size


def test_logical_mesh_and_variant_shards():
    def run(M):
        mesh = M.SH.serving_mesh((2, 4))
        with pytest.raises(ValueError):
            M.SH.serving_mesh((2, 2, 2))
        with pytest.raises(ValueError):
            M.SH.LogicalMesh({"model": 0})
        return (mesh.shape, mesh.axis_names, mesh.size,
                M.SH.serving_mesh((8,)).shape,
                M.SH.variant_shard_mb(100.0, 4),
                M.SH.variant_shard_mb(100.0, 4, 0.3))

    both(run)


# ---------------------------------------------------------------------------
# Per-shard schedule + claim lifecycle (test_sharded_loader)
# ---------------------------------------------------------------------------
def _enqueue_and_tile(M):
    mgr = make_manager(M)
    loader = M.SL.ShardedLoaderChannel(mgr, n_devices=N_DEV)
    ld = loader.enqueue(mgr.plan_demand("a", 0.0), now_ms=0.0, demand=True)
    assert ld is not None and ld.charge_mb == 500.0
    st, led = mgr.state, mgr.state.devices
    obs = [st.inflight_mb, _ledger(led),
           [(s.load_ms, s.t_start_ms, s.ready_ms, s.global_mb, s.claim_mb)
            for s in ld.shards], ld.ready_ms, loader.earliest_ready()]
    assert led.inflight["a"] == pytest.approx([125.0] * N_DEV)
    assert [s.load_ms for s in ld.shards] == pytest.approx([250.0] * N_DEV)
    assert ld.ready_ms == pytest.approx(1000.0)
    assert loader.reap(250.0) == []
    assert ld.shards[0].landed and not ld.shards[1].landed
    assert loader.reap(510.0) == []
    obs.append(loader.shards_landed)
    recs = loader.reap(1000.0)
    assert [r.app for r in recs] == ["a"]
    assert st.inflight_mb == 0.0 and led.inflight == {}
    assert st.tenants["a"].loaded.size_mb == 500.0
    obs += [[_rec(r) for r in recs], _ledger(led)]
    loader.close()
    return obs


def test_enqueue_claims_whole_load_and_shards_tile_the_transfer():
    both(_enqueue_and_tile)


def _cancel_in_device_order(M):
    mgr = make_manager(M)
    loader = M.SL.ShardedLoaderChannel(mgr, n_devices=N_DEV)
    loader.enqueue(mgr.plan_proactive("a", 0.0), 0.0, predicted_ms=900.0)
    led = mgr.state.devices
    order = []
    orig = led.release_inflight_shard

    def spy(app, device, mb):
        order.append((device, mb))
        orig(app, device, mb)

    led.release_inflight_shard = spy
    loader.reap(600.0)
    assert loader.shards_landed == 2
    assert loader.cancel("a", 600.0) is not None
    assert [d for d, _ in order] == list(range(N_DEV))
    assert mgr.state.inflight_mb == 0.0 and led.inflight == {}
    recs = loader.reap(600.0)
    assert len(recs) == 1 and recs[0].partial
    assert recs[0].load_ms == pytest.approx(500.0)
    assert loader.loads_committed == 0
    loader.close()
    return order, [_rec(r) for r in recs]


def test_cancel_releases_shard_claims_in_device_order():
    both(_cancel_in_device_order)


def _shard_does_not_fit(M):
    mgr = make_manager(M, device_budget_mb=100.0)
    loader = M.SL.ShardedLoaderChannel(mgr, n_devices=N_DEV)
    plan = mgr.plan_demand("a", 0.0)
    assert plan is not None and plan.variant.size_mb == 500.0
    assert loader.enqueue(plan, 0.0, demand=True) is None
    assert mgr.state.inflight_mb == 0.0
    assert mgr.state.devices.inflight == {}
    assert "a" not in loader.inflight
    loader.close()
    return _ledger(mgr.state.devices)


def test_shard_that_does_not_fit_fails_whole_load_cleanly():
    both(_shard_does_not_fit)


def _shrink(M):
    mgr = make_manager(M)
    loader = M.SL.ShardedLoaderChannel(mgr, n_devices=N_DEV)
    loader.enqueue(mgr.plan_proactive("a", 0.0), 0.0, predicted_ms=2000.0)
    loader.reap(300.0)
    small = mgr.state.tenants["a"].zoo.smallest
    ld = loader.shrink_inflight("a", small, 300.0)
    assert ld is not None and ld.variant is small
    assert mgr.state.inflight_mb == pytest.approx(300.0)
    assert loader.prefetch_shrunk == 1
    obs = [_ledger(mgr.state.devices), ld.shards[-1].ready_ms]
    recs = loader.reap(900.0)
    kinds = [(r.partial, r.bits) for r in recs]
    assert (True, 32) in kinds and (False, small.bits) in kinds
    assert mgr.state.tenants["a"].loaded is small
    assert mgr.state.inflight_mb == 0.0
    loader.close()
    return obs + [[_rec(r) for r in recs]]


def test_sharded_shrink_restages_smaller_shards():
    both(_shrink)


def _shrink_race(M):
    mgr = make_manager(M)
    loader = M.SL.ShardedLoaderChannel(mgr, n_devices=N_DEV)
    old = loader.enqueue(mgr.plan_proactive("a", 0.0), 0.0,
                         predicted_ms=2000.0)
    small = mgr.state.tenants["a"].zoo.smallest
    new = loader.shrink_inflight("a", small, 100.0)
    assert new is not None and new is not old
    assert old.state == "cancelled" and new.staging
    st, led = mgr.state, mgr.state.devices
    before = _ledger(led)
    assert loader._retire_load(old) is False
    assert st.inflight_mb == pytest.approx(300.0)
    assert _ledger(led) == before
    assert loader.cancel("a", 200.0) is not None
    assert loader.cancel("a", 200.0) is None
    assert st.inflight_mb == 0.0 and led.inflight == {}
    assert loader.prefetch_wasted == 1
    loader.close()
    return before


def test_shrink_mid_release_cannot_double_release_claims():
    both(_shrink_race)


# ---------------------------------------------------------------------------
# Engine integration: downgrade path, invariant, determinism
# ---------------------------------------------------------------------------
def _sim_server(M, device_budget_mb, names=("tinyllama-1.1b",)):
    srv = M.serving.EdgeServer(budget_mb=0.0, policy="iws-bfe",
                               delta_ms=1000.0, sharded_mesh=(N_DEV,),
                               device_budget_mb=device_budget_mb)
    for name in names:
        cfg = M.configs.get_config(name, reduced=True)
        srv.register_tenant(name, M.api.SimTenant(name, cfg))
    srv.budget_mb = srv.contention_budget(0.05)
    srv.start()
    return srv


def _events(srv):
    return [(e.t_ms, str(e.kind), e.app, e.kv_mb, e.used_mb, e.device_mb,
             e.device_budget_mb) for e in srv.engine.events]


def _shards(M, app="tinyllama-1.1b"):
    cfg = M.configs.get_config(app, reduced=True)
    zoo = M.mz.zoo_from_config(cfg, precisions=(16, 8))
    frac = M.SH.weight_shard_fraction(cfg, M.SH.serving_mesh((N_DEV,)))
    return zoo.by_bits(8).size_mb * frac, zoo.by_bits(16).size_mb * frac


def _one_batch(M, srv, app="tinyllama-1.1b"):
    prompts = np.zeros((1, 4), np.int32)
    reqs = [M.serving.Request(app=app, prompt=prompts[0], max_new=2,
                              arrival_ms=0.0)]
    return srv.engine.execute_batch(M.serving.Batch(app, reqs, prompts, 2),
                                    now_ms=0.0)


def _device_pressure(M):
    app = "tinyllama-1.1b"
    shard8, shard16 = _shards(M)
    assert shard8 < shard16
    srv = _sim_server(M, device_budget_mb=(shard8 + shard16) / 2)
    plan = srv.manager.plan_demand(app, 0.0)
    assert plan is not None and plan.variant.bits == 16
    assert srv.loader.enqueue(plan, 0.0, demand=True) is None
    results, _, toks = _one_batch(M, srv)
    assert toks is not None and not results[0].failed
    assert results[0].bits == 8
    led = srv.manager.state.devices
    led.check_invariant()
    assert led.weights[app] == pytest.approx([shard8] * N_DEV)
    srv.engine.check_event_invariant()
    srv.close()
    return _events(srv), _ledger(led)


def test_device_pressure_feeds_admission_downgrade_path():
    both(_device_pressure)


def _unfittable(M):
    shard8, _ = _shards(M)
    srv = _sim_server(M, device_budget_mb=shard8 * 0.5)
    results, _, toks = _one_batch(M, srv)
    assert toks is None and results[0].failed
    assert srv.engine.weight_failures == 1
    assert srv.engine.kv_rejections == 0
    assert srv.manager.state.tenants["tinyllama-1.1b"].loaded is None
    srv.manager.state.devices.check_invariant()
    srv.engine.check_event_invariant()
    srv.close()
    return _events(srv)


def test_unfittable_smallest_shard_rejects_batch_cleanly():
    both(_unfittable)


def _in_flight_run(M):
    srv = _sim_server(M, device_budget_mb=None,
                      names=("tinyllama-1.1b", "mamba2-780m"))
    cfgs = {n: t.cfg for n, t in srv.tenants.items()}
    trace, _ = M.serving.poisson_trace(cfgs, requests_per_app=15,
                                       mean_iat_ms=300.0, seed=3)
    stats = srv.engine.run_trace(trace)
    assert stats.requests == len(trace)
    srv.engine.check_event_invariant()
    assert any(e.device_mb is not None for e in srv.engine.events)
    assert srv.manager.state.inflight_mb == 0.0
    assert srv.manager.state.devices.inflight == {}
    srv.close()
    return _events(srv), stats.to_dict()


def test_event_invariant_holds_with_sharded_loads_in_flight():
    """The predictors never reach their fit threshold on this trace, so
    every stat, the prediction hit rate included, is equal."""
    both(_in_flight_run)


def _deterministic_run(M, **predictor):
    api = M.api
    srv = api.EdgeServer.build(api.ServingConfig(
        tenants=(api.TenantSpec("tinyllama-1.1b"),
                 api.TenantSpec("mamba2-780m")),
        policy="iws-bfe", delta_ms=750.0,
        batching=api.BatchingSpec(max_batch=4, window_ms=20.0),
        loader=api.LoaderSpec(sharded=True, mesh_shape=(N_DEV,)),
        predictor=api.PredictorSpec(**predictor),
        executor="sim", kv_headroom_shape=(2, 12)))
    cfgs = {t.name: t.cfg for t in srv.tenants.values()}
    trace, _ = M.serving.poisson_trace(cfgs, requests_per_app=20,
                                       mean_iat_ms=400.0, seed=0)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    base = min(r.rid for r in srv.engine.results)
    results = [(r.rid - base, r.app, r.arrival_ms, r.start_ms, r.done_ms,
                r.warm, r.failed, r.bits) for r in srv.engine.results]
    trail = [(e.kind.value, e.t, e.app, e.detail)
             for e in srv.engine.audit_trail]
    srv.close()
    return stats, results, trail


def test_sharded_sim_run_is_bit_deterministic():
    """Two port runs agree bit for bit, and with the reference's: audit
    trail, results and every stat.  The predictors are held on their
    pre-fit path, where both packages compute the same numpy mean (a
    fitted RNN starts from each package's own initializer)."""
    kw = dict(min_fit_samples=10**6)
    s1, r1, t1 = _deterministic_run(PORT, **kw)
    s2, r2, t2 = _deterministic_run(PORT, **kw)
    assert (r1, t1, s1) == (r2, t2, s2)
    assert s1.shards_landed > 0 and s1.shards_landed % N_DEV == 0
    js, jr, jt = _deterministic_run(REF, **kw)
    assert (r1, t1, s1.to_dict()) == (jr, jt, js.to_dict())


def test_loader_spec_round_trip_and_validation():
    def run(M):
        api = M.api
        spec = api.LoaderSpec(sharded=True, mesh_shape=[2, 4])
        assert spec.mesh_shape == (2, 4)
        cfg = api.ServingConfig(tenants=(api.TenantSpec("tinyllama-1.1b"),),
                                loader=spec, executor="sim")
        assert api.ServingConfig.from_dict(cfg.to_dict()).loader == spec
        with pytest.raises(ValueError):
            api.LoaderSpec(sharded=True, prefetch=False)
        with pytest.raises(ValueError):
            api.LoaderSpec(sharded=True, mesh_shape=(2, 2, 2))
        return cfg.to_dict()

    both(run)


def test_sharded_server_refuses_the_reactive_engine():
    def run(M):
        srv = M.serving.EdgeServer(budget_mb=1.0, prefetch=False,
                                   sharded_mesh=(N_DEV,))
        srv.register_tenant("tinyllama-1.1b", M.api.SimTenant(
            "tinyllama-1.1b",
            M.configs.get_config("tinyllama-1.1b", reduced=True)))
        with pytest.raises(ValueError, match="prefetch=True"):
            srv.start()
        srv = M.serving.EdgeServer(budget_mb=1.0, sharded_mesh=(N_DEV,),
                                   device_budget_mb=(1.0, 1.0))
        srv.register_tenant("tinyllama-1.1b", M.api.SimTenant(
            "tinyllama-1.1b",
            M.configs.get_config("tinyllama-1.1b", reduced=True)))
        with pytest.raises(ValueError, match="2 device budgets"):
            srv.start()
        return True

    both(run)


# ---------------------------------------------------------------------------
# Cross-device migration (test_migration)
# ---------------------------------------------------------------------------
def _mig_manager(M, budgets, migrate=True):
    return make_manager(M, budget_mb=2000.0, budgets=budgets,
                        migrate=migrate)


def _plan_migration(M):
    A = M.A
    mgr = _mig_manager(M, (150.0, 400.0, 400.0, 400.0))
    st = mgr.state
    st.apply(A.plan_of(A.Load("b", st.tenants["b"].zoo.largest)))
    claims = (125.0,) * N_DEV
    assert not st.devices.fits(claims)
    moves = A.plan_migration(st, "a", claims)
    assert moves is not None and len(moves) == 1
    mv = moves[0]
    assert mv.app == "b" and mv.src == 0 and mv.dst != 0
    plan = A.ResidencyPlan(moves + (
        A.Load("a", st.tenants["a"].zoo.largest, staged=True,
               claim_mb=500.0, shard_claims=claims),))
    assert st.simulate(plan) is None
    st.apply(plan)
    st.devices.check_invariant()
    assert st.devices.weights["b"][0] == 0.0
    return [(m.app, m.src, m.dst, m.mb) for m in moves], _ledger(st.devices)


def test_plan_migration_moves_victim_shard_off_the_tight_chip():
    both(_plan_migration)


def _migration_frozen(M):
    A = M.A
    mgr = _mig_manager(M, (150.0, 400.0, 400.0, 400.0))
    st = mgr.state
    st.apply(A.plan_of(A.Load("b", st.tenants["b"].zoo.largest)))
    st.tenants["b"].inflight_mb = 1.0
    assert A.plan_migration(st, "a", (125.0,) * N_DEV) is None
    st.tenants["b"].inflight_mb = 0.0
    mgr2 = _mig_manager(M, (150.0,) * N_DEV)
    st2 = mgr2.state
    st2.apply(A.plan_of(A.Load("b", st2.tenants["b"].zoo.largest)))
    assert A.plan_migration(st2, "a", (125.0,) * N_DEV) is None
    return _ledger(st.devices), _ledger(st2.devices)


def test_plan_migration_respects_frozen_tenants_and_gives_up_cleanly():
    both(_migration_frozen)


def _downgrade_migrated(M):
    A = M.A
    mgr = _mig_manager(M, (150.0, 400.0, 400.0, 400.0))
    st = mgr.state
    za, zb = st.tenants["a"].zoo, st.tenants["b"].zoo
    st.apply(A.plan_of(A.Load("b", zb.largest)))
    claims = (125.0,) * N_DEV
    moves = A.plan_migration(st, "a", claims)
    st.apply(A.ResidencyPlan(moves + (
        A.Load("a", za.largest, staged=True, claim_mb=500.0,
               shard_claims=claims),)))
    st.apply(A.plan_of(A.Load("a", za.largest, claim_mb=500.0,
                              shard_claims=claims)))
    st.apply(A.plan_of(A.Downgrade("b", zb.smallest)))
    assert st.devices.weights["b"][0] == 0.0
    assert sum(st.devices.weights["b"]) == pytest.approx(200.0)
    st.devices.check_invariant()
    act = A.staged_load_action(st, "b", zb.largest)
    assert act.shard_claims[0] == 0.0
    st.apply(A.plan_of(act))
    st.apply(A.plan_of(A.Load("b", zb.largest, claim_mb=act.claim_mb,
                              shard_claims=act.shard_claims)))
    assert st.devices.weights["b"][0] == 0.0
    st.devices.check_invariant()
    return act.shard_claims, _ledger(st.devices)


def test_downgrading_migrated_victim_keeps_layout_and_budgets():
    both(_downgrade_migrated)


def _migrate_validates(M):
    A = M.A
    mgr = _mig_manager(M, (150.0, 110.0, 400.0, 400.0))
    st = mgr.state
    st.apply(A.plan_of(A.Load("b", st.tenants["b"].zoo.largest)))
    before = _ledger(st.devices)
    with pytest.raises(A.PlanError):
        st.apply(A.plan_of(A.MigrateShard("b", 0, 2, 150.0)))
    with pytest.raises(A.PlanError):
        st.apply(A.plan_of(A.MigrateShard("b", 0, 1, 100.0)))
    assert _ledger(st.devices) == before
    return before


def test_migrate_shard_validates_source_and_destination():
    both(_migrate_validates)


def _blocked(M, migrate):
    A = M.A
    mgr = _mig_manager(M, (150.0, 400.0, 400.0, 400.0), migrate=migrate)
    st = mgr.state
    st.apply(A.plan_of(A.Load("b", st.tenants["b"].zoo.largest)))
    return mgr, M.SL.ShardedLoaderChannel(mgr, n_devices=N_DEV,
                                          migrate=migrate)


def _blocked_migrates(M):
    mgr, loader = _blocked(M, True)
    st = mgr.state
    ld = loader.enqueue(mgr.plan_demand("a", 0.0), 0.0, demand=True)
    assert ld is not None
    assert st.devices.shards_migrated == 1
    assert st.devices.weights["b"][0] == 0.0
    assert st.inflight_mb == 500.0
    obs = [_ledger(st.devices)]
    loader.reap(ld.ready_ms)
    assert st.tenants["a"].loaded.size_mb == 500.0
    assert st.inflight_mb == 0.0 and st.devices.inflight == {}
    st.devices.check_invariant()
    loader.close()
    return obs + [_ledger(st.devices)]


def test_blocked_load_migrates_victim_and_lands():
    both(_blocked_migrates)


def _blocked_fails(M):
    mgr, loader = _blocked(M, False)
    st = mgr.state
    assert loader.enqueue(mgr.plan_demand("a", 0.0), 0.0,
                          demand=True) is None
    assert st.inflight_mb == 0.0 and st.devices.inflight == {}
    assert st.devices.shards_migrated == 0
    loader.close()
    return _ledger(st.devices)


def test_blocked_load_without_migration_fails_cleanly_as_before():
    both(_blocked_fails)


def _migrate_event(M):
    mgr, loader = _blocked(M, True)
    events = []
    loader.on_event = lambda t, kind, app, mb: events.append(
        (t, kind, app, mb))
    assert loader.enqueue(mgr.plan_demand("a", 0.0), 0.0) is not None
    assert ("migrate", "b") in [(k, a) for _, k, a, _ in events]
    loader.close()
    return events


def test_loader_emits_migrate_event():
    both(_migrate_event)


def _admission_migration(M):
    A = M.A
    out = []
    for migrate, want_bits, want_moves in ((True, 32, 1), (False, 16, 0)):
        mgr = _mig_manager(M, (200.0, 500.0, 500.0, 500.0), migrate)
        migrations = []
        mgr.on_migrate = lambda t, app, mb: migrations.append((t, app, mb))
        st = mgr.state
        st.apply(A.plan_of(A.Load("b", st.tenants["b"].zoo.largest)))
        adm = mgr.admit_batch("a", now=7.0, kv_mb=0.0)
        assert not adm.failed and adm.bits == want_bits
        assert adm.self_downgraded == (not migrate)
        assert st.devices.shards_migrated == want_moves
        assert migrations == ([(7.0, "b", 100.0)] if migrate else [])
        st.devices.check_invariant()
        out.append((adm.bits, migrations, _ledger(st.devices)))
    return out


def test_admission_migration_vs_downgrade_only():
    both(_admission_migration)


def _skewed_budgets(M, names, tight=0.7, roomy=3.0):
    mesh = M.SH.serving_mesh((N_DEV,))
    shard8 = shard16 = 0.0
    for name in names:
        cfg = M.configs.get_config(name, reduced=True)
        zoo = M.mz.zoo_from_config(cfg, precisions=(16, 8))
        frac = M.SH.weight_shard_fraction(cfg, mesh)
        shard8 += zoo.by_bits(8).size_mb * frac
        shard16 += zoo.by_bits(16).size_mb * frac
    tight_mb = shard8 + tight * (shard16 - shard8)
    return (tight_mb,) + (roomy * shard16,) * (N_DEV - 1)


def _skewed_run(M, migrate, names=("tinyllama-1.1b", "mamba2-780m")):
    srv = M.serving.EdgeServer(
        budget_mb=0.0, policy="iws-bfe", delta_ms=750.0, max_batch=4,
        sharded_mesh=(N_DEV,), device_budget_mb=_skewed_budgets(M, names),
        migrate=migrate)
    for name in names:
        srv.register_tenant(name, M.api.SimTenant(
            name, M.configs.get_config(name, reduced=True)))
    srv.budget_mb = srv.contention_budget(0.05)
    srv.start()
    cfgs = {n: t.cfg for n, t in srv.tenants.items()}
    trace, _ = M.serving.poisson_trace(cfgs, requests_per_app=15,
                                       mean_iat_ms=400.0, seed=0)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    trail = [(e.kind.value, e.t, e.app, e.detail)
             for e in srv.engine.audit_trail]
    srv.close()
    return stats.to_dict(), trail


@pytest.mark.parametrize("migrate", [True, False])
def test_migration_preserves_per_event_device_invariant(migrate):
    """The skewed-mesh run (its per-event per-chip invariant checked
    inside) equals the reference's, with migration on and off; migration
    admits the staged loads the tight chip blocks without it."""
    stats, _ = both(_skewed_run, migrate)
    if migrate:
        assert stats["shards_migrated"] > 0
        assert stats["prefetch_hits"] > 0
    else:
        assert stats["shards_migrated"] == 0
        assert stats["prefetch_hits"] == 0


def test_migrating_sim_run_is_bit_deterministic():
    assert _skewed_run(PORT, True) == _skewed_run(PORT, True)


# ---------------------------------------------------------------------------
# Quantize-on-the-wire staging (test_wire_compression)
# ---------------------------------------------------------------------------
def test_wire_compression_ratio_values():
    def run(M):
        r = M.comp.wire_compression_ratio
        assert r(32) == pytest.approx(1.125 / 4)
        assert r(16) == pytest.approx(0.5625)
        assert r(8) == 1.0 and r(4) == 1.0
        assert r(16, group=128) < r(16, group=32)
        with pytest.raises(ValueError):
            r(16, scheme="gzip")
        return [r(b, group=g) for b in (32, 16, 8, 4) for g in (32, 128)]

    both(run)


def test_loader_compress_validation():
    def run(M):
        mgr = make_manager(M, devices=False)
        with pytest.raises(ValueError):
            M.loader.BackgroundLoader(mgr, compress="gzip")
        with pytest.raises(ValueError):
            M.api.LoaderSpec(compress="gzip")
        spec = M.api.LoaderSpec(sharded=True, mesh_shape=(4,),
                                compress="int8")
        cfg = M.api.ServingConfig(
            tenants=(M.api.TenantSpec("tinyllama-1.1b"),), loader=spec,
            executor="sim")
        assert M.api.ServingConfig.from_dict(cfg.to_dict()).loader == spec
        return cfg.to_dict()

    both(run)


def _compressed_load(M):
    mgr = make_manager(M, devices=False)
    loader = M.loader.BackgroundLoader(mgr, compress="int8")
    ratio = M.comp.wire_compression_ratio(32)
    ld = loader.enqueue(mgr.plan_demand("a", 0.0), now_ms=0.0, demand=True)
    assert ld is not None and ld.variant.bits == 32
    assert mgr.state.inflight_mb == 500.0
    assert ld.ready_ms == pytest.approx(1000.0 * ratio)
    assert loader.reap(1000.0 * ratio - 1.0) == []
    recs = loader.reap(1000.0 * ratio)
    assert [r.app for r in recs] == ["a"]
    assert loader.wire_mb_staged == pytest.approx(500.0 * ratio)
    assert mgr.state.tenants["a"].loaded.size_mb == 500.0
    loader.close()
    return [_rec(r) for r in recs], loader.wire_mb_staged


def test_compressed_load_shrinks_wire_time_not_claims():
    both(_compressed_load)


def _compressed_sharded(M):
    mgr = make_manager(M)
    loader = M.SL.ShardedLoaderChannel(mgr, n_devices=N_DEV,
                                       compress="int8")
    wire_ms = 1000.0 * M.comp.wire_compression_ratio(32)
    ld = loader.enqueue(mgr.plan_demand("a", 0.0), 0.0, demand=True)
    assert [s.load_ms for s in ld.shards] == \
        pytest.approx([wire_ms / N_DEV] * N_DEV)
    assert ld.ready_ms == pytest.approx(wire_ms)
    assert mgr.state.devices.inflight["a"] == pytest.approx([125.0] * N_DEV)
    recs = loader.reap(wire_ms)
    assert recs[0].load_ms == pytest.approx(wire_ms)
    assert mgr.state.devices.weights["a"] == pytest.approx([125.0] * N_DEV)
    loader.close()
    return [_rec(r) for r in recs], _ledger(mgr.state.devices)


def test_compressed_sharded_slots_tile_the_wire_time():
    both(_compressed_sharded)


def _cancel_compressed(M):
    mgr = make_manager(M)
    loader = M.SL.ShardedLoaderChannel(mgr, n_devices=N_DEV,
                                       compress="int8")
    loader.enqueue(mgr.plan_proactive("a", 0.0), 0.0, predicted_ms=900.0)
    slot_ms = 1000.0 * M.comp.wire_compression_ratio(32) / N_DEV
    led = mgr.state.devices
    released = []
    orig = led.release_inflight_shard

    def spy(app, device, mb):
        released.append((device, mb))
        orig(app, device, mb)

    led.release_inflight_shard = spy
    loader.reap(2.5 * slot_ms)
    assert loader.shards_landed == 2
    assert loader.cancel("a", 2.5 * slot_ms) is not None
    assert [d for d, _ in released] == list(range(N_DEV))
    assert all(mb == pytest.approx(125.0) for _, mb in released)
    assert mgr.state.inflight_mb == 0.0 and led.inflight == {}
    led.check_invariant()
    recs = loader.reap(2.5 * slot_ms)
    assert len(recs) == 1 and recs[0].partial
    assert recs[0].load_ms == pytest.approx(2 * slot_ms)
    loader.close()
    return released, [_rec(r) for r in recs]


def test_cancel_mid_compressed_load_releases_resident_mb():
    both(_cancel_compressed)


def test_downgrade_action_prefers_in_place():
    def run(M):
        A = M.A
        big, small = _zoo(M, "a", [500, 300]).variants
        assert A.downgrade_action("a", big, small).in_place
        assert not A.downgrade_action("a", None, small).in_place
        assert not A.downgrade_action("a", small, small).in_place
        acts = A.eviction_actions([A.Eviction("a", big, small),
                                   A.Eviction("b", big, None)])
        assert isinstance(acts[0], A.Downgrade) and acts[0].in_place
        assert isinstance(acts[1], A.Unload)
        return [type(a).__name__ for a in acts]

    both(run)


def _inplace_zero_bytes(M):
    A = M.A
    mgr = make_manager(M)
    loader = M.SL.ShardedLoaderChannel(mgr, n_devices=N_DEV,
                                       compress="int8")
    big, small = mgr.state.tenants["a"].zoo.variants
    mgr.state.apply(A.plan_of(A.Load("a", big)))
    assert loader.execute(
        A.plan_of(A.downgrade_action("a", big, small)), 0.0) is None
    assert loader.wire_mb_staged == 0.0
    assert loader.inplace_downgrades == 1
    assert mgr.state.tenants["a"].loaded is small
    mgr.state.devices.check_invariant()
    mgr2 = make_manager(M)
    loader2 = M.SL.ShardedLoaderChannel(mgr2, n_devices=N_DEV,
                                        compress="int8")
    mgr2.state.apply(A.plan_of(A.Load("a", big)))
    loader2.execute(A.plan_of(A.Downgrade("a", small)), 0.0)
    assert loader2.wire_mb_staged == pytest.approx(
        small.size_mb * M.comp.wire_compression_ratio(small.bits))
    assert loader2.inplace_downgrades == 0
    loader.close()
    loader2.close()
    return (_ledger(mgr.state.devices), _ledger(mgr2.state.devices),
            loader2.wire_mb_staged)


def test_inplace_downgrade_stages_zero_wire_bytes():
    both(_inplace_zero_bytes)


def _inplace_validation(M):
    A = M.A
    mgr = make_manager(M)
    big, small = mgr.state.tenants["a"].zoo.variants
    with pytest.raises(A.PlanError):
        mgr.state.apply(A.plan_of(A.Downgrade("a", small, in_place=True)))
    mgr.state.apply(A.plan_of(A.Load("a", small)))
    with pytest.raises(A.PlanError):
        mgr.state.apply(A.plan_of(A.Downgrade("a", small, in_place=True)))
    assert mgr.state.tenants["a"].loaded is small
    return _ledger(mgr.state.devices)


def test_inplace_downgrade_validation():
    both(_inplace_validation)


def _inplace_rollback(M):
    A = M.A
    mgr = make_manager(M)
    big_a, small_a = mgr.state.tenants["a"].zoo.variants
    _, small_b = mgr.state.tenants["b"].zoo.variants
    mgr.state.apply(A.plan_of(A.Load("a", big_a)))
    led = mgr.state.devices
    before = _ledger(led)
    free_before = mgr.state.free_mb
    with pytest.raises(A.PlanError):
        mgr.state.apply(A.plan_of(
            A.Downgrade("a", small_a, in_place=True),
            A.Downgrade("b", small_b, in_place=True)))
    assert mgr.state.tenants["a"].loaded is big_a
    assert _ledger(led) == before
    assert mgr.state.free_mb == pytest.approx(free_before)
    assert mgr.state.inflight_mb == 0.0
    led.check_invariant()
    return before, free_before


def test_inplace_downgrade_plan_rolls_back_without_ledger_drift():
    both(_inplace_rollback)


# ---------------------------------------------------------------------------
# The benchmark's sim A/B on the sharded mesh: serving/quantized/*
# ---------------------------------------------------------------------------
def _stats_equal(got: dict, want: dict) -> None:
    """Every stat equal, bit for bit.  ``prediction_hit_rate`` is read off
    the fitted RNN predictors, which start from each package's own
    initializer (the runs' decisions and audit trails still agree); it is
    held exactly by the pre-fit parity cases."""
    strip = ("prediction_hit_rate",)
    assert ({k: v for k, v in got.items() if k not in strip}
            == {k: v for k, v in want.items() if k not in strip})


def _quantized(M, compress):
    """``benchmarks/serving_throughput.py`` ``_run_quantized``, through
    ``M``'s serving stack."""
    api = M.api
    srv = api.EdgeServer.build(api.ServingConfig(
        tenants=tuple(api.TenantSpec(n) for n in
                      ("tinyllama-1.1b", "mamba2-780m", "gemma2-2b")),
        executor="sim", policy="bfe", delta_ms=750.0,
        batching=api.BatchingSpec(max_batch=4, window_ms=20.0),
        loader=api.LoaderSpec(sharded=True, mesh_shape=(4,),
                              compress=compress),
        kv_headroom_shape=(2, 12)))
    cfgs = {t.name: t.cfg for t in srv.tenants.values()}
    trace, _ = M.serving.poisson_trace(cfgs, requests_per_app=30,
                                       mean_iat_ms=400.0, seed=7)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    d = stats.to_dict()
    d["wire_ms"] = sum(rec.load_ms for rec in srv.engine.loader.history)
    trail = [(e.kind.value, e.t, e.app, e.detail)
             for e in srv.engine.audit_trail]
    srv.close()
    return d, trail


def test_quantized_ab_equals_the_reference_benchmark():
    """The port's ``serving/quantized`` rows equal the reference
    benchmark's live run: ``load_ms`` 0.0341 (full-width minus compressed
    wire ms) and ``warm_ratio`` 0.956, with equal audit trails."""
    from benchmarks import serving_throughput as bench

    rows = {}
    for compress in ("int8", None):
        got, trail = _quantized(PORT, compress)
        _, ref_trail = _quantized(REF, compress)
        assert trail == ref_trail
        _stats_equal(got, bench._run_quantized(compress))
        rows[compress] = got
    assert round(rows[None]["wire_ms"] - rows["int8"]["wire_ms"], 4) \
        == 0.0341
    assert round(rows["int8"]["warm_ratio"], 3) == 0.956
