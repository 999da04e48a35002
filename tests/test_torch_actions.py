"""The port's counterpart of ``tests/test_actions.py`` (the reference's
cases on ``repro_torch``, real tenants on the CPU):

Residency-action IR tests: simulate-vs-apply equivalence, the
all-or-nothing rollback contract, the pending-charge scope, loader
execute() with per-action completion callbacks, the cost-aware policy
plugin, and the adaptive prediction window.

Synthetic zoos throughout — the IR is pure accounting, no models.
"""
import pytest

from repro_torch.core import EdgeMultiAI
from repro_torch.core import actions as A
from repro_torch.core.memory_state import DeviceLedger, MemoryState, TenantState
from repro_torch.core.model_zoo import ModelVariant, ModelZoo
from repro_torch.core.policies import resolve_policy
from repro_torch.serving import BackgroundLoader

N_DEV = 4


def _zoo(name, sizes):
    return ModelZoo(app_name=name, variants=tuple(
        ModelVariant(f"{name}-{i}", bits=32 >> i, size_mb=s,
                     accuracy=90.0 - 10 * i, load_ms=s * 2)
        for i, s in enumerate(sizes)))


def make_state(budget_mb=1000.0, devices=False, device_budget_mb=None,
               **zoos):
    zoos = zoos or {"a": _zoo("a", [500, 300]), "b": _zoo("b", [400, 200])}
    st = MemoryState(budget_mb=budget_mb,
                     tenants={n: TenantState(zoo=z)
                              for n, z in zoos.items()})
    if devices:
        per = (budget_mb / N_DEV if device_budget_mb is None
               else device_budget_mb)
        st.devices = DeviceLedger(
            (per,) * N_DEV,
            split_fn=lambda app, v: (v.size_mb / N_DEV,) * N_DEV)
    return st


def digest(st: MemoryState):
    """Everything an action may mutate, as comparable data."""
    out = {a: (t.loaded, t.kv_mb, t.inflight_mb)
           for a, t in st.tenants.items()}
    out["_pending"] = st.pending_mb
    if st.devices is not None:
        out["_dev"] = (dict(st.devices.weights),
                       {a: tuple(c) for a, c in st.devices.inflight.items()},
                       st.devices.shards_migrated)
    return out


def zoo_of(st, app):
    return st.tenants[app].zoo


# ---------------------------------------------------------------------------
# simulate ≡ apply
# ---------------------------------------------------------------------------
def _plan_matrix(st):
    za, zb = zoo_of(st, "a"), zoo_of(st, "b")
    return [
        # (plan, feasible on a fresh 1000MB two-tenant state?)
        (A.plan_of(A.Load("a", za.largest)), True),
        (A.plan_of(A.Load("a", za.largest), A.Load("b", zb.largest)), True),
        (A.plan_of(A.Load("a", za.largest),
                   A.Load("b", zb.largest),
                   A.ChargeKV("b", 200.0)), False),  # 500+400+200 > 1000
        (A.plan_of(A.Load("a", za.largest, staged=True, claim_mb=500.0),
                   A.Load("b", zb.largest, staged=True,
                          claim_mb=400.0)), True),
        (A.plan_of(A.Load("a", za.largest, staged=True,
                          claim_mb=600.0),
                   A.Load("b", zb.largest, staged=True,
                          claim_mb=500.0)), False),  # second claim 500>400
        (A.plan_of(A.ChargeKV("a", 999.0)), True),
        (A.plan_of(A.ChargeKV("a", 1001.0)), False),
        (A.plan_of(A.ChargeKV("a", -1.0)), False),
        (A.plan_of(A.MigrateShard("a", 0, 1, 10.0)), False),  # no ledger
    ]


def test_simulate_matches_apply_and_neither_leaks_on_failure():
    """simulate() returns None exactly when apply() succeeds; simulate
    never mutates; a failed apply leaves the state bit-identical."""
    for i, (plan, feasible) in enumerate(_plan_matrix(make_state())):
        st = make_state()
        before = digest(st)
        err = st.simulate(plan)
        assert digest(st) == before, f"plan {i}: simulate mutated state"
        assert (err is None) == feasible, f"plan {i}: {err}"
        if feasible:
            st.apply(plan)
            assert digest(st) != before or len(plan) == 0
        else:
            with pytest.raises(A.PlanError):
                st.apply(plan)
            assert digest(st) == before, f"plan {i}: apply leaked"


def test_apply_is_sequential_order_matters():
    """An eviction earlier in the plan funds a load later in it."""
    st = make_state(budget_mb=600.0)
    za, zb = zoo_of(st, "a"), zoo_of(st, "b")
    st.apply(A.plan_of(A.Load("b", zb.largest)))  # 400 resident, 200 free
    good = A.plan_of(A.Downgrade("b", zb.smallest),  # frees 200 -> 400
                     A.Load("a", za.smallest, staged=True))  # needs 300
    bad = A.plan_of(A.Load("a", za.smallest, staged=True),
                    A.Downgrade("b", zb.smallest))
    assert st.simulate(bad) is not None, "claim before the eviction"
    assert st.simulate(good) is None
    st.apply(good)
    assert st.tenants["a"].inflight_mb == 300.0
    assert st.tenants["b"].loaded is zb.smallest


def test_all_or_nothing_rollback_on_mid_plan_shard_failure():
    """A valid downgrade followed by a staged load whose shard overflows
    its chip must leave *no trace* — the downgrade rolls back too."""
    st = make_state(devices=True, device_budget_mb=100.0)
    za, zb = zoo_of(st, "a"), zoo_of(st, "b")
    st.apply(A.plan_of(A.Load("b", zb.smallest)))  # 50/chip
    before = digest(st)
    plan = A.plan_of(
        A.Downgrade("b", zb.smallest),  # no-op downgrade, still valid
        A.Load("a", za.largest, staged=True, claim_mb=500.0,
               shard_claims=(125.0,) * N_DEV))  # 125 > 100-50 free
    assert st.simulate(plan) is not None
    with pytest.raises(A.PlanError):
        st.apply(plan)
    assert digest(st) == before, "mid-plan failure left partial state"
    assert st.devices.inflight == {}, "no shard claim survived rollback"


def test_staged_load_commit_is_net_zero_and_releases_shards():
    st = make_state(devices=True)
    za = zoo_of(st, "a")
    claims = (125.0,) * N_DEV
    st.apply(A.plan_of(A.Load("a", za.largest, staged=True,
                              claim_mb=500.0, shard_claims=claims)))
    assert st.free_mb == pytest.approx(500.0)
    assert st.devices.inflight["a"] == pytest.approx([125.0] * N_DEV)
    st.apply(A.plan_of(A.Load("a", za.largest, claim_mb=500.0,
                              shard_claims=claims)))
    assert st.free_mb == pytest.approx(500.0), "commit is net zero"
    assert st.devices.inflight == {}
    assert st.devices.weights["a"] == pytest.approx((125.0,) * N_DEV)


def test_shrink_cancel_and_kv_actions():
    st = make_state()
    za = zoo_of(st, "a")
    st.apply(A.plan_of(A.Load("a", za.largest, staged=True)))
    assert st.tenants["a"].inflight_mb == 500.0, "claim_mb=None = marginal"
    st.apply(A.plan_of(A.Shrink("a", za.smallest, release_mb=200.0)))
    assert st.tenants["a"].inflight_mb == 300.0
    st.apply(A.plan_of(A.CancelPrefetch("a", claim_mb=300.0)))
    assert st.tenants["a"].inflight_mb == 0.0
    st.apply(A.plan_of(A.ChargeKV("a", 150.0)))
    assert st.tenants["a"].kv_mb == 150.0
    st.apply(A.plan_of(A.EvictKV("a", 999.0)))  # over-release clamps
    assert st.tenants["a"].kv_mb == 0.0
    with pytest.raises(A.PlanError):
        st.apply(A.plan_of(A.Load("zzz", za.largest)))


def test_pending_scope_always_restores():
    st = make_state()
    with pytest.raises(RuntimeError):
        with st.pending(123.0):
            assert st.pending_mb == 123.0
            raise RuntimeError("boom")
    assert st.pending_mb == 0.0


def test_procure_actions_compiles_evictions_and_target():
    st = make_state()
    za, zb = zoo_of(st, "a"), zoo_of(st, "b")
    plan = A.ProcurePlan("a", za.largest, (
        A.Eviction("b", zb.largest, None),
        A.Eviction("b", zb.largest, zb.smallest)))
    acts = A.procure_actions(plan, staged=True)
    assert isinstance(acts[0], A.Unload)
    assert isinstance(acts[1], A.Downgrade) and acts[1].variant is zb.smallest
    assert isinstance(acts[2], A.Load) and acts[2].staged


# ---------------------------------------------------------------------------
# LoaderChannel.execute: atomicity + per-action completion callbacks
# ---------------------------------------------------------------------------
def make_manager(budget_mb=1000.0):
    return EdgeMultiAI(
        {"a": _zoo("a", [500, 300]), "b": _zoo("b", [400, 200])},
        budget_mb=budget_mb, policy="iws-bfe", delta_ms=10.0)


def test_execute_fires_per_action_callbacks_in_order():
    mgr = make_manager()
    st = mgr.state
    zb = st.tenants["b"].zoo
    st.apply(A.plan_of(A.Load("b", zb.largest)))
    loader = BackgroundLoader(mgr)
    fired = []
    za = st.tenants["a"].zoo
    ld = loader.execute(
        A.plan_of(A.Downgrade("b", zb.smallest),
                  A.Load("a", za.largest, staged=True)),
        now_ms=0.0, on_action=lambda act, t: fired.append((type(act), t)))
    assert ld is not None and ld.charge_mb == 500.0
    assert fired == [(A.Downgrade, 0.0)], \
        "instantaneous actions complete during execute; the staged " \
        "load completes at commit"
    loader.reap(ld.ready_ms)
    assert [f[0] for f in fired] == [A.Downgrade, A.Load]
    assert fired[-1][1] == ld.ready_ms
    loader.close()


def test_execute_stale_plan_enacts_nothing_not_even_evictions():
    """The pre-IR enqueue enacted a plan's evictions and only then
    noticed the claim no longer fit, stranding the downgrade.  The
    transactional applier rolls the whole group back."""
    mgr = make_manager()
    st = mgr.state
    za, zb = st.tenants["a"].zoo, st.tenants["b"].zoo
    st.apply(A.plan_of(A.Load("b", zb.largest),
                       A.ChargeKV("b", 550.0)))  # free = 50
    loader = BackgroundLoader(mgr)
    before = digest(st)
    out = loader.execute(
        A.plan_of(A.Downgrade("b", zb.smallest),  # frees 200 -> free 250
                  A.Load("a", za.largest, staged=True)),  # needs 500
        now_ms=0.0)
    assert out is None
    assert digest(st) == before, "stale plan left its evictions behind"
    loader.close()


def test_cancel_stale_accepts_per_tenant_delta():
    """Staleness must agree with the (possibly adaptive) per-tenant Δ:
    cancel_stale takes a callable, so a widened window is not cancelled
    early and a narrowed one does not squat."""
    mgr = make_manager()
    loader = BackgroundLoader(mgr)
    loader.enqueue(mgr.plan_proactive("a", 0.0), 0.0, predicted_ms=1000.0)
    wide = {"a": 600.0}
    assert loader.cancel_stale(1500.0, lambda app: wide[app],
                               has_queued=lambda a: False) == 0, \
        "still inside the widened per-tenant window"
    assert loader.cancel_stale(1700.0, lambda app: wide[app],
                               has_queued=lambda a: False) == 1
    loader.close()


# ---------------------------------------------------------------------------
# cost-bfe: plan candidates enumerated + simulated, ranked by cost
# ---------------------------------------------------------------------------
def test_cost_bfe_prefers_variant_ready_before_predicted_request():
    """With the next request predicted mid-transfer of the big variant,
    the smaller variant (ready in time, smaller accuracy) scores higher;
    with no prediction the choice degrades to plain BFE (largest)."""
    st = make_state(budget_mb=1000.0)
    za = zoo_of(st, "a")
    pol = resolve_policy("cost-bfe")
    # No prediction: identical to BFE.
    plan = pol.plan_procure(st, "a", 0.0, delta=10.0, history=0.0)
    assert plan.variant is za.largest
    # Next request lands at t=650: the 1000ms bf16 transfer misses it
    # (score 90*0.65=58.5), the 600ms int8 makes it (score 80*1=80).
    st.tenants["a"].predicted_next = 650.0
    plan = pol.plan_procure(st, "a", 0.0, delta=10.0, history=0.0)
    assert plan.ok and plan.variant is za.smallest
    # Imminent request: nothing can be ready — serve the largest anyway
    # (all scores 0, ties keep the bigger variant).
    st.tenants["a"].predicted_next = 0.0
    plan = pol.plan_procure(st, "a", 0.0, delta=10.0, history=0.0)
    assert plan.ok and plan.variant is za.largest


def test_cost_bfe_skips_candidates_that_do_not_simulate():
    """A candidate whose shard overflows its chip is unfundable in a way
    device-blind eviction math cannot see: the per-variant simulate()
    (device-aware staged claims) filters it, and cost-bfe lands on the
    variant that actually fits every chip."""
    st = make_state(budget_mb=1000.0, devices=True, device_budget_mb=110.0)
    za = zoo_of(st, "a")
    # bf16's 125MB/chip shard > 110MB chip budget; int8's 75MB fits.
    pol = resolve_policy("cost-bfe")
    plan = pol.plan_procure(st, "a", 0.0, delta=10.0, history=0.0)
    assert plan.ok and plan.variant is za.smallest
    # Plain BFE (device-blind, no simulate pass) would have picked bf16.
    blind = resolve_policy("bfe").plan_procure(st, "a", 0.0, delta=10.0,
                                               history=0.0)
    assert blind.variant is za.largest


# ---------------------------------------------------------------------------
# Adaptive prediction window (satellite): Δ from arrival residuals
# ---------------------------------------------------------------------------
def test_adaptive_delta_tracks_residuals_and_stays_bounded():
    mgr = EdgeMultiAI({"a": _zoo("a", [500, 300])}, budget_mb=1000.0,
                      policy="iws-bfe", delta_ms=400.0,
                      adaptive_delta=True)
    assert mgr.delta_for("a") == 400.0, "no residuals yet: configured Δ"
    # Tight predictions (|resid| = 20) shrink the window toward 2*EWMA,
    # clamped at Δ/4.
    for t in (1000.0, 2000.0, 3000.0, 4000.0):
        mgr.set_prediction("a", t + 20.0)
        mgr.on_request("a", t)
    assert mgr.delta_for("a") == pytest.approx(100.0), "clamped at Δ/4"
    # A noisy stretch (resid 2000) grows it, clamped at 2Δ.
    for t in (5000.0, 6000.0, 7000.0, 8000.0):
        mgr.set_prediction("a", t + 2000.0)
        mgr.on_request("a", t)
    assert mgr.delta_for("a") == pytest.approx(800.0), "clamped at 2Δ"


def test_adaptive_delta_off_by_default_keeps_fixed_window():
    mgr = EdgeMultiAI({"a": _zoo("a", [500, 300])}, budget_mb=1000.0,
                      policy="iws-bfe", delta_ms=400.0)
    for t in (1000.0, 2000.0, 3000.0):
        mgr.set_prediction("a", t + 5.0)
        mgr.on_request("a", t)
    assert mgr.delta_for("a") == 400.0
