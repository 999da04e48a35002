"""The port's counterpart of ``tests/test_core_sim.py`` (the reference's
cases on ``repro_torch``, real tenants on the CPU):

Simulator, manager, and paper-claim validation tests.

The property section uses ``hypothesis`` when available; without it the
same invariant checker runs over a seeded parameter grid so the module
always collects and the invariants stay guarded.
"""

import dataclasses

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # degrade to the seeded fallback below
    HAVE_HYPOTHESIS = False

from repro_torch.configs.paper_edge import paper_zoos
from repro_torch.core import (EdgeMultiAI, generate_workload, simulate,
                        sweep_policies)


class TestWorkload:
    def test_equal_requests_per_app(self):
        wl = generate_workload(["a", "b", "c"], requests_per_app=20, seed=1)
        counts = {}
        for _, app in wl.requests:
            counts[app] = counts.get(app, 0) + 1
        assert all(c == 20 for c in counts.values())

    def test_requests_sorted(self):
        wl = generate_workload(["a", "b"], requests_per_app=30, seed=2)
        ts = [t for t, _ in wl.requests]
        assert ts == sorted(ts)

    def test_deviation_increases_residuals(self):
        lo = generate_workload(["a", "b"], deviation=0.1, seed=3,
                               requests_per_app=100)
        hi = generate_workload(["a", "b"], deviation=0.8, seed=3,
                               requests_per_app=100)
        assert hi.delta_D > lo.delta_D
        assert hi.kl >= lo.kl * 0.5  # KL noisy but should not collapse

    def test_dropped_predictions(self):
        wl = generate_workload(["a"], deviation=0.9, seed=4,
                               requests_per_app=200)
        assert len(wl.predictions["a"]) < 200  # some were dropped


class TestManagerAccounting:
    def test_record_totals(self):
        zoos = paper_zoos()
        wl = generate_workload(list(zoos), requests_per_app=20, seed=0)
        res = simulate(zoos, wl, policy="iws-bfe")
        m = res.metrics
        assert m.total == len(wl.requests)
        assert abs(m.warm_ratio + m.cold_ratio + m.fail_ratio - 1.0) < 1e-9

    def test_memory_never_exceeded(self):
        # MemoryState.load asserts the invariant on every mutation, so a
        # full simulation passing is itself the property.
        zoos = paper_zoos()
        for policy in ("none", "lfe", "bfe", "ws-bfe", "iws-bfe"):
            wl = generate_workload(list(zoos), requests_per_app=30,
                                   deviation=0.5, seed=7)
            simulate(zoos, wl, policy=policy, budget_mb=900.0)

    def test_unknown_policy_raises(self):
        with pytest.raises(KeyError):
            EdgeMultiAI(paper_zoos(), 1000.0, policy="nope")


class TestPaperClaims:
    """The paper's headline numbers (§IV), validated end-to-end."""

    @pytest.fixture(scope="class")
    def sweep(self):
        return sweep_policies(
            paper_zoos(), deviations=(0.3,),
            policies=("none", "lfe", "bfe", "ws-bfe", "iws-bfe"),
            seeds=(0, 1, 2), requests_per_app=50)

    def test_warm_start_gain_over_no_policy(self, sweep):
        """Claim: ≈60% more warm-starts than no-policy."""
        gain = sweep["iws-bfe"][0.3]["warm"] / sweep["none"][0.3]["warm"]
        assert gain > 1.5, f"warm-start gain {gain:.2f}"

    def test_ws_policies_mitigate_cold_starts(self, sweep):
        """Claim: WS-BFE / iWS-BFE cut cold starts ≥65% vs LFE/BFE."""
        lfe_cold = sweep["lfe"][0.3]["cold"]
        for p in ("ws-bfe", "iws-bfe"):
            assert sweep[p][0.3]["cold"] < lfe_cold * 0.35, p

    def test_iws_beats_ws_on_cold_starts(self, sweep):
        """Claim: iWS-BFE ≈40% fewer cold-starts than WS-BFE."""
        assert (sweep["iws-bfe"][0.3]["cold"]
                <= sweep["ws-bfe"][0.3]["cold"])

    def test_robustness_ordering(self, sweep):
        """Fig 8 ordering: iws ≥ ws > lfe/bfe > none."""
        r = {p: sweep[p][0.3]["rob"] for p in sweep}
        assert r["iws-bfe"] >= r["ws-bfe"] - 0.02
        assert r["ws-bfe"] > r["lfe"]
        assert r["lfe"] > r["none"]

    def test_lfe_bfe_accuracy_above_ws(self, sweep):
        """Fig 6: LFE/BFE accuracy > WS-BFE (they never keep
        low-precision models resident)."""
        assert sweep["lfe"][0.3]["acc"] > sweep["ws-bfe"][0.3]["acc"]

    def test_robustness_degrades_with_deviation(self):
        out = sweep_policies(paper_zoos(), deviations=(0.0, 0.9),
                             policies=("iws-bfe",), seeds=(0, 1))
        assert out["iws-bfe"][0.0]["rob"] > out["iws-bfe"][0.9]["rob"]


class TestFairness:
    def test_no_app_starved(self):
        """Figs 9/10: outcomes must not be biased to one application."""
        zoos = paper_zoos()
        wl = generate_workload(list(zoos), requests_per_app=60, seed=5,
                               deviation=0.3)
        res = simulate(zoos, wl, policy="iws-bfe")
        per = res.metrics.per_app()
        warms = [v["warm_ratio"] for v in per.values()]
        assert min(warms) > 0.7, per
        assert max(warms) - min(warms) < 0.3


def _check_simulation_invariants(seed, deviation, policy):
    zoos = paper_zoos()
    wl = generate_workload(list(zoos), requests_per_app=15,
                           deviation=deviation, seed=seed)
    res = simulate(zoos, wl, policy=policy)
    m = res.metrics
    assert m.total == len(wl.requests)
    assert 0.0 <= m.warm_ratio <= 1.0
    assert 0.0 <= m.robustness() <= 1.0
    assert m.state.used_mb <= m.state.budget_mb + 1e-6


if HAVE_HYPOTHESIS:
    @settings(max_examples=20, deadline=None)
    @given(st.integers(0, 10_000), st.floats(0.0, 0.9),
           st.sampled_from(["lfe", "bfe", "ws-bfe", "iws-bfe"]))
    def test_simulation_total_invariants(seed, deviation, policy):
        _check_simulation_invariants(seed, deviation, policy)


@pytest.mark.parametrize("policy", ["lfe", "bfe", "ws-bfe", "iws-bfe"])
@pytest.mark.parametrize("seed,deviation", [(0, 0.0), (17, 0.3), (401, 0.9)])
def test_simulation_total_invariants_seeded(seed, deviation, policy):
    _check_simulation_invariants(seed, deviation, policy)


def test_sweep_kl_averaged_across_seeds():
    """Regression: ``kl`` must aggregate over seeds like the other
    metrics, not record only the last seed's workload."""
    zoos = paper_zoos()
    seeds = (0, 1)
    out = sweep_policies(zoos, deviations=(0.3,), policies=("lfe",),
                         requests_per_app=10, seeds=seeds)
    kls = [generate_workload(list(zoos), requests_per_app=10,
                             mean_iat_ms=8000.0, deviation=0.3, seed=s).kl
           for s in seeds]
    assert out["lfe"][0.3]["kl"] == pytest.approx(float(np.mean(kls)))
    assert out["lfe"][0.3]["kl"] != pytest.approx(kls[-1])


# ---------------------------------------------------------------------------
# The same outputs as the reference's simulator
# ---------------------------------------------------------------------------
def test_sweep_policies_matches_reference():
    """``sweep_policies`` over every registered policy, three seeds and
    two deviations at two budgets: every aggregate equal to the
    reference's (numpy arithmetic on both sides)."""
    from repro.configs.paper_edge import paper_zoos as jzoos
    from repro.core import available_policies as javailable
    from repro.core import sweep_policies as jsweep
    from repro_torch.core import available_policies

    policies = tuple(available_policies())
    assert policies == tuple(javailable()) and len(policies) == 7
    for budget in (900.0, 1200.0):
        kw = dict(deviations=(0.0, 0.6), policies=policies,
                  budget_mb=budget, requests_per_app=30, seeds=(0, 1, 2))
        assert sweep_policies(paper_zoos(), **kw) == jsweep(jzoos(), **kw)


@pytest.mark.parametrize("policy", ["none", "lfe", "bfe", "ws-bfe",
                                    "iws-bfe", "batch-bfe"])
def test_simulate_matches_reference(policy):
    """One ``simulate`` run's metrics and per-request log against the
    reference's."""
    from repro.configs.paper_edge import paper_zoos as jzoos
    from repro.core import generate_workload as jworkload
    from repro.core import simulate as jsimulate

    wl = generate_workload(list(paper_zoos()), requests_per_app=40,
                           deviation=0.3, seed=4)
    jwl = jworkload(list(jzoos()), requests_per_app=40, deviation=0.3,
                    seed=4)
    got = simulate(paper_zoos(), wl, policy=policy)
    want = jsimulate(jzoos(), jwl, policy=policy)
    assert ([dataclasses.astuple(r) for r in got.metrics.records]
            == [dataclasses.astuple(r) for r in want.metrics.records])
    assert got.mean_concurrency == want.mean_concurrency
    for k in ("warm_ratio", "cold_ratio", "fail_ratio"):
        assert getattr(got.metrics, k) == getattr(want.metrics, k), k
