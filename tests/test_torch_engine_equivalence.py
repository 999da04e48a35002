"""The port's counterpart of ``tests/test_engine_equivalence.py`` (the reference's
cases on ``repro_torch``, real tenants on the CPU):

Scheduling-equivalence properties: indexed vs linear engines.

The indexed scheduler (lazy-deletion event heap, memoized prediction
triggers, online overlap accounting, provable maintenance skipping) is
an *optimization*, not a semantics change: on any trace it must produce
the bit-identical audit trail and ``ServingStats`` the linear reference
path produces.  These tests randomize traces and serving shapes across
the four engine configurations — scalar batching, continuous batching,
sharded loader, and a faulted elastic mesh — and assert exact equality.

The property section uses ``hypothesis`` when available; without it the
same checker runs over a seeded parameter grid so the module always
collects and the equivalence stays guarded.
"""
import numpy as np
import torch
import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # degrade to the seeded fallback below
    HAVE_HYPOTHESIS = False

from repro_torch.serving import EdgeServer, poisson_trace
from repro_torch.serving.api import (BatchingSpec, FaultSpec, LoaderSpec,
                               PredictorSpec, ServingConfig, TenantSpec)

TENANTS = ("tinyllama-1.1b", "mamba2-780m")
FAULT = FaultSpec(events=((3000.0, 3, "down"), (9000.0, 3, "up")))

# The four engine shapes the refactor touches: scalar reactive batching,
# continuous batching, the sharded loader channel, and chip faults.
CONFIGS = {
    "scalar": dict(continuous=False, sharded=False, fault=None),
    "continuous": dict(continuous=True, sharded=False, fault=None),
    "sharded": dict(continuous=True, sharded=True, fault=None),
    "faulted": dict(continuous=True, sharded=True, fault=FAULT),
}
CONFIG_NAMES = tuple(CONFIGS)


def _run(scheduler, shape, *, mean_iat_ms, requests_per_app, delta_ms,
         max_batch, trace_seed, min_fit_samples=10**9):
    """One full replay; returns (stats dict, audit trail, events)."""
    kw = {}
    if shape["sharded"] or shape["fault"] is not None:
        kw["loader"] = LoaderSpec(sharded=True, mesh_shape=(4,))
    srv = EdgeServer.build(ServingConfig(
        tenants=tuple(TenantSpec(n) for n in TENANTS),
        executor="sim", policy="iws-bfe", delta_ms=delta_ms,
        batching=BatchingSpec(max_batch=max_batch, window_ms=20.0,
                              continuous=shape["continuous"]),
        predictor=PredictorSpec(min_fit_samples=min_fit_samples),
        kv_headroom_shape=(2, 12), fault=shape["fault"],
        audit="full", scheduler=scheduler, **kw), device="cpu")
    cfgs = {t.name: t.cfg for t in srv.tenants.values()}
    trace, _ = poisson_trace(cfgs, requests_per_app=requests_per_app,
                             mean_iat_ms=mean_iat_ms, seed=trace_seed)
    stats = srv.engine.run_trace(trace)
    srv.engine.check_event_invariant()
    trail = srv.engine.audit_trail
    emitted = srv.engine.events_emitted
    srv.close()
    return stats.to_dict(), trail, emitted


def _check_equivalence(config_name, *, mean_iat_ms, requests_per_app,
                       delta_ms, max_batch, trace_seed,
                       min_fit_samples=10**9):
    shape = CONFIGS[config_name]
    params = dict(mean_iat_ms=mean_iat_ms,
                  requests_per_app=requests_per_app, delta_ms=delta_ms,
                  max_batch=max_batch, trace_seed=trace_seed,
                  min_fit_samples=min_fit_samples)
    s_idx, t_idx, e_idx = _run("indexed", shape, **params)
    s_lin, t_lin, e_lin = _run("linear", shape, **params)
    assert e_idx == e_lin, (config_name, params)
    assert t_idx == t_lin, (config_name, params)
    assert s_idx == s_lin, (config_name, params)


def _params_from_rng(rng: np.random.Generator) -> dict:
    """Seeded-numpy mirror of the hypothesis parameter strategy."""
    return dict(
        mean_iat_ms=float(rng.uniform(100.0, 900.0)),
        requests_per_app=int(rng.integers(15, 45)),
        delta_ms=float(rng.uniform(150.0, 900.0)),
        max_batch=int(rng.integers(2, 7)),
        trace_seed=int(rng.integers(0, 2**31)))


if HAVE_HYPOTHESIS:
    @settings(max_examples=6, deadline=None)
    @given(st.sampled_from(CONFIG_NAMES),
           st.floats(100.0, 900.0), st.integers(15, 44),
           st.floats(150.0, 900.0), st.integers(2, 6),
           st.integers(0, 2**31 - 1))
    def test_equivalence_property(config_name, mean_iat_ms,
                                  requests_per_app, delta_ms, max_batch,
                                  trace_seed):
        _check_equivalence(
            config_name, mean_iat_ms=mean_iat_ms,
            requests_per_app=requests_per_app, delta_ms=delta_ms,
            max_batch=max_batch, trace_seed=trace_seed)


@pytest.mark.parametrize("config_name", CONFIG_NAMES)
@pytest.mark.parametrize("seed", range(2))
def test_equivalence_seeded(config_name, seed):
    rng = np.random.default_rng(
        1000 * seed + CONFIG_NAMES.index(config_name))
    _check_equivalence(config_name, **_params_from_rng(rng))


def test_equivalence_with_background_fits():
    """Fits enabled (sync in sim builds): the fit lands at a virtual
    instant and changes every later prediction — both schedulers must
    agree through it (the memoized trigger keys on the fit counter)."""
    _check_equivalence(
        "continuous", mean_iat_ms=300.0, requests_per_app=40,
        delta_ms=500.0, max_batch=4, trace_seed=11,
        min_fit_samples=24)
