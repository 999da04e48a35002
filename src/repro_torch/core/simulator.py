"""E2C-style discrete-event workload simulator (§IV-A).

Reproduces the paper's evaluation protocol:

* per-application request streams with exponential inter-arrival times,
  equal request counts per app;
* a *predicted* workload derived from the actual one with a controlled
  deviation knob ``d`` — per-request Gaussian jitter of std ``d·IAT`` plus
  prediction drop-outs with probability ``d/2`` (the paper's "unexpected
  requests"); the realized divergence is reported as KL between actual
  and predicted inter-arrival distributions, as in the paper;
* Δ estimated from prediction residuals as ``D + α·σ`` (Fig 7 sweeps α);
* an event loop that fires proactive-load triggers at ``t_pred − Δ − θ``
  and actual requests in timestamp order.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.manager import EdgeMultiAI, Metrics
from repro_torch.core.model_zoo import ModelZoo


@dataclass
class Workload:
    requests: List[Tuple[float, str]]  # (t, app) sorted by t
    predictions: Dict[str, List[float]]  # app -> predicted request times
    horizon_ms: float
    deviation: float
    delta_D: float  # mean |residual| over matched prediction pairs
    delta_sigma: float  # std of residuals
    kl: float  # realized KL(actual ‖ predicted) inter-arrival divergence

    def delta(self, alpha: float = 1.0) -> float:
        return self.delta_D + alpha * self.delta_sigma

    @property
    def mean_iat(self) -> float:
        per_app: Dict[str, List[float]] = {}
        for t, a in self.requests:
            per_app.setdefault(a, []).append(t)
        gaps = []
        for ts in per_app.values():
            ts = sorted(ts)
            gaps += [b - a for a, b in zip(ts, ts[1:])]
        return float(np.mean(gaps)) if gaps else 1.0


def _predict_times(times, rng, deviation: float, scale_ms: float,
                   residuals: List[float]) -> List[float]:
    """The paper's prediction protocol over one tenant's arrival times:
    drop each with probability ``deviation/2`` (unexpected requests),
    jitter the rest by N(0, ``deviation·scale_ms``).  Draw order is part
    of the seeded contract — one ``rng.random()`` then (if kept) one
    ``rng.normal()`` per arrival."""
    preds: List[float] = []
    for t in times:
        if rng.random() < deviation / 2:
            continue  # dropped prediction -> unexpected request
        jitter = rng.normal(0.0, deviation * scale_ms)
        preds.append(float(t + jitter))
        residuals.append(abs(jitter))
    preds.sort()
    return preds


def _finalize(requests: List[Tuple[float, str]],
              predictions: Dict[str, List[float]],
              residuals: List[float], actual_iats: List[float],
              pred_iats: List[float], tail_ms: float,
              deviation: float) -> Workload:
    requests.sort()
    horizon = max(t for t, _ in requests) + tail_ms
    D = float(np.mean(residuals)) if residuals else 0.0
    sigma = float(np.std(residuals)) if residuals else 0.0
    kl = _kl_divergence(np.asarray(actual_iats), np.asarray(pred_iats))
    return Workload(requests, predictions, horizon, deviation, D, sigma, kl)


def generate_workload(
    apps: List[str],
    *,
    requests_per_app: int = 60,
    mean_iat_ms: float = 8000.0,
    deviation: float = 0.3,
    seed: int = 0,
) -> Workload:
    rng = np.random.default_rng(seed)
    requests: List[Tuple[float, str]] = []
    predictions: Dict[str, List[float]] = {}
    residuals: List[float] = []
    actual_iats: List[float] = []
    pred_iats: List[float] = []
    for a in apps:
        gaps = rng.exponential(mean_iat_ms, requests_per_app)
        times = np.cumsum(gaps)
        actual_iats += list(gaps)
        requests += [(float(t), a) for t in times]
        predictions[a] = _predict_times(times, rng, deviation,
                                        mean_iat_ms, residuals)
        pred_iats += list(np.diff(predictions[a]))
    return _finalize(requests, predictions, residuals, actual_iats,
                     pred_iats, mean_iat_ms, deviation)


def generate_flash_crowd(
    apps: List[str],
    *,
    requests_per_app: int = 20,
    base_iat_ms: float = 8000.0,
    burst_app: Optional[str] = None,
    burst_at_ms: Optional[float] = None,
    burst_requests: int = 40,
    burst_iat_ms: float = 100.0,
    deviation: float = 0.3,
    seed: int = 0,
) -> Workload:
    """Poisson baseline plus one tenant's flash crowd: a dense burst of
    ``burst_requests`` arrivals at ``burst_iat_ms`` mean spacing,
    starting at ``burst_at_ms`` (default: a quarter into the trace), on
    ``burst_app`` (default: the first app).

    The burst is part of the *actual* stream but never of the predicted
    one — a flash crowd is by definition the load the per-tenant
    predictor did not see coming, which is exactly what the cluster
    tier's spill/hand-off path exists to absorb.
    """
    rng = np.random.default_rng(seed)
    requests: List[Tuple[float, str]] = []
    predictions: Dict[str, List[float]] = {}
    residuals: List[float] = []
    actual_iats: List[float] = []
    pred_iats: List[float] = []
    target = burst_app if burst_app is not None else apps[0]
    if target not in apps:
        raise ValueError(f"burst_app {target!r} not in apps")
    start = (burst_at_ms if burst_at_ms is not None
             else 0.25 * requests_per_app * base_iat_ms)
    for a in apps:
        gaps = rng.exponential(base_iat_ms, requests_per_app)
        times = list(np.cumsum(gaps))
        actual_iats += list(gaps)
        predictions[a] = _predict_times(times, rng, deviation,
                                        base_iat_ms, residuals)
        pred_iats += list(np.diff(predictions[a]))
        if a == target:
            bgaps = rng.exponential(burst_iat_ms, burst_requests)
            times = sorted(times + list(start + np.cumsum(bgaps)))
            actual_iats += list(bgaps)
        requests += [(float(t), a) for t in times]
    return _finalize(requests, predictions, residuals, actual_iats,
                     pred_iats, base_iat_ms, deviation)


def generate_diurnal(
    apps: List[str],
    *,
    requests_per_app: int = 60,
    mean_iat_ms: float = 8000.0,
    period_ms: Optional[float] = None,
    amplitude: float = 0.8,
    deviation: float = 0.3,
    seed: int = 0,
) -> Workload:
    """Diurnal (sinusoidal-rate) Poisson arrivals by thinning: the
    instantaneous rate is ``(1 + amplitude·sin(2πt/period)) /
    mean_iat_ms``, so load swells and ebbs around the Poisson baseline
    — the edge fleet's day/night cycle.  ``period_ms`` defaults to
    ``20·mean_iat_ms`` (a few peaks per trace).  Predictions follow the
    same protocol as :func:`generate_workload` over the thinned stream.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    period = period_ms if period_ms is not None else 20.0 * mean_iat_ms
    rng = np.random.default_rng(seed)
    requests: List[Tuple[float, str]] = []
    predictions: Dict[str, List[float]] = {}
    residuals: List[float] = []
    actual_iats: List[float] = []
    pred_iats: List[float] = []
    lam_max = (1.0 + amplitude) / mean_iat_ms
    for a in apps:
        times: List[float] = []
        t = 0.0
        prev = 0.0
        while len(times) < requests_per_app:
            t += rng.exponential(1.0 / lam_max)
            lam = (1.0 + amplitude * math.sin(2.0 * math.pi * t / period)
                   ) / mean_iat_ms
            if rng.random() < lam / lam_max:
                times.append(t)
                actual_iats.append(t - prev)
                prev = t
        requests += [(float(tt), a) for tt in times]
        predictions[a] = _predict_times(times, rng, deviation,
                                        mean_iat_ms, residuals)
        pred_iats += list(np.diff(predictions[a]))
    return _finalize(requests, predictions, residuals, actual_iats,
                     pred_iats, mean_iat_ms, deviation)


def generate_zoo(
    apps: List[str],
    *,
    requests_per_app: int = 60,
    mean_iat_ms: float = 8000.0,
    period_ms: Optional[float] = None,
    amplitude: float = 0.5,
    burst_app: Optional[str] = None,
    burst_at_ms: Optional[float] = None,
    burst_requests: int = 0,
    burst_iat_ms: float = 100.0,
    deviation: float = 0.3,
    seed: int = 0,
) -> Workload:
    """Vectorized workload zoo: diurnal (sinusoidal-rate) Poisson
    arrivals for every tenant plus an optional flash crowd on one — the
    mixed stream large-scale engine replays use.  All draws are batched
    numpy calls, so a 10^5-request trace materializes in milliseconds
    instead of the per-arrival python loops of
    :func:`generate_diurnal` / :func:`generate_flash_crowd` (whose
    seeded draw orders are contractual and therefore untouched).

    Draw-order contract (seeded, per app in ``apps`` order): rounds of
    one ``rng.exponential(1/λmax, K)`` batch then one ``rng.random(K)``
    batch until ``requests_per_app`` thinned arrivals accumulate; then
    one ``rng.random(n)`` batch and one ``rng.normal(0, σ, n)`` batch
    for the prediction protocol (jitter is drawn for every arrival and
    masked, unlike the scalar generators' draw-per-kept); finally, for
    the burst tenant, one ``rng.exponential(burst_iat_ms,
    burst_requests)`` batch.  Like :func:`generate_flash_crowd`, burst
    arrivals never enter the predicted stream.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    period = period_ms if period_ms is not None else 20.0 * mean_iat_ms
    target = burst_app if burst_app is not None else apps[0]
    if burst_requests and target not in apps:
        raise ValueError(f"burst_app {target!r} not in apps")
    start = (burst_at_ms if burst_at_ms is not None
             else 0.25 * requests_per_app * mean_iat_ms)
    rng = np.random.default_rng(seed)
    lam_max = (1.0 + amplitude) / mean_iat_ms
    # Candidate batch sized so one round almost always suffices: the
    # thinning acceptance rate averages 1/(1+amplitude).
    batch = int(requests_per_app * (1.0 + amplitude) * 1.25) + 16
    requests: List[Tuple[float, str]] = []
    predictions: Dict[str, List[float]] = {}
    residuals: List[float] = []
    actual_iats: List[float] = []
    pred_iats: List[float] = []
    for a in apps:
        kept = np.empty(0)
        t0 = 0.0
        while kept.size < requests_per_app:
            cand = t0 + np.cumsum(rng.exponential(1.0 / lam_max, batch))
            lam = (1.0 + amplitude * np.sin(2.0 * np.pi * cand / period)
                   ) / mean_iat_ms
            kept = np.concatenate(
                [kept, cand[rng.random(batch) < lam / lam_max]])
            t0 = float(cand[-1])
        times = kept[:requests_per_app]
        actual_iats += list(np.diff(times, prepend=0.0))
        # Vectorized prediction protocol: drop w.p. deviation/2, jitter
        # the survivors by N(0, deviation·mean_iat).
        keep = rng.random(times.size) >= deviation / 2
        jitter = rng.normal(0.0, deviation * mean_iat_ms, times.size)
        preds = np.sort((times + jitter)[keep])
        residuals += list(np.abs(jitter[keep]))
        predictions[a] = [float(p) for p in preds]
        pred_iats += list(np.diff(preds))
        if burst_requests and a == target:
            bgaps = rng.exponential(burst_iat_ms, burst_requests)
            times = np.sort(np.concatenate(
                [times, start + np.cumsum(bgaps)]))
            actual_iats += list(bgaps)
        requests += [(float(t), a) for t in times]
    return _finalize(requests, predictions, residuals, actual_iats,
                     pred_iats, mean_iat_ms, deviation)


def _kl_divergence(p_samples: np.ndarray, q_samples: np.ndarray,
                   bins: int = 30) -> float:
    """Histogram KL(actual ‖ predicted) over inter-arrival distributions."""
    if len(p_samples) == 0 or len(q_samples) == 0:
        return float("inf")
    hi = float(max(p_samples.max(), q_samples.max()))
    edges = np.linspace(0.0, hi + 1e-9, bins + 1)
    p, _ = np.histogram(p_samples, edges)
    q, _ = np.histogram(q_samples, edges)
    p = (p + 1e-3) / (p.sum() + 1e-3 * bins)
    q = (q + 1e-3) / (q.sum() + 1e-3 * bins)
    return float(np.sum(p * np.log(p / q)))


# ---------------------------------------------------------------------------
@dataclass
class SimResult:
    metrics: Metrics
    workload: Workload
    mean_concurrency: float
    policy: str


def simulate(
    zoos: Dict[str, ModelZoo],
    workload: Workload,
    *,
    policy: str = "iws-bfe",
    budget_mb: float = 1200.0,
    alpha: float = 1.0,
    delta_ms: Optional[float] = None,
    history_ms: Optional[float] = None,
) -> SimResult:
    # Δ is a *system* parameter profiled at nominal prediction accuracy
    # (the paper: "obtained from profiling past request predictions");
    # the robustness experiments then vary the *test* deviation while Δ
    # stays fixed.  When not supplied, calibrate from this workload.
    delta = (delta_ms if delta_ms is not None
             else max(workload.delta(alpha), 1.0))
    # H = mean inter-arrival of the *merged* request stream (the LRU-K
    # "recently requested" horizon): per-app IAT divided by tenant count.
    history = (history_ms if history_ms is not None
               else workload.mean_iat / max(len(zoos), 1))
    mgr = EdgeMultiAI(zoos, budget_mb, policy=policy, delta_ms=delta,
                      history_ms=history)

    # Build the event heap: (t, priority, kind, app, payload)
    events: List[Tuple[float, int, str, str, float]] = []
    for t, a in workload.requests:
        heapq.heappush(events, (t, 1, "request", a, t))
    for a, preds in workload.predictions.items():
        theta = zoos[a].largest.load_ms
        for tp in preds:
            trig = tp - delta - theta
            heapq.heappush(events, (trig, 0, "proactive", a, tp))

    # Lazily advance each tenant's "next prediction" pointer.
    pred_ptr = {a: 0 for a in zoos}

    def refresh_predictions(now: float) -> None:
        for a, preds in workload.predictions.items():
            i = pred_ptr[a]
            while i < len(preds) and preds[i] + delta < now:
                i += 1
            pred_ptr[a] = i
            mgr.set_prediction(a, preds[i] if i < len(preds) else math.inf)

    # Mean concurrency = time-average of |A*| (apps inside their window).
    conc_acc, conc_t, last_t = 0.0, 0.0, 0.0

    while events:
        t, _, kind, app, payload = heapq.heappop(events)
        refresh_predictions(t)
        n_act = len(mgr.state.maximalist_set(t, delta))
        conc_acc += n_act * max(t - last_t, 0.0)
        conc_t += max(t - last_t, 0.0)
        last_t = t
        if kind == "proactive":
            mgr.set_prediction(app, payload)
            mgr.proactive_load(app, t)
        else:
            mgr.on_request(app, t)

    mean_conc = conc_acc / conc_t if conc_t else 0.0
    return SimResult(mgr.metrics(), workload, mean_conc, policy)


def sweep_policies(
    zoos: Dict[str, ModelZoo],
    *,
    deviations: Tuple[float, ...] = (0.0, 0.3, 0.6, 0.9),
    policies: Tuple[str, ...] = ("lfe", "bfe", "ws-bfe", "iws-bfe"),
    budget_mb: float = 1200.0,
    requests_per_app: int = 60,
    mean_iat_ms: float = 8000.0,
    seeds: Tuple[int, ...] = (0, 1, 2),
) -> Dict[str, Dict[float, dict]]:
    """Cross product used by the Fig 5/6/8 benchmarks."""
    out: Dict[str, Dict[float, dict]] = {p: {} for p in policies}
    apps = list(zoos)
    # Fixed system Δ: calibrated once at the nominal deviation (the
    # production predictor's accuracy), then held while test deviation
    # sweeps — this is what the paper's robustness axis measures.
    calib = generate_workload(
        apps, requests_per_app=requests_per_app,
        mean_iat_ms=mean_iat_ms, deviation=0.15, seed=max(seeds) + 1)
    delta_ms = calib.delta(1.0)
    for d in deviations:
        for p in policies:
            agg = {"cold": [], "warm": [], "fail": [], "acc": [],
                   "rob": [], "kl": []}
            for s in seeds:
                wl = generate_workload(
                    apps, requests_per_app=requests_per_app,
                    mean_iat_ms=mean_iat_ms, deviation=d, seed=s)
                res = simulate(zoos, wl, policy=p, budget_mb=budget_mb,
                               delta_ms=delta_ms)
                m = res.metrics
                agg["cold"].append(m.cold_ratio)
                agg["warm"].append(m.warm_ratio)
                agg["fail"].append(m.fail_ratio)
                agg["acc"].append(m.mean_accuracy())
                agg["rob"].append(m.robustness())
                agg["kl"].append(wl.kl)
            out[p][d] = {k: float(np.mean(v)) for k, v in agg.items()}
    return out
