"""The paper's two lightweight many-to-one vanilla RNN predictors
(§III-A "NN Model Manager"), trained with torch autograd:

* **Request predictor** — consumes the recent inter-arrival history of one
  application and predicts the next inter-arrival gap (hence the next
  request time).
* **Memory predictor** — consumes the recent sequence of memory-usage
  samples and predicts availability at the next decision point.

Both are the same tiny architecture (the paper calls it "edge-friendly"):
one tanh RNN cell + linear head, trained with AdamW on sliding windows.
Port of :mod:`repro.core.predictor`; the RNN lives on ``device``.
No hand-written kernel is warranted — the model is a few thousand FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.training.optim import AdamW


def init_rnn(g: torch.Generator, hidden: int = 32,
             device="cpu") -> dict:
    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    return {
        "wx": normal(1, hidden) * 0.5,
        "wh": normal(hidden, hidden) * hidden ** -0.5,
        "b": torch.zeros((hidden,), device=device),
        "wo": normal(hidden, 1) * hidden ** -0.5,
        "bo": torch.zeros((1,), device=device),
    }


def rnn_forward(params: dict, xs: torch.Tensor) -> torch.Tensor:
    """xs: (B, T) normalized series -> (B,) prediction (many-to-one)."""
    B, T = xs.shape
    h = torch.zeros((B, params["wh"].shape[0]), device=xs.device)
    for t in range(T):
        h = torch.tanh(xs[:, t:t + 1] @ params["wx"] + h @ params["wh"]
                       + params["b"])
    return (h @ params["wo"] + params["bo"])[:, 0]


def _fit(params, opt_state, xs, ys, *, steps: int = 200):
    opt = AdamW(lr=1e-2, weight_decay=0.0, clip_norm=1.0)
    losses = []
    for _ in range(steps):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = torch.mean((rnn_forward(p, xs) - ys) ** 2)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            params, opt_state, _ = opt.update(
                dict(zip(p, grads)), opt_state, params)
        losses.append(loss.detach())
    return params, opt_state, torch.stack(losses)


@dataclass
class SeriesPredictor:
    """Sliding-window RNN regressor over a scalar series.

    ``min_fit_samples`` / ``refit_interval`` drive the serving runtime's
    *background* training schedule: once the history holds at least
    ``min_fit_samples`` observations, :meth:`fit_due` turns true, and
    again every ``refit_interval`` further observations — the server
    hands due predictors to the loader's staging worker
    (``BackgroundLoader.submit_fit``) so training never blocks the
    serving loop.
    """
    context: int = 16
    hidden: int = 32
    seed: int = 0
    min_fit_samples: int = 24
    refit_interval: int = 16
    fit_steps: int = 150  # AdamW steps per background fit
    device: str = "cpu"  # where the RNN's parameters live and train

    def __post_init__(self):
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = init_rnn(g, self.hidden, self.device)
        self.opt_state = AdamW(lr=1e-2, weight_decay=0.0).init(self.params)
        self.mean = 1.0
        self.history: list[float] = []
        self.losses: Optional[np.ndarray] = None
        self.fits = 0  # completed fit() calls
        self._fit_len = 0  # history length at the last completed fit
        # Pre-refactor reference cost model: materialize the whole
        # history per predict() (see predict's comment).
        self.full_history_predict = False

    def observe(self, value: float) -> None:
        self.history.append(float(value))

    def fit_due(self) -> bool:
        """Enough new history to (re)train?  False until
        ``min_fit_samples`` accumulate, then true every
        ``refit_interval`` observations past the previous fit."""
        n = len(self.history)
        if n < max(self.min_fit_samples, self.context + 2):
            return False
        return self._fit_len == 0 or n - self._fit_len >= self.refit_interval

    def fit(self, steps: int = 200) -> float:
        """Train on all (context -> next) windows in the history.
        Returns the final training loss.  Safe to run off-thread while
        the owner keeps observing: the history is snapshotted, and the
        trained parameters land in one reference swap."""
        h = np.asarray(list(self.history), np.float32)
        if len(h) < self.context + 2:
            return float("nan")
        self.mean = float(np.mean(h)) or 1.0
        hn = h / self.mean
        windows = np.lib.stride_tricks.sliding_window_view(
            hn, self.context + 1)
        xs = torch.as_tensor(windows[:, :-1], device=self.device)
        ys = torch.as_tensor(windows[:, -1], device=self.device)
        self.params, self.opt_state, losses = _fit(
            self.params, self.opt_state, xs, ys, steps=steps)
        self.losses = losses.cpu().numpy()
        self.fits += 1
        self._fit_len = len(h)
        return float(losses[-1])

    def predict(self) -> float:
        """Predict the next value from the trailing context.

        The normalizer is recomputed from the trailing context rather than
        taken from ``self.mean``: the history keeps growing between
        ``fit()`` calls (the serving engine observes every arrival), so
        the fit-time mean goes stale and a drifting series would be fed to
        the RNN at the wrong scale.  Before the first ``fit()`` the RNN
        weights are random, so the running mean of the context *is* the
        prediction — the same fallback used while history is short.
        """
        # Only the trailing context is ever read, so only it is
        # materialized — the history list grows unboundedly under the
        # serving engine, and converting all of it per call would make
        # each prediction O(history).  Bit-identical: the slice holds
        # the same elements the full-array path reads, so either branch
        # returns the same floats.  ``full_history_predict`` keeps the
        # pre-refactor O(history) materialization — the serving
        # engine's ``scheduler="linear"`` reference path sets it so the
        # fast-path A/B measures against a cost-faithful baseline.
        if self.full_history_predict:
            h = np.asarray(self.history, np.float32)
        else:
            h = np.asarray(self.history[-self.context:], np.float32)
        if len(h) < self.context:
            return float(np.mean(h)) if len(h) else self.mean
        ctx = h[-self.context:]
        mean = float(np.mean(ctx)) or 1.0
        if self.losses is None:  # never fit: untrained RNN is noise
            return mean
        xs = torch.as_tensor(ctx / mean, device=self.device)[None]
        with torch.no_grad():
            return float(rnn_forward(self.params, xs)[0] * mean)


class RequestPredictor(SeriesPredictor):
    """Predicts the next request *time* of one application from its
    inter-arrival history."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.last_time: Optional[float] = None

    def observe_request(self, t: float) -> None:
        if self.last_time is not None:
            self.observe(max(t - self.last_time, 1e-6))
        self.last_time = t

    def predict_next_time(self) -> float:
        if self.last_time is None:
            return float("inf")
        gap = max(self.predict(), 1e-6)
        return self.last_time + gap


class MemoryPredictor(SeriesPredictor):
    """Predicts near-future memory availability from recent usage samples."""

    def predict_free(self, budget: float) -> float:
        used = self.predict()
        return max(budget - used, 0.0)
