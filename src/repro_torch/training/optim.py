"""AdamW with decoupled weight decay, global-norm gradient clipping and a
linear-warmup + cosine-decay schedule.

Port of :mod:`repro.training.optim` over trees of tensors (dicts, tuples,
NamedTuples; per-layer leaves stacked ``(L, ...)``), flattened in the
reference's order (:mod:`repro_torch.training.pytree`).  State is a
plain ``AdamWState``: the step count as a 0-d int32 tensor on the host
(the reference's ``step`` leaf; a checkpoint stores it) and the two
moment trees in float32.  :meth:`AdamW.update` returns new params and a
new state.  Matrices (``ndim >= 2``) are decayed, as in the reference,
where the stacked ``(L, D)`` norm weights count as matrices too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.training import pytree

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the host
    mu: PyTree
    nu: PyTree


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[int], float] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: PyTree) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=pytree.tree_map(zeros, params),
                          nu=pytree.tree_map(zeros, params))

    def update(self, grads: PyTree, state: AdamWState, params: PyTree
               ) -> tuple[PyTree, AdamWState, dict]:
        gnorm = global_norm(grads)
        flat_g, structure = pytree.flatten(grads)
        if self.clip_norm:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            flat_g = [g * scale for g in flat_g]
        # A meta step (the launch dry-run's) has no value: step 1's rate
        # stands in, and only shapes and types come out.
        step = 1 if state.step.is_meta else int(state.step) + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(flat_g, pytree.leaves(state.mu),
                              pytree.leaves(state.nu),
                              pytree.leaves(params)):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** step)
            vhat = v / (1 - b2 ** step)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay and p.ndim >= 2:  # decay matrices only
                delta = delta + self.weight_decay * p.float()
            new_p.append((p.float() - lr * delta).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return (pytree.unflatten(structure, new_p),
                AdamWState(torch.tensor(step, dtype=torch.int32,
                                        device=state.step.device),
                           pytree.unflatten(structure, new_m),
                           pytree.unflatten(structure, new_v)), metrics)


def global_norm(tree: PyTree) -> torch.Tensor:
    """The l2 norm of every leaf together, summed in the tree's own order
    (a dict's insertion order, which the serving predictor's fits have
    always used)."""
    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from walk(v)
        elif t is not None:
            yield t

    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in walk(tree)))


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[int], float]:
    """The learning rate at a step: linear from 0 to ``peak_lr`` over
    ``warmup`` steps, then a cosine down to ``floor * peak_lr`` at
    ``total``."""
    def schedule(step) -> float:
        step = float(step)
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5
                          * (1 + math.cos(math.pi * frac)))
    return schedule
