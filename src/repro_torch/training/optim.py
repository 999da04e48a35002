"""AdamW with decoupled weight decay and global-norm gradient clipping.

Port of :class:`repro.training.optim.AdamW` over dicts of tensors.  State
is a plain ``AdamWState`` (step count and the two moment dicts), updated
functionally: :meth:`AdamW.update` returns new params and a new state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    mu: Params
    nu: Params


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[int], float] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Params) -> AdamWState:
        return AdamWState(
            step=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()})

    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> tuple[Params, AdamWState, dict]:
        gnorm = global_norm(grads)
        if self.clip_norm:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state.mu[k] + (1 - b1) * g
            v = b2 * state.nu[k] + (1 - b2) * g * g
            mhat = m / (1 - b1 ** step)
            vhat = v / (1 - b2 ** step)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay and p.ndim >= 2:  # decay matrices only
                delta = delta + self.weight_decay * p.float()
            new_p[k] = (p.float() - lr * delta).to(p.dtype)
            new_m[k], new_v[k] = m, v
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_p, AdamWState(step, new_m, new_v), metrics


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tree.values()))
