"""AdamW with decoupled weight decay, global-norm gradient clipping and a
linear-warmup + cosine-decay schedule.

Port of :mod:`repro.training.optim` over trees of tensors (dicts, tuples,
NamedTuples; per-layer leaves stacked ``(L, ...)``), flattened in the
reference's order (:mod:`repro_torch.training.pytree`).  State is a
plain ``AdamWState``: the step count as a 0-d int32 tensor on the host
(the reference's ``step`` leaf; a checkpoint stores it) and the two
moment trees in float32.  :meth:`AdamW.update` returns new params and a
new state.  Matrices (``ndim >= 2``) are decayed, as in the reference,
where the stacked ``(L, D)`` norm weights count as matrices too.  A state
placed across ranks (``DTensor`` leaves, a ZeRO step's) is updated block
by block on each rank, the gradient norm summed over the ranks
(:func:`global_norm`) and the decay decided by the whole leaf's rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (all_reduce_dims, like_placed,
                                              local_block)
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
        step_t = local_block(state.step)
        # A meta step (the launch dry-run's) has no value: step 1's rate
        # stands in, and only shapes and types come out.
        step = 1 if step_t.is_meta else int(step_t) + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(flat_g, pytree.leaves(state.mu),
                              pytree.leaves(state.nu),
                              pytree.leaves(params)):
            decay = self.weight_decay and p.ndim >= 2  # matrices only
            # A placed leaf updates its own block (the moments and the
            # gradient are split as the parameter is).
            g, m, v, q = (local_block(t) for t in (g, m, v, p))
            if self.clip_norm:
                g = g * scale
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** step)
            vhat = v / (1 - b2 ** step)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if decay:
                delta = delta + self.weight_decay * q.float()
            new_p.append(like_placed(p, (q.float() - lr * delta).to(q.dtype)))
            new_m.append(like_placed(p, m))
            new_v.append(like_placed(p, v))
        metrics = {"grad_norm": gnorm, "lr": lr}
        return (pytree.unflatten(structure, new_p),
                AdamWState(like_placed(state.step, torch.tensor(
                    step, dtype=torch.int32, device=step_t.device)),
                           pytree.unflatten(structure, new_m),
                           pytree.unflatten(structure, new_v)), metrics)


def global_norm(tree: PyTree) -> torch.Tensor:
    """The l2 norm of every leaf together, summed in the tree's own order
    (a dict's insertion order, which the serving predictor's fits have
    always used).  A tree of placed leaves (``DTensor``s, a ZeRO step's
    gradients) sums each rank's blocks and all-reduces the sum over every
    dim of their mesh, a block that several ranks hold counted on the
    first of them alone."""
    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from walk(v)
        elif t is not None:
            yield t

    leaves = list(walk(tree))
    if not isinstance(leaves[0], DTensor):
        return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in leaves))
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for t in leaves:
        if all(c == 0 for c, p in zip(coord, t.placements)
               if not p.is_shard()):
            total = total + torch.sum(t.to_local().float() ** 2)
    return torch.sqrt(all_reduce_dims(total, mesh, range(mesh.ndim)))


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
