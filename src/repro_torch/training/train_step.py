"""Training step factory: loss → grads → (optional compression) → AdamW.

Port of :mod:`repro.training.train_step`.  Parameters are the model's
tree of tensors (no ``nn.Module``): each step makes every leaf a fresh
autograd leaf, runs :func:`repro_torch.models.transformer.loss_fn`
through the mixed-precision cast, and takes the gradients with
``torch.autograd.grad``.  Activation remat over the blocks, microbatched
gradient accumulation, int8 error-feedback gradient compression, and a
``TrainState`` of plain trees that checkpoints leaf for leaf as the
reference's does.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.distributed.compression import (CompressionState,
                                                 compress_grads)
from repro_torch.distributed.ctx import hint
from repro_torch.distributed.sharding import spec_map
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training import pytree
from repro_torch.training.optim import AdamW, AdamWState

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: AdamWState
    comp: Optional[CompressionState]


def init_state(cfg: ModelConfig, seed: int, optimizer: AdamW,
               dtype=torch.float32, compression: bool = False,
               device="cuda") -> TrainState:
    """Parameters from ``seed`` (the port's initializer) on ``device``,
    zeroed moments and, with ``compression``, a zeroed error
    accumulator."""
    params = T.init_params(cfg, seed, dtype, device=device)
    return state_from_params(params, optimizer, compression)


def abstract_state(cfg: ModelConfig, optimizer: AdamW, dtype=torch.float32,
                   compression: bool = False) -> TrainState:
    """The state's shapes and types on the ``meta`` device, leaf for leaf
    the reference's ``jax.eval_shape`` of ``init_state``: nothing is
    allocated."""
    params = T.abstract_params(cfg, dtype)
    state = state_from_params(params, optimizer, compression)
    return state._replace(opt=state.opt._replace(
        step=state.opt.step.to("meta")))


def state_from_params(params: PyTree, optimizer: AdamW,
                      compression: bool = False) -> TrainState:
    """A fresh ``TrainState`` around given parameters (a reference
    model's, carried over with ``params_from_numpy``)."""
    comp = CompressionState.init(params) if compression else None
    return TrainState(params, optimizer.init(params), comp)


def make_train_step(
    cfg: ModelConfig,
    optimizer: AdamW,
    *,
    moe_impl: str = "dense",
    remat: bool = True,
    grad_accum: int = 1,
    compression: bool = False,
    z_loss: float = 1e-4,
    compute_dtype=torch.bfloat16,
    zero_specs=None,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    Mixed precision: parameters live in f32 (master copy, AdamW moments
    f32); f32 leaves of 2 or more dims are cast to ``compute_dtype`` for
    forward and backward, and their gradients come back through the cast
    to the f32 leaves.  ``batch`` maps names to tensors on the params'
    device (``tokens``, ``labels``, and ``patch_embeds`` for the vision
    stub).  ``grad_accum`` splits the batch into that many micro-slices,
    one backward each, gradients and loss averaged.

    ``zero_specs`` (a tree of partitions matching params, the launch
    cell's) names the data-sharded layout of the compute copy and the
    gradients, as the reference's ZeRO-2/FSDP constraints do.  On one
    process they are layout hints that return their input, by
    :func:`repro_torch.distributed.ctx.hint`'s rule; a step whose state
    is placed on a device mesh of more than one device raises (ROADMAP
    A13)."""

    def _constrain(tree):
        if zero_specs is None:
            return tree
        return spec_map(lambda spec, x: hint(x, *spec), zero_specs, tree)

    def cast(params):
        if compute_dtype is None:
            return params
        return _constrain(pytree.tree_map(
            lambda p: p.to(compute_dtype)
            if p.dtype == torch.float32 and p.ndim >= 2 else p, params))

    def value_and_grad(params, batch):
        flat, structure = pytree.flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss, metrics = T.loss_fn(
                cfg, cast(pytree.unflatten(structure, leaves)), batch,
                moe_impl=moe_impl, remat=remat, z_loss=z_loss)
            grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics,
                _constrain(pytree.unflatten(structure, grads)))

    def compute_grads(params, batch):
        if grad_accum == 1:
            return value_and_grad(params, batch)
        g_sum = pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        l_sum = 0.0
        for i in range(grad_accum):
            def micro(x):
                b = x.shape[0] // grad_accum
                return x[i * b:(i + 1) * b]

            loss, _, g = value_and_grad(
                params, {k: micro(v) for k, v in batch.items()})
            g_sum = pytree.tree_map(torch.add, g_sum, g)
            l_sum = l_sum + loss
        grads = pytree.tree_map(lambda g: g / grad_accum, g_sum)
        loss = l_sum / grad_accum
        return loss, {"loss": loss}, grads

    def train_step(state: TrainState, batch):
        if zero_specs is not None and _placed(state.params):
            raise NotImplementedError(
                "zero_specs on a state placed across devices (ZeRO-2/FSDP "
                "constraints of a sharded step): ROADMAP A13")
        with torch.no_grad():
            loss, metrics, grads = compute_grads(state.params, batch)
            comp = state.comp
            if compression:
                grads, comp = compress_grads(grads, comp)
            params, opt, opt_metrics = optimizer.update(
                grads, state.opt, state.params)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return TrainState(params, opt, comp), metrics

    return train_step


def _placed(params: PyTree) -> bool:
    """Whether a leaf is a ``DTensor`` on a mesh of more than one
    device."""
    return any(getattr(p, "device_mesh", None) is not None
               and p.device_mesh.size() > 1 for p in pytree.leaves(params))
