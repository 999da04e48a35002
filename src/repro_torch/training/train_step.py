"""Training step factory: loss → grads → (optional compression) → AdamW.

Port of :mod:`repro.training.train_step`.  Parameters are the model's
tree of tensors (no ``nn.Module``): each step makes every leaf a fresh
autograd leaf, runs :func:`repro_torch.models.transformer.loss_fn`
through the mixed-precision cast, and takes the gradients with
``torch.autograd.grad``.  Activation remat over the blocks, microbatched
gradient accumulation, int8 error-feedback gradient compression, a
``TrainState`` of plain trees that checkpoints leaf for leaf as the
reference's does, and ZeRO data parallelism (each weight gathered and
each gradient reduced at its use), with tensor parallelism over a model
axis, on a state placed across ranks (:func:`make_train_step`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.compression import (CompressionState,
                                                 compress_grads)
from repro_torch.distributed.ctx import get_ctx, hint, tensor_parallel
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
    dp_axes=None,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    Mixed precision: parameters live in f32 (master copy, AdamW moments
    f32); f32 leaves of 2 or more dims are cast to ``compute_dtype`` for
    forward and backward, and their gradients come back through the cast
    to the f32 leaves.  ``batch`` maps names to tensors on the params'
    device (``tokens``, ``labels``, and ``patch_embeds`` for the vision
    stub).  ``grad_accum`` splits the batch into that many micro-slices,
    one backward each, gradients and loss averaged.

    **A placed state** (``DTensor`` leaves on a mesh of more than one
    device, :func:`repro_torch.distributed.sharding.place_state`) trains
    as ZeRO data parallelism, each rank on its own rows of the batch (a
    batch leaf placed ``Shard(0)`` gives its local rows), in the
    reference's ZeRO-2/FSDP layout (:mod:`repro_torch.distributed.fsdp`):
    the model reads each rank's f32 blocks, and each weight is cast to
    ``compute_dtype`` and gathered where a layer uses it (a layer's
    blocks inside the function remat checkpoints, so its recomputation
    gathers them again; the embedding at the lookup and again as a tied
    head; the head once, outside the CE chunks), its gradient summed in
    f32 over the ranks into the rank's block as the backward makes it
    (:func:`~repro_torch.distributed.sharding.scatter_sum`: a
    reduce-scatter over each data mesh dim the leaf is split on, an
    all-reduce over the others) and added into the rank's f32 buffer;
    no rank holds the whole compute copy or the whole f32 gradients.  A
    stacked leaf split on its layer dim (no layer has a block of its own)
    is gathered whole once a micro-batch.  Leaves whole over the data
    axes go in one all-reduce after the backward, the loss and metrics in
    another; the sums are divided by the data-parallel size and AdamW
    updates each rank's blocks
    (:meth:`~repro_torch.training.optim.AdamW.update`).  With
    ``grad_accum`` each micro-batch gathers and reduces again, and the
    rank's f32 blocks are summed over them, as the reference's
    constrained ``g`` and ``g_acc`` are.  With ``remat=False`` autograd
    keeps every gathered block for the backward: only the gradients are
    per use then.  The data axes are the mesh axis names ``dp_axes`` (the
    sharding context's, :func:`repro_torch.distributed.ctx.get_ctx`,
    where None).

    **Tensor parallelism.**  A mesh may have one more axis, the model
    axis, on which leaves are split as ``param_specs`` splits them
    (Megatron's layout: column-parallel in-projections, row-parallel
    out-projections, experts, the vocabulary).  Each rank then gathers its
    blocks over the data axes only, to its model-axis shard of the
    compute copy; runs forward and backward on those shards with the
    model axis installed (:func:`repro_torch.distributed.ctx.
    tensor_parallel`: the model-axis collectives run inside autograd,
    :mod:`repro_torch.distributed.tensor_parallel`); and reduces each
    gradient over the data axes only (a leaf replicated over the model
    axis has its whole gradient on every rank of it).  A config the path
    does not cover (:func:`repro_torch.models.transformer.tp_train_gaps`)
    and a leaf split on the model axis otherwise than ``param_specs``
    splits it raise ``NotImplementedError`` (ROADMAP A13).  Every
    ``moe_impl`` runs under the model axis.  ``compression`` on a placed
    state compresses each rank's blocks of the averaged gradients with the
    whole leaf's scale, its max all-reduced over the mesh dims that split
    the leaf, into an error accumulator placed as its leaf
    (:func:`repro_torch.distributed.compression.compress_grads`): the
    one-device step's compression, element for element.  The new state
    keeps the placements; no gathered copy outlives the step.

    ``zero_specs`` (a tree of partitions matching params, the launch
    cell's) names the data-sharded layout of the compute copy and the
    gradients, as the reference's ZeRO-2/FSDP constraints do; on an
    unplaced state they are layout hints that return their input, by
    :func:`repro_torch.distributed.ctx.hint`'s rule.  A placed step takes
    its layout from the state's placements and runs it per use, as
    above."""

    def _constrain(tree):
        if zero_specs is None:
            return tree
        return spec_map(lambda spec, x: hint(x, *spec), zero_specs, tree)

    def dtype_of(p):
        """The dtype a leaf computes in: ``compute_dtype`` for an f32
        leaf of 2 or more dims (a stacked leaf's dims), None (as it is)
        for the rest."""
        if (compute_dtype is not None and p.dtype == torch.float32
                and p.ndim >= 2):
            return compute_dtype
        return None

    def cast_leaf(p):
        dtype = dtype_of(p)
        return p if dtype is None else p.to(dtype)

    def cast(params):
        if compute_dtype is None:
            return params
        return _constrain(pytree.tree_map(cast_leaf, params))

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
            loss, _, g = value_and_grad(params, _micro(batch, i, grad_accum))
            g_sum = pytree.tree_map(torch.add, g_sum, g)
            l_sum = l_sum + loss
        grads = pytree.tree_map(lambda g: g / grad_accum, g_sum)
        loss = l_sum / grad_accum
        return loss, {"loss": loss}, grads

    def zero_grads(params, batch):
        """The ZeRO half of a placed step: (metrics averaged over the
        data ranks, gradients placed as ``params``), each weight gathered
        at its use and each gradient reduced as the backward makes it
        (:class:`repro_torch.distributed.fsdp.Plan`)."""
        mesh, dims, tp = _zero_layout(
            cfg, params, get_ctx().dp_axes if dp_axes is None else dp_axes)
        flat_paths, structure = pytree.flatten_with_path(params)
        flat = [p for _, p in flat_paths]
        dp = math.prod(mesh.size(i) for i in dims)
        batch = {k: SH.local_block(v) for k, v in batch.items()}
        plan = FS.Plan(flat, ["/".join(map(str, q)) for q, _ in flat_paths],
                       mesh, dims, [dtype_of(p) for p in flat])
        grads = plan.grads  # the rank's f32 blocks, summed over micro-batches
        l_sum = 0.0
        with tensor_parallel(*tp), FS.installed(plan):
            for i in range(grad_accum):
                with torch.enable_grad():
                    loss, metrics = T.loss_fn(
                        cfg, pytree.unflatten(structure, plan.tree()),
                        _micro(batch, i, grad_accum),
                        moe_impl=moe_impl, remat=remat, z_loss=z_loss)
                    loss.backward()
                l_sum = l_sum + loss.detach()
        del plan
        if grad_accum > 1:
            metrics = {"loss": l_sum / grad_accum}
        # Leaves whole over the data axes: one all-reduce for all of them.
        rep = [i for i, p in enumerate(flat) if not _split(p, dims)]
        if rep:
            buf = SH.all_reduce_dims(torch.cat(
                [grads[i].reshape(-1) for i in rep]), mesh, dims)
            for i, g in zip(rep, buf.split([grads[i].numel()
                                            for i in rep])):
                grads[i] = g.view(grads[i].shape)
        out = [SH.like_placed(p, g.div_(grad_accum * dp))
               for p, g in zip(flat, grads)]
        names = list(metrics)
        avg = SH.all_reduce_dims(torch.stack(
            [metrics[k].detach().float() for k in names]), mesh, dims) / dp
        return (dict(zip(names, avg.unbind())),
                pytree.unflatten(structure, out))

    def train_step(state: TrainState, batch):
        with torch.no_grad():
            if not _placed(state.params):
                _, metrics, grads = compute_grads(state.params, batch)
            else:
                metrics, grads = zero_grads(state.params, batch)
            comp = state.comp
            if compression:
                grads, comp = compress_grads(grads, comp)
            params, opt, opt_metrics = optimizer.update(
                grads, state.opt, state.params)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return TrainState(params, opt, comp), metrics

    return train_step


def _micro(batch: dict, i: int, n: int) -> dict:
    """Micro-slice ``i`` of ``n`` of every batch leaf's rows."""
    b = next(iter(batch.values())).shape[0] // n
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def _placed(params: PyTree) -> bool:
    """Whether a leaf is a ``DTensor`` on a mesh of more than one
    device."""
    return any(SH.is_placed(p) and p.device_mesh.size() > 1
               for p in pytree.leaves(params))


def _split(p, dims) -> list:
    """The mesh dims of ``dims`` that split the placed leaf ``p``."""
    return [i for i in dims if p.placements[i].is_shard()]


def _zero_layout(cfg: ModelConfig, params: PyTree, dp_axes):
    """(mesh, the mesh dims of ``dp_axes``, the model axis as
    ``tensor_parallel``'s arguments) of a placed state: every leaf a
    ``DTensor`` on one mesh, split over those data axes and at most one
    other mesh dim, the model axis.  A leaf split on the model axis makes
    the step tensor-parallel: every leaf must then be split on it as
    ``param_specs`` splits it, and ``cfg`` must be one that
    :func:`repro_torch.models.transformer.tp_train_gaps` passes.  Without
    such a leaf the model axis installs nothing, (None, 0, 1): its ranks
    run the same step."""
    mesh = next(p.device_mesh for p in pytree.leaves(params)
                if SH.is_placed(p))
    names = tuple(mesh.mesh_dim_names or ())
    dims = tuple(i for i, n in enumerate(names) if n in dp_axes)
    flat = pytree.flatten_with_path(params)[0]
    for path, p in flat:
        if not SH.is_placed(p) or p.device_mesh != mesh:
            raise ValueError(f"leaf {'/'.join(map(str, path))} is not "
                             "placed on the state's mesh")
        if any(q.is_partial() for q in p.placements):
            raise NotImplementedError(
                f"leaf {'/'.join(map(str, path))} is a partial sum "
                f"{p.placements} (ROADMAP A13)")
    model = [i for i in range(len(names)) if i not in dims and any(
        p.placements[i].is_shard() for _, p in flat)]
    if not model:
        return mesh, dims, (None, 0, 1)
    if len(model) > 1:
        raise NotImplementedError(
            f"leaves split on mesh axes {[names[i] for i in model]}, not data "
            f"axes {dp_axes}: one model axis at most (ROADMAP A13)")
    t = model[0]
    T.check_tp_trainable(cfg, mesh.size(t))
    want = SH.param_specs(cfg, params, SH.logical(mesh),
                          model_axis=names[t])
    for (path, p), spec in zip(flat, pytree.flatten(
            want, is_leaf=lambda x: type(x) is tuple)[0]):
        q = p.placements[t]
        dim = next((d for d, e in enumerate(spec) if e is not None and
                    names[t] in (e if isinstance(e, tuple) else (e,))), None)
        if (q.dim if q.is_shard() else None) != dim:
            raise NotImplementedError(
                f"leaf {'/'.join(map(str, path))} is {q} on the model axis "
                f"{names[t]!r}; the tensor-parallel step takes param_specs' "
                f"layout, {spec} (ROADMAP A13)")
    return mesh, dims, (mesh.get_group(t), mesh.get_local_rank(t),
                        mesh.size(t))
