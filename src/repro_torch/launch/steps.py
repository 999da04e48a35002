"""Step functions of the launch cells (train / prefill / decode) with their
partitions.

Port of :mod:`repro.launch.steps`: the exact callables the dry-run runs
and a real launch would execute, one definition, two uses.  Each ``fn`` is
plain PyTorch over trees of tensors and takes whatever shapes and device
it is given: :mod:`repro_torch.launch.dryrun` runs it on the ``meta``
stand-ins :func:`build_cell` returns (shapes and types only: the kernel
wrappers hand ``meta`` tensors to their plain versions), and a caller may
run it on real tensors of any device (``chip_smoke.py`` runs the
``train_4k`` cell's on the card at one device's share of the batch).  The
partitions are the spec trees of :mod:`repro_torch.distributed.sharding`
on the given mesh (a :class:`~repro_torch.distributed.sharding.LogicalMesh`
or any object with ``shape``, ``axis_names`` and ``size``); the port
places nothing across devices (ROADMAP A13), so they describe the layout
a multi-device launch would give each leaf.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.specs import SHAPE_SPECS, input_specs
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training import pytree
from repro_torch.training.optim import AdamW
from repro_torch.training.train_step import abstract_state, make_train_step

# Tenants below this parameter count train in pure-DP mode: the model fits
# per-chip, so tensor parallelism would only add per-layer all-reduces.
# Both mesh axes become data axes and all state is fully ZeRO-sharded.
DP_ONLY_MAX_PARAMS = 4e9


def pure_dp(cfg: ModelConfig, shape_name: str, mesh) -> bool:
    """Whether the cell trains pure data-parallel: a train shape, a tenant
    under :data:`DP_ONLY_MAX_PARAMS`, and a global batch that the mesh's
    devices divide."""
    _, gbatch, kind = SHAPE_SPECS[shape_name]
    return (kind == "train" and cfg.param_count() < DP_ONLY_MAX_PARAMS
            and gbatch % mesh.size == 0)


def _entry(axes: tuple):
    """One partition entry over ``axes``: the name alone, or the tuple."""
    return axes if len(axes) > 1 else axes[0]


def build_cell(cfg: ModelConfig, shape_name: str, mesh, *,
               moe_impl: str = "dense", param_dtype=torch.bfloat16,
               grad_accum: int = 1, dp_only=None, qcache: bool = False):
    """Returns (fn, example_args, in_specs, out_specs, donate) for one
    (arch x shape) cell on ``mesh``: ``example_args`` are ``meta``
    stand-ins, each spec tree matches its argument (or output) leaf for
    leaf with one entry a dimension, and ``donate`` names the arguments
    whose buffers the outputs may take."""
    from repro_torch.distributed.ctx import ShardCtx, set_ctx

    kind, specs = input_specs(cfg, shape_name, quantized_cache=qcache)
    gbatch = SHAPE_SPECS[shape_name][1]
    dp = data_axes(mesh)
    if dp_only is None:
        dp_only = pure_dp(cfg, shape_name, mesh)
    if dp_only:
        dp = tuple(mesh.axis_names)  # every mesh axis is a data axis
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    set_ctx(ShardCtx(
        dp_axes=dp, model_axis="model",
        model_size=1 if dp_only else mesh.shape["model"],
        dp_size=dp_size, enabled=True))
    # Collective-saving remat unless the tenant is so large that the
    # extra saved activations would break the memory fit.
    T.set_remat_save_tp(cfg.param_count() < 5e10)

    if kind == "train":
        opt = AdamW(lr=1e-4)
        state_abs = abstract_state(cfg, opt, dtype=torch.float32)
        if dp_only:
            # no TP: compute weights replicated; state fully ZeRO-sharded
            pspecs = pytree.tree_map(lambda leaf: (None,) * leaf.dim(),
                                     state_abs.params)
        else:
            pspecs = SH.param_specs(cfg, state_abs.params, mesh)
        sspecs = SH.state_specs(cfg, state_abs, mesh, pspecs, zero1=True,
                                dp_axes=dp)
        bspecs = SH.batch_specs(cfg, specs["batch"], mesh, dp_axes=dp)
        step = make_train_step(cfg, opt, moe_impl=moe_impl, remat=True,
                               grad_accum=grad_accum,
                               zero_specs=sspecs.params)

        def fn(state, batch):
            new_state, metrics = step(state, batch)
            return new_state, metrics["loss"]

        return (fn, (state_abs, specs["batch"]), (sspecs, bspecs),
                (sspecs, ()), (0,))  # donate the train state

    params_abs = T.abstract_params(cfg, param_dtype)
    pspecs = SH.param_specs(cfg, params_abs, mesh, fsdp=True)

    if kind == "prefill":
        seq = SHAPE_SPECS[shape_name][0]
        bspecs = SH.batch_specs(cfg, specs["batch"], mesh, dp_axes=dp)
        # prefill's cache: init_cache at max_len=seq, as it builds it
        cache_abs = T.abstract_cache(cfg, gbatch, seq)
        cspecs = SH.cache_specs(cfg, cache_abs, mesh, dp_axes=dp)

        def fn(params, batch):
            logits, cache = T.prefill(cfg, params, batch, max_len=seq)
            return T.greedy_token(cfg, logits), cache

        tok_spec = (_entry(dp),) + (None,) * (cfg.num_codebooks > 1)
        return (fn, (params_abs, specs["batch"]), (pspecs, bspecs),
                (tok_spec, cspecs), ())

    # decode
    tok_abs, cache_abs = specs["tokens"], specs["cache"]
    cspecs = SH.cache_specs(cfg, cache_abs, mesh, dp_axes=dp)
    tok_sh = ((_entry(dp) if tok_abs.shape[0] % dp_size == 0 else None,)
              + (None,) * (tok_abs.dim() - 1))

    def fn(params, cache, tokens):
        logits, new_cache = T.decode_step(cfg, params, cache, tokens,
                                          moe_impl=moe_impl,
                                          uniform_pos=True)
        return T.greedy_token(cfg, logits), new_cache

    return (fn, (params_abs, cache_abs, tok_abs), (pspecs, cspecs, tok_sh),
            (tok_sh, cspecs), (1,))  # donate the KV cache
