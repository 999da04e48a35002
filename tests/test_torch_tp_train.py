"""Tensor-parallel training on local shards (ROADMAP A13, training): the
port's ``make_train_step`` on a state placed by ``param_specs`` (leaves
split on the model axis) and ZeRO-split over the data axis, on gloo CPU
ranks, against the JAX package's one-device step on the whole batch.

Each world runs in a child process that forks its ranks
(``start_processes(..., start_method="fork")``; the ranks meet through a
file under the test's directory), as ``tests/test_torch_zero.py`` does;
the children run while this process compiles the reference's steps.
Worlds:

- (model 2), 2 ranks: reduced yi-6b, olmoe-1b-7b and llama4-scout, each
  layer's KV heads split over the ranks;
- (data 2, model 2), 4 ranks: yi-6b and olmoe-1b-7b, each data rank on
  its own rows, the f32 master and moments also split over the data axis;
- (model 4), 4 ranks: llama4-scout, whose 2 KV heads are fewer than the
  ranks (k and v gathered whole, each rank the head its query head reads),
  olmoe-1b-7b, and yi-6b, whose 6 query heads the axis does not divide
  (1.5 heads of columns a rank: q gathered whole, the ranks take 2, 2, 1
  and 1 heads, rank 1's straddling both KV groups, k and v gathered whole
  and repeated to each of a rank's query heads; the attention output
  gathered back and each rank takes its rows of ``wo``).

Held, from the reference's weights (``params_from_numpy``), as
``tests/test_torch_zero.py`` holds the ZeRO step:

- step 1 (f32 compute) against ``jax.jit(make_train_step(...,
  compute_dtype=None))``'s: loss, gradient norm, params and both moments
  at ``rtol=atol=3e-5``, a step's params and moments but at its
  ill-conditioned elements (``test_torch_training.ill_conditioned``);
- step 2 with ``grad_accum=2`` from the world's own step-1 state;
- a bf16 compute copy (yi-6b on 2 ranks) at 3e-2 relative l2;
- the vocabulary-parallel cross entropy (``head_loss`` on a rank's head
  columns, on (model 2) and (model 4)) against the reference's
  ``loss_fn`` on the whole head, both given the same final hidden states:
  loss and nll at 3e-5, accuracy equal, the hidden states' and the
  head's gradients at 3e-5; with padding columns on the last rank, and
  with two ranks tied on every row's max (the lowest index wins);
- the (data 2, model 2) state saved with ``checkpoint.save``, restored
  onto one process bit-equal;
- ``global_norm`` of a placed tree whose leaves are split on the model
  axis, the data axis, both or neither: the whole tree's norm;
- mamba2-780m and hymba-1.5b placed on the model axis: the step raises,
  naming ``tp_train_gaps``' words and ROADMAP A13;
- the ``ragged`` and ``local`` MoE (reduced olmoe-1b-7b, 8 experts, top-2;
  reduced llama4-scout, 4 experts, top-1 and a shared expert) in every
  world: step 1 and step 2 (``grad_accum=2``) against the reference's step
  with the same ``moe_impl`` (``local`` on a (1, 1) mesh, and on
  (data 2, model 2) jitted on a (2, 2) mesh of fake CPU devices in a
  subprocess, its capacity a data shard's); step 1 on a batch of one
  token repeated, whose routing overflows the capacity and leaves a
  rank's experts without a slot (both seen in the ranks' routing);
- ``compression=True`` on the (data 2, model 2) state of yi-6b: steps 1
  and 2 and the error accumulator against the reference's one-device
  compressed step;
- the per-use form on (data 2, model 2): yi-6b at 4 layers, its data
  axis's gathers and reduce-scatters in order and its gathered bytes
  within two use sites (``test_torch_zero.USES``), and ``UseSite``'s
  gradient with the model-axis split kept local.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch.mesh import make_mesh_compat
from repro.models import transformer as JT
from repro.training import optim as JO
from repro.training import train_step as JS
from repro_torch.configs import get_config as tget
from repro_torch.distributed import checkpoint as CK
from repro_torch.models import transformer as TT
from repro_torch.training import optim as TO
from repro_torch.training import pytree
from repro_torch.training import train_step as TS
from test_torch_training import (BF16_REL_L2, LR, STEP_BOUND, Z, hold,
                                 ill_conditioned, make_batch, np_tree,
                                 step_grads)
from test_torch_zero import (USE_LAYERS, USES, _flat_np, _hold_step,
                             _jstate, _leaves, _port_inputs, hold_high_water,
                             hold_use_order, use_events)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YI, OLMOE, SCOUT = "yi-6b", "olmoe-1b-7b", "llama4-scout-17b-a16e"
ARCHS = (YI, OLMOE, SCOUT)
# world name -> (mesh shape, mesh axis names, archs trained, jobs)
WORLDS = {
    "model2": ((2,), ("model",), ARCHS,
               ("train", "bf16", "gaps", "ce", "moe")),
    "data2model2": ((2, 2), ("data", "model"), (YI, OLMOE),
                    ("train", "save", "norm", "moe", "comp", "uses")),
    "model4": ((4,), ("model",), (SCOUT, OLMOE, YI), ("train", "ce", "moe")),
}
RUNS = [(w, a) for w, (_, _, archs, _) in WORLDS.items() for a in archs]
# The MoE forms that route slots (every world runs both, step 1 and step 2):
MOE_ARCHS = (OLMOE, SCOUT)
MOE_IMPLS = ("ragged", "local")
MOE_RUNS = [(w, a, i) for w in WORLDS for a in MOE_ARCHS for i in MOE_IMPLS]
# The batch of one token repeated (every token routes alike: each chosen
# expert gets every slot, more than the capacity, and a rank whose experts
# are not chosen gets none): (4, 16) on the model worlds; on (data 2,
# model 2) (4, 32), so that a data rank's 64 tokens overflow its capacity
# of 32, and ``local`` only (``ragged`` has no capacity).
OVER_TOKEN = 7
OVER_RUNS = [(w, a, i) for w, a, i in MOE_RUNS
             if w != "data2model2" or i == "local"]
COMP_ARCH = YI
# The per-use record (``test_torch_zero.USES``) on (data 2, model 2).
USE_ARCH = YI
B, S = 4, 16
CKPT_ARCH = YI
GAP_ARCHS = ("mamba2-780m", "hymba-1.5b")
# The cross entropy's cases (reduced yi-6b's head, 160 columns): random;
# the vocabulary cut to 150 (the last rank's columns end in padding); two
# columns on different ranks of either world equal and above the rest.
CE_WORLDS = [w for w, (*_, jobs) in WORLDS.items() if "ce" in jobs]
CE_CASES = ("plain", "padded", "tie")
CE_TIE = (30, 130)
CE_CHUNK = 6  # two checkpointed chunks of 16 positions and a remainder

CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, "src")
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def load(path):
        tree = {}
        for key, a in np.load(path).items():
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = a
        return tree

    def specs(cfg, state, mesh):
        from repro_torch.distributed import sharding as SH
        lm = SH.logical(mesh)
        return SH.state_specs(cfg, state, lm,
                              SH.param_specs(cfg, state.params, lm))

    def setup(arch, root, mesh, compression=False):
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.training import optim
        from repro_torch.training import train_step as TS

        cfg = get_config(arch, reduced=True)
        opt = optim.AdamW(lr=1e-3)
        state = TS.state_from_params(
            T.params_from_numpy(load(f"{root}/params-{arch}.npz")), opt,
            compression)
        return cfg, opt, state, specs(cfg, state, mesh)

    def rows(root, arch, mesh, name="batch"):
        batch = {k: torch.from_numpy(v)
                 for k, v in np.load(f"{root}/{name}-{arch}.npz").items()}
        names = mesh.mesh_dim_names
        if "data" not in names:
            return batch
        i = names.index("data")
        n = batch["tokens"].shape[0] // mesh.size(i)
        r = mesh.get_coordinate()[i]
        return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}

    def whole(tree):
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import pytree
        return [(SH.whole(t) if SH.is_placed(t) else t).numpy()
                for t in pytree.leaves(tree)]

    def put(out, key, state, metrics):
        for field, tree in (("params", state.params), ("mu", state.opt.mu),
                            ("nu", state.opt.nu)):
            for i, a in enumerate(whole(tree)):
                out[f"{key}/{field}/{i:03d}"] = a
        if state.comp is not None:
            for i, a in enumerate(whole(state.comp.error)):
                out[f"{key}/error/{i:03d}"] = a
        out[f"{key}/step"] = np.array(int(state.opt.step.full_tensor()))
        for k in ("loss", "grad_norm"):
            out[f"{key}/{k}"] = np.array(float(metrics[k]))

    def train(root, mesh, out):
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import pytree
        from repro_torch.training import train_step as TS

        for arch in ARCHS_RUN:
            ARCH_NOW[0] = arch
            cfg, opt, state, sspecs = setup(arch, root, mesh)
            placed = SH.place_state(state, mesh, sspecs)
            out[f"{arch}/whole_equal"] = np.array(all(
                np.array_equal(a, b.numpy()) for a, b in zip(
                    whole(placed), pytree.leaves(state))))
            out[f"{arch}/bytes"] = np.array(SH.rank_nbytes(placed))
            lm = SH.logical(mesh)
            spec_bytes = [0]
            SH.spec_map(lambda sp, t: spec_bytes.__setitem__(
                0, spec_bytes[0] + t.numel() * t.element_size()
                // SH._divisor(sp, lm)), sspecs, state)
            out[f"{arch}/spec_bytes"] = np.array(spec_bytes[0])
            model = mesh.mesh_dim_names.index("model")
            out[f"{arch}/model_split"] = np.array(sum(
                p.placements[model].is_shard()
                for p in pytree.leaves(placed.params)))
            mine = rows(root, arch, mesh)
            one, m1 = TS.make_train_step(cfg, opt, compute_dtype=None)(
                placed, mine)
            put(out, f"{arch}/1", one, m1)
            two, m2 = TS.make_train_step(cfg, opt, compute_dtype=None,
                                         grad_accum=2)(one, mine)
            put(out, f"{arch}/2", two, m2)
            if arch == CKPT_ARCH and "save" in JOBS_RUN:
                from repro_torch.distributed import checkpoint
                checkpoint.save(two, f"{root}/ckpt", 2)

    def moe(root, mesh, out):
        # The routed MoE forms on the placed state: step 1 and step 2
        # (grad_accum=2) on the arch's batch, step 1 on the repeated token.
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import train_step as TS

        data = "data" in mesh.mesh_dim_names
        for arch in MOE_ARCHS:
            ARCH_NOW[0] = arch
            for impl in MOE_IMPLS:
                cfg, opt, state, sspecs = setup(arch, root, mesh)
                placed = SH.place_state(state, mesh, sspecs)
                kw = dict(compute_dtype=None, moe_impl=impl)
                key = f"{arch}/{impl}"
                ROUTE_NOW[0] = f"{key}/1"
                one, m1 = TS.make_train_step(cfg, opt, **kw)(
                    placed, rows(root, arch, mesh))
                put(out, f"{key}/1", one, m1)
                ROUTE_NOW[0] = f"{key}/2"
                two, m2 = TS.make_train_step(cfg, opt, grad_accum=2, **kw)(
                    one, rows(root, arch, mesh))
                put(out, f"{key}/2", two, m2)
                if data and impl != "local":
                    continue
                ROUTE_NOW[0] = f"{key}/over"
                over, m3 = TS.make_train_step(cfg, opt, **kw)(
                    placed, rows(root, arch, mesh, "over"))
                put(out, f"{key}/over", over, m3)
        ROUTE_NOW[0] = None

    def comp(root, mesh, out):
        # compression=True on the placed state: two steps, the error
        # accumulator placed as its leaves.
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import train_step as TS

        ARCH_NOW[0] = COMP_ARCH
        cfg, opt, state, sspecs = setup(COMP_ARCH, root, mesh, True)
        step = TS.make_train_step(cfg, opt, compute_dtype=None,
                                  compression=True)
        mine = rows(root, COMP_ARCH, mesh)
        one, m1 = step(SH.place_state(state, mesh, sspecs), mine)
        put(out, "comp/1", one, m1)
        two, m2 = step(one, mine)
        put(out, "comp/2", two, m2)

    def routing():
        # Each routed MoE call's (rows, slots this rank's experts received,
        # the most slots one expert received) under ROUTE_NOW's key.
        from repro_torch.models import layers as L
        seen = {}

        def wrap(fn):
            def call(cfg, lp, xt, topi, topv):
                if ROUTE_NOW[0] is not None:
                    first = L._first_expert(cfg, lp["we_g"])
                    e = topi.reshape(-1)
                    mine = ((e >= first)
                            & (e < first + lp["we_g"].shape[0])).sum()
                    most = torch.bincount(e, minlength=cfg.num_experts).max()
                    seen.setdefault(ROUTE_NOW[0], []).append(
                        (xt.shape[0], int(mine), int(most)))
                return fn(cfg, lp, xt, topi, topv)
            return call

        L._moe_ragged = wrap(L._moe_ragged)
        L._moe_local = wrap(L._moe_local)
        return seen

    def bf16(root, mesh, out):
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import train_step as TS

        cfg, opt, state, sspecs = setup(CKPT_ARCH, root, mesh)
        new, m = TS.make_train_step(cfg, opt)(
            SH.place_state(state, mesh, sspecs), rows(root, CKPT_ARCH, mesh))
        put(out, "bf16", new, m)

    def gaps(root, mesh, out):
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import optim
        from repro_torch.training import train_step as TS

        for arch in GAP_ARCHS:
            cfg = get_config(arch, reduced=True)
            opt = optim.AdamW(lr=1e-3)
            state = TS.init_state(cfg, 0, opt, device="cpu")
            placed = SH.place_state(state, mesh, specs(cfg, state, mesh))
            try:
                TS.make_train_step(cfg, opt)(placed, {})
                out[f"gaps/{arch}"] = np.array("trained")
            except NotImplementedError as e:
                out[f"gaps/{arch}"] = np.array(str(e))

    def norm(root, mesh, out):
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import optim, pytree

        for arch in ARCHS_RUN:
            cfg, opt, state, sspecs = setup(arch, root, mesh)
            g = torch.Generator().manual_seed(7)
            tree = pytree.tree_map(
                lambda p: torch.randn(p.shape, generator=g), state.params)
            kinds = set()
            for tag, sp in (("zero", sspecs.params), ("tp", SH.param_specs(
                    cfg, state.params, SH.logical(mesh)))):
                placed = SH.place_tree(tree, mesh, sp)
                for p in pytree.leaves(placed):
                    kinds.add(tuple(q.is_shard() for q in p.placements))
                out[f"norm/{arch}/{tag}"] = np.array(
                    float(optim.global_norm(placed)))
            out[f"norm/{arch}/kinds"] = np.array(sorted(kinds))
            out[f"norm/{arch}/whole"] = np.array(
                float(optim.global_norm(tree)))

    def ce(root, mesh, out):
        # head_loss (loss_fn past forward_hidden) on the rank's head
        # columns under the model axis.
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.distributed.ctx import tensor_parallel
        from repro_torch.models import transformer as T

        model = mesh.mesh_dim_names.index("model")
        group, m = mesh.get_group(model), mesh.size(model)
        r = mesh.get_local_rank(model)
        chunk = T.CE_CHUNK
        for case in CE_CASES:
            f = dict(np.load(f"{root}/ce-{case}.npz"))
            T.CE_CHUNK = int(f["chunk"])
            cfg = dataclasses.replace(get_config(CKPT_ARCH, reduced=True),
                                      vocab_size=int(f["vocab"]))
            w = f["head"].shape[-1] // m
            hidden = torch.from_numpy(f["hidden"]).requires_grad_()
            head = torch.from_numpy(
                f["head"][..., r * w:(r + 1) * w].copy()).requires_grad_()
            with tensor_parallel(group, r, m):
                loss, met = T.head_loss(cfg, hidden, head,
                                        torch.from_numpy(f["labels"]),
                                        z_loss=float(f["z"]))
                loss.backward()
            heads = [None] * m
            dist.all_gather_object(heads, head.grad.numpy(), group=group)
            out[f"ce/{case}/head"] = np.concatenate(heads, -1)
            out[f"ce/{case}/hidden"] = hidden.grad.numpy()
            for k in ("loss", "nll", "accuracy"):
                out[f"ce/{case}/{k}"] = np.array(float(met[k]))
        T.CE_CHUNK = chunk

    def attention_inputs():
        # Each ops.flash_attention call's (arch, q, k and v contiguous or
        # not, local query heads, local KV heads) (the CUDA wrapper refuses
        # a strided view; the CPU's plain version takes it): the list the
        # calls append to.
        from repro_torch.kernels import ops
        seen, fa = [], ops.flash_attention

        def call(q, k, v, *a, **kw):
            seen.append((ARCH_NOW[0], all(t.is_contiguous()
                                          for t in (q, k, v)),
                         q.shape[2], k.shape[2]))
            return fa(q, k, v, *a, **kw)

        ops.flash_attention = call
        return seen

    def uses(root, mesh, out):
        # USE_ARCH at USE_LAYERS layers by param_specs and ZeRO-1 from seed
        # 0, each data rank on its rows of a batch from seed 1; UseSite's
        # gradient over the data axis, the model-axis split kept.
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.training import optim
        from repro_torch.training import train_step as TS

        cfg = dataclasses.replace(get_config(USE_ARCH, reduced=True),
                                  num_layers=USE_LAYERS)
        state = TS.init_state(cfg, 0, optim.AdamW(lr=1e-3), device="cpu")
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
                 for k in ("tokens", "labels")}
        d = mesh.mesh_dim_names.index("data")
        r = mesh.get_coordinate()[d]
        record_uses(USE_ARCH, cfg, state, specs(cfg, state, mesh), mesh,
                    {k: v[2 * r:2 * r + 2] for k, v in batch.items()},
                    ("data",), out)
        use_site_grad(dist.get_rank(), mesh, [d], out)

    JOBS = {"train": train, "bf16": bf16, "gaps": gaps, "norm": norm,
            "ce": ce, "moe": moe, "comp": comp, "uses": uses}
    JOBS_RUN = ()
    ARCHS_RUN = ()
    ARCH_NOW = [None]
    ROUTE_NOW = [None]

    def run(rank, root, shape, names, archs, jobs):
        global JOBS_RUN, ARCHS_RUN
        from repro_torch.launch.mesh import make_mesh

        JOBS_RUN, ARCHS_RUN = jobs, archs
        torch.set_num_threads(1)
        world = int(np.prod(shape))
        dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                                rank=rank, world_size=world)
        mesh = make_mesh(shape, names, "cpu")
        out = {}
        seen = attention_inputs()
        routes = routing()
        for job in jobs:
            if job in JOBS:
                JOBS[job](root, mesh, out)
        every = [None] * world
        dist.all_gather_object(every, routes)
        for r, got in enumerate(every):
            for key, calls in got.items():
                out[f"route/{key}/{r}"] = np.array(calls)
        out["attention_contiguous"] = np.array([c for _, c, *_ in seen])
        every = [None] * world
        dist.all_gather_object(every, sorted({(a, h, kv)
                                              for a, _, h, kv in seen}))
        for r, heads in enumerate(every):
            for a in archs:
                out[f"attention_heads/{a}/{r}"] = np.array(
                    [(h, kv) for b, h, kv in heads if b == a])
        if rank == 0:  # whole, or not there (a reader polls for it)
            np.savez(f"{root}/out.tmp.npz", **out)
            os.replace(f"{root}/out.tmp.npz", f"{root}/out.npz")
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        root = sys.argv[1]
        shape = tuple(int(x) for x in sys.argv[2].split(","))
        names = tuple(sys.argv[3].split(","))
        archs = tuple(sys.argv[4].split(","))
        jobs = tuple(sys.argv[5].split(","))
        mp.start_processes(run, args=(root, shape, names, archs, jobs),
                           nprocs=int(np.prod(shape)), start_method="fork")
""")
CHILD = CHILD.replace('\nif __name__ == "__main__":',
                      USES + '\nif __name__ == "__main__":')
for _name in ("CKPT_ARCH", "GAP_ARCHS", "CE_CASES", "MOE_ARCHS",
              "MOE_IMPLS", "COMP_ARCH", "USE_ARCH", "USE_LAYERS"):
    CHILD = CHILD.replace(_name, repr(globals()[_name]))

# The reference's ``local`` MoE steps on (data 2, model 2): jitted on a
# (2, 2) mesh of fake CPU devices (the flag set before JAX loads), its
# sharding context the launch's, so each data shard's tokens route within
# its own capacity.  Step 1 on the arch's batch and on the repeated token
# from the initial state; then, once the (data 2, model 2) world has
# written its out.npz, step 2 (grad_accum=2) from that world's own step-1
# state.  Writes jax22.npz under the world's directory.
JAX22 = textwrap.dedent("""
    import os, sys, time
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.distributed.ctx import ShardCtx, set_ctx
    from repro.launch.mesh import make_mesh_compat
    from repro.training import optim
    from repro.training import train_step as JS

    root, lr, z = sys.argv[1], float(sys.argv[2]), float(sys.argv[3])
    archs = sys.argv[4].split(",")

    def load(path):
        tree = {}
        for key, a in np.load(path).items():
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(a)
        return tree

    def batch(name, arch):
        return {k: jnp.asarray(v)
                for k, v in np.load(f"{root}/{name}-{arch}.npz").items()}

    out = {}

    def put(key, state, metrics):
        for field, tree in (("params", state.params), ("mu", state.opt.mu),
                            ("nu", state.opt.nu)):
            for i, a in enumerate(jax.tree.leaves(tree)):
                out[f"{key}/{field}/{i:03d}"] = np.asarray(a)
        out[f"{key}/step"] = np.asarray(state.opt.step)
        for k in ("loss", "grad_norm"):
            out[f"{key}/{k}"] = np.asarray(metrics[k])

    opt = optim.AdamW(lr=lr)
    steps = {}

    def step(arch, accum):
        if (arch, accum) not in steps:
            steps[arch, accum] = jax.jit(JS.make_train_step(
                get_config(arch, reduced=True), opt, z_loss=z,
                compute_dtype=None, moe_impl="local", grad_accum=accum))
        return steps[arch, accum]

    set_ctx(ShardCtx(model_size=2, dp_size=2, enabled=True))
    with jax.set_mesh(make_mesh_compat((2, 2), ("data", "model"))):
        params = {a: load(f"{root}/params-{a}.npz") for a in archs}
        for arch in archs:
            state = JS.TrainState(params[arch], opt.init(params[arch]), None)
            for name, key in (("batch", "1"), ("over", "over")):
                put(f"{arch}/local/{key}", *step(arch, 1)(
                    state, batch(name, arch)))
        t0 = time.time()
        while not os.path.exists(f"{root}/out.npz"):
            if time.time() - t0 > 540:
                sys.exit("the (data 2, model 2) world wrote no out.npz")
            time.sleep(0.2)
        got = np.load(f"{root}/out.npz")
        for arch in archs:
            treedef = jax.tree.structure(params[arch])
            key = f"{arch}/local/1"

            def tree(field):
                names = sorted(k for k in got.files
                               if k.startswith(f"{key}/{field}/"))
                return jax.tree.unflatten(
                    treedef, [jnp.asarray(got[k]) for k in names])

            start = JS.TrainState(tree("params"), optim.AdamWState(
                jnp.asarray(int(got[f"{key}/step"]), jnp.int32),
                tree("mu"), tree("nu")), None)
            put(f"{arch}/local/2", *step(arch, 2)(start,
                                                  batch("batch", arch)))
    np.savez(f"{root}/jax22.npz", **out)
""")


def _reference(arch):
    cfg = jget(arch, reduced=True)
    params = JT.init_params(cfg, jax.random.key(ARCHS.index(arch)),
                            jnp.float32)
    return params, make_batch(cfg, B, S, seed=ARCHS.index(arch))


def _ce_case(case):
    """(the reference's reduced yi-6b config, final hidden states (B, S,
    D), head (1, D, Vp), labels (B, S)) of a cross-entropy case, numpy
    from a seed.  The tie: integer hidden states in [0, 2] and head
    entries in [-2, 1] (exact sums), the two CE_TIE columns all 3, so every
    row's max is theirs, equal; the labels alternate between them and
    random ids."""
    cfg = jget(YI, reduced=True)
    if case == "padded":
        cfg = dataclasses.replace(cfg, vocab_size=150)
    rng = np.random.default_rng(CE_CASES.index(case))
    D, Vp = cfg.d_model, cfg.padded_vocab
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if case != "tie":
        return (cfg, rng.standard_normal((B, S, D)).astype(np.float32),
                (rng.standard_normal((1, D, Vp)) * D ** -0.5).astype(
                    np.float32), labels)
    hidden = rng.integers(0, 3, (B, S, D)).astype(np.float32)
    head = rng.integers(-2, 2, (1, D, Vp)).astype(np.float32)
    head[..., list(CE_TIE)] = 3.0
    labels[:, 0::3], labels[:, 1::3] = CE_TIE
    return cfg, hidden, head, labels


def _over_batch(arch, world):
    """The batch of one token repeated (OVER_TOKEN) for ``world``."""
    tokens = np.full((B, 32 if world == "data2model2" else S), OVER_TOKEN,
                     np.int32)
    return {"tokens": tokens, "labels": tokens.copy()}


_STEPS: dict = {}


def _jax_step(arch, compute_dtype=None, **kw):
    """The reference's jitted step (compiled once an arch, type and
    option set).  ``moe_impl="local"`` runs it on a (1, 1) mesh (its
    ``shard_map`` needs one; one data shard, every expert local)."""
    key = (arch, compute_dtype, tuple(sorted(kw.items())))
    if key not in _STEPS:
        fn = jax.jit(JS.make_train_step(
            jget(arch, reduced=True), JO.AdamW(lr=LR), z_loss=Z,
            compute_dtype=compute_dtype, **kw))
        if kw.get("moe_impl") == "local":
            def fn(*args, _fn=fn):
                with jax.set_mesh(make_mesh_compat((1, 1),
                                                   ("data", "model"))):
                    return _fn(*args)
        _STEPS[key] = fn
    return _STEPS[key]


def _moe_grads(arch, params_np, batch, impl, groups):
    """The port's unplaced gradient leaves (numpy) of ``moe_impl=impl``,
    the mean over ``groups`` contiguous row groups (a data rank's rows,
    each micro-slice of them), each routed within its own capacity: what
    the ill-conditioned rule reads."""
    tcfg, tparams, tb = _port_inputs(arch, params_np, batch)
    flat, structure = pytree.flatten(tparams)
    n = B // groups
    total = None
    for i in range(groups):
        leaves = [p.detach().requires_grad_() for p in flat]
        loss, _ = TT.loss_fn(tcfg, pytree.unflatten(structure, leaves),
                             {k: v[i * n:(i + 1) * n] for k, v in tb.items()},
                             moe_impl=impl, remat=False, z_loss=Z)
        g = [x.numpy() for x in torch.autograd.grad(loss, leaves)]
        total = g if total is None else [a + b for a, b in zip(total, g)]
    return [a / groups for a in total]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's out.npz, and the reference's step 1 (and the bf16
    step) for each arch, computed while the children run."""
    base = tmp_path_factory.mktemp("tp")
    refs = {a: _reference(a) for a in ARCHS}
    procs = {}
    for world, (shape, names, archs, jobs) in WORLDS.items():
        d = base / world
        d.mkdir()
        moe = MOE_ARCHS if "moe" in jobs else ()
        comp = (COMP_ARCH,) if "comp" in jobs else ()
        for arch in sorted(set(archs) | set(moe) | set(comp)):
            params, batch = refs[arch]
            np.savez(d / f"params-{arch}.npz", **_flat_np(np_tree(params)))
            np.savez(d / f"batch-{arch}.npz", **batch)
        for arch in moe:
            np.savez(d / f"over-{arch}.npz", **_over_batch(arch, world))
        for case in CE_CASES if "ce" in jobs else ():
            cfg, hidden, head, labels = _ce_case(case)
            np.savez(d / f"ce-{case}.npz", hidden=hidden, head=head,
                     labels=labels, vocab=cfg.vocab_size, z=Z,
                     chunk=CE_CHUNK)
        log = open(base / f"{world}.log", "w")
        procs[world] = (subprocess.Popen(
            [sys.executable, "-c", CHILD, str(d),
             ",".join(map(str, shape)), ",".join(names), ",".join(archs),
             ",".join(jobs)], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT), log)
    log = open(base / "jax22.log", "w")
    procs["jax22"] = (subprocess.Popen(
        [sys.executable, "-c", JAX22, str(base / "data2model2"), str(LR),
         str(Z), ",".join(MOE_ARCHS)], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT), log)
    want = {}
    jopt = JO.AdamW(lr=LR)
    for arch in ARCHS:
        params, batch = refs[arch]
        state = JS.TrainState(params, jopt.init(params), None)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want[arch] = (params, batch, _jax_step(arch)(state, jb))
        if arch == CKPT_ARCH:
            want["bf16"] = _jax_step(arch, compute_dtype=jnp.bfloat16)(
                state, jb)
        if arch == COMP_ARCH:
            want["comp"] = _jax_step(arch, compression=True)(
                JS.TrainState(params, jopt.init(params),
                              JS.CompressionState.init(params)), jb)
        for impl in MOE_IMPLS if arch in MOE_ARCHS else ():
            step = _jax_step(arch, moe_impl=impl)
            want["moe", arch, impl, "1"] = step(state, jb)
            want["moe", arch, impl, "over"] = step(state, {
                k: jnp.asarray(v)
                for k, v in _over_batch(arch, "model2").items()})
    out = {}
    for world, (proc, log) in procs.items():
        proc.wait(timeout=600)
        log.close()
        assert proc.returncode == 0, (base / f"{world}.log").read_text()[
            -4000:]
        name = "jax22.npz" if world == "jax22" else "out.npz"
        with np.load(base / ("data2model2" if world == "jax22" else world)
                     / name) as f:
            out[world] = dict(f)
    return out, want, base / "data2model2" / "ckpt"


@pytest.mark.parametrize("world,arch", RUNS)
def test_tp_step_matches_reference(runs, world, arch):
    """Step 1 of the state split on the model axis against the
    reference's one-device step on the whole batch (f32)."""
    out, want, _ = runs
    params, batch, (jstate, jm) = want[arch]
    tcfg, tparams, tb = _port_inputs(arch, np_tree(params), batch)
    _hold_step(out[world], f"{arch}/1", jstate, jm,
               step_grads(tcfg, tparams, tb), f"{arch} {world}")


@pytest.mark.parametrize("world,arch", RUNS)
def test_tp_grad_accum_step_matches_reference(runs, world, arch):
    """Step 2, ``grad_accum=2`` (each rank gathers its shards once, runs
    two micro-slices of its rows with the model axis installed, reduces
    once), from the world's own step-1 state, against the reference's
    step from that state on the whole batch."""
    out, want, _ = runs
    params, batch, _ = want[arch]
    got = out[world]
    start = _jstate(params, got, f"{arch}/1")
    jstate, jm = _jax_step(arch)(
        start, {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg, tparams, tb = _port_inputs(arch, np_tree(start.params), batch)
    _hold_step(got, f"{arch}/2", jstate, jm,
               step_grads(tcfg, tparams, tb, grad_accum=2),
               f"{arch} {world} grad_accum")


def _moe_target(runs, world, arch, impl, key, start=None):
    """The reference's step ``key`` ("1", "over" or "2", the last from
    ``start``) of ``moe_impl=impl`` for ``world``: (state, metrics)."""
    out, want, _ = runs
    if world == "data2model2" and impl == "local":
        j = out["jax22"]
        k = f"{arch}/local/{key}"
        return _jstate(want[arch][0], j, k), {
            m: j[f"{k}/{m}"] for m in ("loss", "grad_norm")}
    if key != "2":
        return want["moe", arch, impl, key]
    # ragged has no capacity: the whole batch's step is grad_accum=2's
    accum = dict(grad_accum=2) if impl == "local" else {}
    return _jax_step(arch, moe_impl=impl, **accum)(
        start, {k: jnp.asarray(v) for k, v in want[arch][1].items()})


def _groups(world) -> int:
    """Row groups routed on their own in a step: a data rank's rows."""
    return int(np.prod(WORLDS[world][0][:-1]))


@pytest.mark.parametrize("world,arch,impl", MOE_RUNS)
def test_tp_moe_step_matches_reference(runs, world, arch, impl):
    """Step 1 with ``moe_impl`` ``ragged`` or ``local`` on the state split
    on the model axis (each rank its experts, the gates taken in) against
    the reference's step with the same impl (f32)."""
    out, want, _ = runs
    params, batch, _ = want[arch]
    jstate, jm = _moe_target(runs, world, arch, impl, "1")
    _hold_step(out[world], f"{arch}/{impl}/1", jstate, jm,
               _moe_grads(arch, np_tree(params), batch, impl,
                          _groups(world)), f"{arch} {impl} {world}")


@pytest.mark.parametrize("world,arch,impl", MOE_RUNS)
def test_tp_moe_grad_accum_step_matches_reference(runs, world, arch, impl):
    """Step 2 with ``grad_accum=2`` (``local``'s capacity a micro-slice's)
    from the world's own step-1 state against the reference's from it."""
    out, want, _ = runs
    params, batch, _ = want[arch]
    got = out[world]
    start = _jstate(params, got, f"{arch}/{impl}/1")
    jstate, jm = _moe_target(runs, world, arch, impl, "2", start)
    _hold_step(got, f"{arch}/{impl}/2", jstate, jm,
               _moe_grads(arch, np_tree(start.params), batch, impl,
                          2 * _groups(world)),
               f"{arch} {impl} {world} grad_accum")


@pytest.mark.parametrize("world,arch,impl", OVER_RUNS)
def test_tp_moe_overflow_matches_reference(runs, world, arch, impl):
    """Step 1 on one token repeated: each chosen expert gets every slot,
    more than the capacity (``local`` drops the earliest, the reference's
    rule), and where the axis has more ranks than the top-K some rank's
    experts get no slot (its products at zero rows, its collectives
    issued); both seen in the ranks' routing.  Held to the reference's
    step as step 1 is."""
    out, want, _ = runs
    params = want[arch][0]
    got = out[world]
    jstate, jm = _moe_target(runs, world, arch, impl, "over")
    _hold_step(got, f"{arch}/{impl}/over", jstate, jm,
               _moe_grads(arch, np_tree(params), _over_batch(arch, world),
                          impl, _groups(world)), f"{arch} {impl} {world} "
               "overflow")
    cfg = tget(arch, reduced=True)
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    m = WORLDS[world][0][-1]
    calls = [got[f"route/{arch}/{impl}/over/{r}"]
             for r in range(int(np.prod(WORLDS[world][0])))]
    assert all(len(c) >= cfg.num_layers for c in calls), calls
    for rows, mine, most in np.concatenate(calls):
        assert most == rows  # every token routed alike
        assert most > min(max(32, int(2.0 * rows * K / E)), rows * K)
    if m > K:
        assert any(mine == 0 for c in calls for _, mine, _ in c), calls


def test_tp_moe_routing_seen_on_every_rank(runs):
    """Each rank of each world ran the routed forms on its own rows (a
    data rank's half), and its experts' slots over the ranks of a model
    axis add up to the rows' K slots."""
    for world, (shape, *_) in WORLDS.items():
        got = runs[0][world]
        m = shape[-1]
        for arch in MOE_ARCHS:
            K = tget(arch, reduced=True).num_experts_per_tok
            for impl in MOE_IMPLS:
                calls = np.stack([got[f"route/{arch}/{impl}/1/{r}"]
                                  for r in range(int(np.prod(shape)))])
                assert (calls[..., 0] == B * S // _groups(world)).all()
                for d in range(_groups(world)):
                    mine = calls[d * m:(d + 1) * m, :, 1].sum(0)
                    assert (mine == B * S // _groups(world) * K).all()


@pytest.mark.parametrize("step", [1, 2])
def test_tp_compression_step_matches_reference(runs, step):
    """``compression=True`` on the (data 2, model 2) state: each rank's
    blocks of the averaged gradients compressed with the whole leaf's
    scale, the error accumulator placed as its leaf.  Step 1 from a zero
    error, step 2 from the world's own step-1 state and error, against the
    reference's compressed one-device step: loss, gradient norm, params,
    moments and the error, by the ill-conditioned rule (int8 rounding
    boundaries included)."""
    out, want, _ = runs
    got = out["data2model2"]
    params, batch, _ = want[COMP_ARCH]
    key = f"comp/{step}"
    error = None
    if step == 1:
        jstate, jm = want["comp"]
        start = params
    else:
        prev = _jstate(params, got, "comp/1")
        error = _leaves(got, "comp/1", "error")
        prev = prev._replace(comp=JS.CompressionState(jax.tree.unflatten(
            jax.tree.structure(params), [jnp.asarray(a) for a in error])))
        jstate, jm = _jax_step(COMP_ARCH, compression=True)(
            prev, {k: jnp.asarray(v) for k, v in batch.items()})
        start = prev.params
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[f"{key}/{k}"]), float(jm[k]),
                                   rtol=3e-5, atol=3e-5, err_msg=k)
    assert int(got[f"{key}/step"]) == int(jstate.opt.step) == step
    tcfg, tparams, tb = _port_inputs(COMP_ARCH, np_tree(start), batch)
    ex = ill_conditioned(step_grads(tcfg, tparams, tb), compression=True,
                         error=error)
    what = f"compression step {step}"
    hold(_leaves(got, key, "params"), jstate.params, what=f"{what} params",
         exempt=ex, bound=STEP_BOUND)
    hold(_leaves(got, key, "mu"), jstate.opt.mu, what=f"{what} mu",
         exempt=ex)
    hold(_leaves(got, key, "nu"), jstate.opt.nu,
         tol=dict(rtol=3e-5, atol=1e-9), what=f"{what} nu", exempt=ex)
    hold(_leaves(got, key, "error"), jstate.comp.error,
         what=f"{what} error", exempt=ex)


@pytest.mark.parametrize("world", list(WORLDS))
def test_tp_state_layout_and_bytes(runs, world):
    """``place_state`` by ``param_specs`` splits leaves on the model axis;
    gathered whole it is the state placed, and each rank holds its spec
    tree's bytes a device."""
    got = runs[0][world]
    n = int(np.prod(WORLDS[world][0]))
    for arch in WORLDS[world][2]:
        assert got[f"{arch}/whole_equal"], arch
        assert int(got[f"{arch}/model_split"]) > 0, arch
        assert list(got[f"{arch}/bytes"]) == [int(
            got[f"{arch}/spec_bytes"])] * n, arch


@pytest.mark.parametrize("world", list(WORLDS))
def test_tp_attention_inputs_are_contiguous(runs, world):
    """Every attention call of the world's steps takes contiguous q, k and
    v, as the card's kernels require: on (model 4) too, where each rank
    takes its KV head out of k and v gathered whole, and where yi-6b's
    ranks take 2, 2, 1 and 1 of its 6 query heads, each with as many KV
    heads (k and v repeated to them)."""
    got = runs[0][world]
    seen = got["attention_contiguous"]
    assert seen.size > 0 and seen.all(), seen
    if world == "model4":
        heads = [got[f"attention_heads/{YI}/{r}"].tolist() for r in range(4)]
        assert heads == [[[2, 2]], [[2, 2]], [[1, 1]], [[1, 1]]], heads


@pytest.mark.parametrize("case", CE_CASES)
@pytest.mark.parametrize("world", CE_WORLDS)
def test_vocab_parallel_ce_matches_reference(runs, world, case,
                                             monkeypatch):
    """``head_loss`` (``loss_fn`` past the final hidden states) on each
    rank's vocabulary columns of the head (the chunks' statistics reduced
    over the model axis, no logits gathered), against the reference's
    ``loss_fn`` on the whole head, its ``forward_hidden`` replaced by the
    same final hidden states, both chunked alike (CE_CHUNK): loss and nll
    within 3e-5, accuracy equal, the hidden states' gradient (all-reduced
    over the axis) and the head's (each rank's columns) within 3e-5."""
    got = runs[0][world]
    cfg, hidden, head, labels = _ce_case(case)
    monkeypatch.setattr(JT, "forward_hidden",
                        lambda cfg, params, batch, **kw: params["hidden"])
    monkeypatch.setattr(JT, "CE_CHUNK", CE_CHUNK)
    (_, met), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(cfg, p, {"labels": jnp.asarray(labels)},
                             z_loss=Z), has_aux=True)(
        {"hidden": jnp.asarray(hidden), "head": jnp.asarray(head)})
    key = f"ce/{case}"
    for k in ("loss", "nll"):
        np.testing.assert_allclose(float(got[f"{key}/{k}"]), float(met[k]),
                                   rtol=3e-5, atol=3e-5)
    assert float(got[f"{key}/accuracy"]) == float(met["accuracy"])
    if case == "tie":  # every row's argmax is the lower of the two
        assert float(met["accuracy"]) == np.mean(labels == CE_TIE[0])
    for k in ("hidden", "head"):
        np.testing.assert_allclose(got[f"{key}/{k}"], np.asarray(grads[k]),
                                   rtol=3e-5, atol=3e-5, err_msg=k)


def test_tp_bf16_step_matches_reference(runs):
    """A bf16 compute copy (the default) on the (model 2) world: loss,
    gradient norm, the first moment and the params within 3e-2 relative
    l2 of the reference's bf16 step; the master params stay f32."""
    out, want, _ = runs
    got = out["model2"]
    jstate, jm = want["bf16"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[f"bf16/{k}"]), float(jm[k]),
                                   rtol=BF16_REL_L2)
    for field, tree in (("mu", jstate.opt.mu), ("params", jstate.params)):
        g = np.concatenate([a.ravel() for a in _leaves(got, "bf16", field)])
        w = np.concatenate([np.asarray(a, np.float32).ravel()
                            for a in jax.tree.leaves(tree)])
        assert np.linalg.norm(g - w) <= BF16_REL_L2 * np.linalg.norm(w)
    assert all(a.dtype == np.float32 for a in _leaves(got, "bf16", "params"))


def test_tp_checkpoint_restores_bit_equal(runs):
    """The (data 2, model 2) state after step 2, saved by every rank
    together, restored onto one process: bit-equal to the state saved."""
    out, _, ckpt = runs
    saved = out["data2model2"]
    key = f"{CKPT_ARCH}/2"
    opt = TO.AdamW(lr=LR)
    template = TS.init_state(tget(CKPT_ARCH, reduced=True), 0, opt,
                             device="cpu")
    one = CK.restore(template, str(ckpt))
    assert int(one.opt.step) == 2
    for field, tree in (("params", one.params), ("mu", one.opt.mu),
                        ("nu", one.opt.nu)):
        for a, b in zip(pytree.leaves(tree), _leaves(saved, key, field)):
            np.testing.assert_array_equal(a.numpy(), b)


def test_global_norm_counts_each_block_once(runs):
    """``global_norm`` of a tree placed on the (data 2, model 2) mesh by the
    TP state's master specs and by ``param_specs`` (leaves split on the
    model axis, the data axis, both and neither): the whole tree's norm (a
    block that the ranks of a mesh dim hold alike counted once)."""
    got = runs[0]["data2model2"]
    for arch in (YI, OLMOE):
        kinds = {tuple(k) for k in got[f"norm/{arch}/kinds"].tolist()}
        assert {(True, True), (False, True), (True, False),
                (False, False)} <= kinds, kinds
        for tag in ("zero", "tp"):
            np.testing.assert_allclose(float(got[f"norm/{arch}/{tag}"]),
                                       float(got[f"norm/{arch}/whole"]),
                                       rtol=1e-6)


@pytest.mark.parametrize("arch", GAP_ARCHS)
def test_tp_train_gaps_raise(runs, arch):
    """A state of an SSM or hybrid model split on the model axis: the
    step raises before any collective, naming what the path lacks."""
    msg = str(runs[0]["model2"][f"gaps/{arch}"])
    word = "hybrid blocks" if arch.startswith("hymba") else "SSM blocks"
    assert word in msg and "ROADMAP A13" in msg, msg
    assert word in TT.tp_train_gaps(tget(arch), 16)


def test_tp_train_gaps_name_uneven_splits():
    """The production model axis of 16: yi-6b and olmoe-1b-7b train
    (yi's 4 KV heads split mid-head, gathered whole), and so does
    llama4-scout (40 query heads, 2.5 a rank of columns: each rank takes
    3 or 2 whole heads); fewer query heads than ranks, wq or wk columns
    that the axis does not divide, experts and MLP widths that it does not
    divide are named."""
    assert TT.tp_train_gaps(tget(YI), 16) == []
    assert TT.tp_train_gaps(tget(OLMOE), 16) == []
    assert TT.tp_train_gaps(tget(SCOUT), 16) == []
    small = tget(YI, reduced=True)  # 6 query heads, 2 KV heads, d_ff 192
    assert TT.tp_train_gaps(small, 4) == []
    assert TT.tp_train_gaps(small, 2) == []
    assert TT.tp_train_gaps(small, 8) == ["6 query heads over 8 ranks"]
    # KV heads the axis neither divides nor is divided by: repeated
    assert TT.tp_train_gaps(dataclasses.replace(tget(YI), num_kv_heads=3),
                            16) == []
    odd = dataclasses.replace(tget(YI), head_dim=98)  # wk 392 columns
    assert TT.tp_train_gaps(odd, 16) == ["wk's 392 columns over 16 ranks"]
    odd = dataclasses.replace(tget(SCOUT), head_dim=99)
    assert TT.tp_train_gaps(odd, 16) == ["wq's 3960 columns over 16 ranks",
                                         "wk's 792 columns over 16 ranks"]
    olmoe = tget(OLMOE, reduced=True)  # 8 experts
    assert "8 experts over 16 ranks" in TT.tp_train_gaps(olmoe, 16)
    assert TT.tp_train_gaps(tget("musicgen-large"), 16)[0] == "4 codebooks"


def test_tp_use_sites_gather_and_reduce_in_order(runs):
    """On (data 2, model 2), yi-6b at USE_LAYERS layers: the data axis's
    gathers and reduce-scatters per use, interleaved with the model
    axis's collectives, in ``test_torch_zero.hold_use_order``'s order."""
    hold_use_order(use_events(runs[0]["data2model2"], USE_ARCH), USE_LAYERS)


def test_tp_use_sites_high_water(runs):
    """The gathered bytes alive at once on (data 2, model 2): at most the
    two largest use sites of a rank's model-axis shard."""
    hold_high_water(runs[0]["data2model2"], USE_ARCH,
                    f"{USE_ARCH} (data 2, model 2)")


def test_tp_use_site_gradient_is_the_f32_scatter_sum(runs):
    """``UseSite`` on an f32 block split on its rows over the data axis
    and on its columns over the model axis: the model-axis split stays
    local (the rank's columns, gathered over the data axis only), and the
    gradient is ``scatter_sum``'s f32 block over the data axis."""
    got = runs[0]["data2model2"]
    assert str(got["grad/dtype"]) == "torch.float32"
    assert got["grad/equal"] and got["grad/forward"]
    assert [tuple(s) for s in got["grad/shapes"]] == [(8, 4), (16, 4)]
