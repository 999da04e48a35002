"""ZeRO data-parallel training on a placed state (ROADMAP A13, training):
the port's ``make_train_step`` on a state of ``DTensor``s split over the
data axes, on gloo CPU ranks, against the JAX package's one-device step
on the whole batch.

Each world size runs in a child process that forks its ranks
(``start_processes(..., start_method="fork")``; the ranks meet through a
file under the test's directory), as ``tests/test_torch_placement.py``
does; both children run while this process compiles the reference's
steps.  Worlds: 2 ranks on a ``("data",)`` mesh, and 4 ranks on a (2, 2)
mesh whose two axes are both data axes (``build_cell``'s pure
data-parallel mapping: a leaf is split over both axes on one dim, or over
one of them where only that divides, ``zero1_specs``' fallback).

For reduced tinyllama-1.1b, gemma2-2b, mamba2-780m, hymba-1.5b and
internvl2-1b (dense, window and softcap, SSM, hybrid, vision frontend),
from the reference's weights, each rank on its own rows of an 8-row batch:

- step 1 (f32 compute) against ``jax.jit(make_train_step(...,
  compute_dtype=None))``'s: loss, gradient norm, params and both moments
  at ``rtol=atol=3e-5``, a step's params and moments but at its
  ill-conditioned elements (``test_torch_training.ill_conditioned``);
- step 2 with ``grad_accum=2`` (one gather, two micro-slices a rank, one
  reduction) from the world's own step-1 state, against the reference's
  jitted step from that state on the whole batch (the mean of equal
  micro-slices' means is the whole batch's; this keeps to one compile an
  arch, and the reference's own ``grad_accum`` is held to the port's in
  ``tests/test_torch_training.py``);
- the placed state itself: gathered whole it is the state placed, and
  each rank holds its spec tree's bytes a device.

Also a bf16 compute copy (tinyllama, 2 ranks) at 3e-2 relative l2, and
the 4-rank ZeRO state saved with ``checkpoint.save``, restored onto one
process and onto the 2-rank mesh, bit-equal.

The per-use form (``repro_torch.distributed.fsdp``), in both worlds: one
bf16 step of tinyllama-1.1b and gemma2-2b (tied embedding) at 4 layers
with ``UseSite`` wrapped in the child (:data:`USES`): each layer's
reduce-scatters before the regather of the layer below it, the gathered
bytes alive at once at most the two largest use sites (the whole copy's
printed beside), and ``UseSite``'s gradient f32 and equal to
``scatter_sum`` of the gathered gradient.
"""
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
from repro.models import transformer as JT
from repro.training import optim as JO
from repro.training import train_step as JS
from repro_torch.configs import get_config as tget
from repro_torch.distributed import checkpoint as CK
from repro_torch.models import transformer as TT
from repro_torch.training import optim as TO
from repro_torch.training import pytree
from repro_torch.training import train_step as TS
from test_torch_training import (BF16_REL_L2, LR, STEP_BOUND, TOL, Z, hold,
                                 ill_conditioned, make_batch, np_tree,
                                 step_grads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("tinyllama-1.1b", "gemma2-2b", "mamba2-780m", "hymba-1.5b",
         "internvl2-1b")
WORLDS = (2, 4)
B, S = 8, 16
CKPT_ARCH = "tinyllama-1.1b"
# The per-use record's configs: an untied head, and a tied embedding (its
# two use sites), both cut or grown to USE_LAYERS.
USE_ARCHS = ("tinyllama-1.1b", "gemma2-2b")
USE_LAYERS = 4
# Placed with its (L, heads) vectors split on the layer dim over the data
# axes, which full-width mamba2 gets from zero1_specs (48 x 48: the largest
# divisible dim ties and the first wins) and the reduced configs never do.
STACKED_ARCH = "mamba2-780m"

# The per-use form's record (a child's job, shared with
# tests/test_torch_tp_train.py): one placed bf16 step of ``cfg`` with remat,
# ``UseSite`` wrapped to log each data-axis gather (its group, leaf and
# bytes) and reduce-scatter in order and to follow the gathered bytes alive
# (a ``weakref.finalize`` on each output); and ``UseSite``'s gradient of
# a (16, 8) f32 leaf split on its rows over ``dims`` (and on its columns
# over the model axis where the mesh has one) against ``scatter_sum`` of
# the gathered gradient.
USES = textwrap.dedent("""
    def record_uses(key, cfg, state, sspecs, mesh, batch, dp_axes, out):
        import math
        import weakref
        from repro_torch.distributed import fsdp as FS
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import optim, pytree
        from repro_torch.training import train_step as TS

        events, live, peak = [], [0], [0]
        fwd, bwd = FS.UseSite.forward, FS.UseSite.backward

        def freed(n):
            live[0] -= n

        def forward(ctx, local, site):
            y = fwd(ctx, local, site)
            if site.gather:
                n = y.numel() * y.element_size()
                events.append(("gather", site.group, site.name, n))
                live[0] += n
                peak[0] = max(peak[0], live[0])
                weakref.finalize(y, freed, n)
            return y

        def backward(ctx, g):
            if ctx.site.reduce:
                events.append(("scatter", ctx.site.group, ctx.site.name, 0))
            return bwd(ctx, g)

        placed = SH.place_state(state, mesh, sspecs)
        dims = [i for i, n in enumerate(mesh.mesh_dim_names) if n in dp_axes]
        # The compute copy a rank gathered whole before the per-use form.
        whole = sum(p.to_local().numel() * (2 if p.dim() >= 2 else 4)
                    * math.prod(mesh.size(d) for d in dims
                                if p.placements[d].is_shard())
                    for p in pytree.leaves(placed.params))
        FS.UseSite.forward = staticmethod(forward)
        FS.UseSite.backward = staticmethod(backward)
        try:
            with FS.metered() as meter:
                TS.make_train_step(cfg, optim.AdamW(lr=1e-3),
                                   dp_axes=dp_axes)(placed, batch)
        finally:
            FS.UseSite.forward, FS.UseSite.backward = fwd, bwd
        out[f"uses/{key}/events"] = np.array(
            [f"{k}|{g}|{n}|{b}" for k, g, n, b in events])
        out[f"uses/{key}/peak"] = np.array(peak[0])
        out[f"uses/{key}/meter"] = np.array([meter.peak, meter.bound()])
        out[f"uses/{key}/whole"] = np.array(whole)

    def use_site_grad(rank, mesh, dims, out):
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.distributed import fsdp as FS
        from repro_torch.distributed import sharding as SH

        names = mesh.mesh_dim_names
        whole = torch.randn((16, 8), generator=torch.Generator()
                            .manual_seed(0))
        rows = tuple(names[d] for d in dims)
        spec = (rows if len(rows) > 1 else rows[0],
                "model" if "model" in names and len(dims) < len(names)
                else None)
        placed = SH.place(whole, mesh, spec)
        local = placed.to_local().clone().requires_grad_()
        site = FS.Site("w", "w", mesh, placed.placements, tuple(dims),
                       tuple(dims), torch.bfloat16)
        y = FS.UseSite.apply(local, site)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            rank + 1)).to(torch.bfloat16)
        y.backward(g)
        want = SH.scatter_sum(g.float(), mesh, placed.placements, dims)
        cols = (SH.redistribute(placed, [Replicate() if i in dims else q
                                         for i, q in enumerate(
                                             placed.placements)])
                .to_local())
        out["grad/dtype"] = np.array(str(local.grad.dtype))
        out["grad/equal"] = np.array(bool(torch.equal(local.grad, want)))
        out["grad/forward"] = np.array(bool(
            y.dtype == torch.bfloat16
            and torch.equal(y, cols.to(torch.bfloat16))))
        out["grad/shapes"] = np.array([tuple(local.shape), tuple(y.shape)])
""")


CHILD = textwrap.dedent("""
    import os, sys, time
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

    def setup(arch, root, mesh):
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.models import transformer as T
        from repro_torch.training import optim, pytree
        from repro_torch.training import train_step as TS

        cfg = get_config(arch, reduced=True)
        opt = optim.AdamW(lr=1e-3)
        state = TS.state_from_params(
            T.params_from_numpy(load(f"{root}/params-{arch}.npz")), opt)
        sspecs = SH.state_specs(cfg, state, SH.logical(mesh), pytree.tree_map(
            lambda p: (None,) * p.dim(), state.params),
            dp_axes=tuple(mesh.mesh_dim_names))
        return cfg, opt, state, sspecs

    def rows(root, arch, rank, world):
        batch = {k: torch.from_numpy(v)
                 for k, v in np.load(f"{root}/batch-{arch}.npz").items()}
        n = batch["tokens"].shape[0] // world
        return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}

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
        out[f"{key}/step"] = np.array(int(state.opt.step.full_tensor()))
        for k in ("loss", "grad_norm"):
            out[f"{key}/{k}"] = np.array(float(metrics[k]))

    def train(rank, world, root, mesh, out):
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import pytree
        from repro_torch.training import train_step as TS

        for arch in ARCHS:
            cfg, opt, state, sspecs = setup(arch, root, mesh)
            placed = SH.place_state(state, mesh, sspecs)
            out[f"{arch}/whole_equal"] = np.array(all(
                np.array_equal(a, b.numpy()) for a, b in zip(
                    whole(placed), pytree.leaves(state))))
            out[f"{arch}/bytes"] = np.array(SH.rank_nbytes(placed))
            spec_bytes = [0]
            SH.spec_map(lambda sp, t: spec_bytes.__setitem__(
                0, spec_bytes[0] + t.numel() * t.element_size()
                // SH._divisor(sp, SH.logical(mesh))), sspecs, state)
            out[f"{arch}/spec_bytes"] = np.array(spec_bytes[0])
            out[f"{arch}/both_axes"] = np.array(sum(
                sum(q.is_shard() for q in p.placements) > 1
                for p in pytree.leaves(placed.params)))
            mine = rows(root, arch, rank, world)
            dp = tuple(mesh.mesh_dim_names)  # every mesh axis a data axis
            one, m1 = TS.make_train_step(cfg, opt, compute_dtype=None,
                                         dp_axes=dp)(placed, mine)
            put(out, f"{arch}/1", one, m1)
            two, m2 = TS.make_train_step(cfg, opt, compute_dtype=None,
                                         grad_accum=2, dp_axes=dp)(one, mine)
            put(out, f"{arch}/2", two, m2)
            if arch == CKPT_ARCH:
                out["ckpt/placements"] = np.array(str([
                    p.placements for p in pytree.leaves(two.params)]))
                if "save" in JOBS_RUN:
                    from repro_torch.distributed import checkpoint
                    checkpoint.save(two, f"{root}/../ckpt", 2)

    def bf16(rank, world, root, mesh, out):
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import train_step as TS

        cfg, opt, state, sspecs = setup(CKPT_ARCH, root, mesh)
        new, m = TS.make_train_step(
            cfg, opt, dp_axes=tuple(mesh.mesh_dim_names))(
            SH.place_state(state, mesh, sspecs),
            rows(root, CKPT_ARCH, rank, world))
        put(out, "bf16", new, m)

    def restore(rank, world, root, mesh, out):
        from repro_torch.distributed import checkpoint
        from repro_torch.distributed import sharding as SH

        path = f"{root}/../ckpt/step_00000002"
        for _ in range(600):  # the 4-rank child commits it
            if os.path.isdir(path):
                break
            time.sleep(0.5)
        cfg, opt, state, sspecs = setup(CKPT_ARCH, root, mesh)
        back = checkpoint.restore(state, f"{root}/../ckpt",
                                  shardings=SH.named(mesh, sspecs))
        put(out, "restored", back, {"loss": 0.0, "grad_norm": 0.0})
        out["restored/local_equal"] = np.array(all(
            tuple(a.to_local().shape) == tuple(b.to_local().shape)
            for a, b in zip(pytree_leaves(back.params), pytree_leaves(
                SH.place_state(state, mesh, sspecs).params))))

    def pytree_leaves(tree):
        from repro_torch.training import pytree
        return pytree.leaves(tree)

    def uses(rank, world, root, mesh, out):
        # USE_ARCHS at USE_LAYERS layers, from seed 0, each rank on its
        # rows of a batch from seed 1; UseSite's gradient over every mesh
        # axis (each a data axis).
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.training import optim, pytree
        from repro_torch.training import train_step as TS

        dp = tuple(mesh.mesh_dim_names)
        for arch in USE_ARCHS:
            cfg = dataclasses.replace(get_config(arch, reduced=True),
                                      num_layers=USE_LAYERS)
            state = TS.init_state(cfg, 0, optim.AdamW(lr=1e-3),
                                  device="cpu")
            sspecs = SH.state_specs(cfg, state, SH.logical(mesh),
                                    pytree.tree_map(
                                        lambda p: (None,) * p.dim(),
                                        state.params), dp_axes=dp)
            g = torch.Generator().manual_seed(1)
            batch = {k: torch.randint(0, cfg.vocab_size, (8, 16),
                                      generator=g)
                     for k in ("tokens", "labels")}
            n = 8 // world
            record_uses(arch, cfg, state, sspecs, mesh,
                        {k: v[rank * n:(rank + 1) * n]
                         for k, v in batch.items()}, dp, out)
        # STACKED_ARCH's per-head vectors split on their layer dim (as
        # full-width mamba2 splits them): gathered whole once a step, and
        # the step equal to the one on zero1_specs' own layout.
        cfg = dataclasses.replace(get_config(STACKED_ARCH, reduced=True),
                                  num_layers=USE_LAYERS)
        opt = optim.AdamW(lr=1e-3)
        state = TS.init_state(cfg, 0, opt, device="cpu")
        sspecs = SH.state_specs(cfg, state, SH.logical(mesh),
                                pytree.tree_map(lambda p: (None,) * p.dim(),
                                                state.params), dp_axes=dp)
        lay = dict(sspecs.params["layers"])
        for k in ("A_log", "D_skip", "dt_bias"):
            lay[k] = (dp if len(dp) > 1 else dp[0], None)
        stacked = SH.state_specs(cfg, state, SH.logical(mesh),
                                 dict(sspecs.params, layers=lay), dp_axes=dp)
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (8, 16), generator=g)
                 for k in ("tokens", "labels")}
        n = 8 // world
        mine = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        key = f"{STACKED_ARCH}/stacked"
        record_uses(key, cfg, state, stacked, mesh, mine, dp, out)
        steps = [TS.make_train_step(cfg, opt, dp_axes=dp)(
            SH.place_state(state, mesh, sp), mine)[0] for sp in (sspecs,
                                                               stacked)]
        out[f"uses/{key}/placements"] = np.array(str(
            steps[1].params["layers"]["A_log"].placements))
        out[f"uses/{key}/diff"] = np.array(max(
            float((SH.whole(a) - SH.whole(b)).abs().max())
            for a, b in zip(*(pytree.leaves(st.params) for st in steps))))
        use_site_grad(rank, mesh, list(range(mesh.ndim)), out)

    JOBS = {"train": train, "bf16": bf16, "restore": restore, "uses": uses}
    JOBS_RUN = ()

    def run(rank, root, world, jobs):
        global JOBS_RUN
        from repro_torch.launch.mesh import make_mesh

        JOBS_RUN = jobs
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                                rank=rank, world_size=world)
        shape, names = (((2,), ("data",)) if world == 2
                        else ((2, 2), ("data", "model")))
        mesh = make_mesh(shape, names, "cpu")
        out = {}
        for job in jobs:
            if job in JOBS:
                JOBS[job](rank, world, root, mesh, out)
        if rank == 0:
            np.savez(f"{root}/out.npz", **out)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        root, world, jobs = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
        mp.start_processes(run, args=(root, world, tuple(jobs)),
                           nprocs=world, start_method="fork")
""")
CHILD = (CHILD.replace('\nif __name__ == "__main__":',
                       USES + '\nif __name__ == "__main__":')
         .replace("STACKED_ARCH", repr(STACKED_ARCH))
         .replace("USE_ARCHS", repr(USE_ARCHS))
         .replace("USE_LAYERS", repr(USE_LAYERS))
         .replace("ARCHS", repr(ARCHS)).replace("CKPT_ARCH", repr(CKPT_ARCH)))


def _flat_np(tree, prefix=""):
    """A reference tree as {"a/b": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _reference(arch):
    cfg = jget(arch, reduced=True)
    params = JT.init_params(cfg, jax.random.key(ARCHS.index(arch)),
                            jnp.float32)
    return cfg, params, make_batch(cfg, B, S, seed=ARCHS.index(arch))


_STEPS: dict = {}


def _jax_step(arch, compute_dtype=None):
    """The reference's jitted step (compiled once an arch and type)."""
    key = (arch, compute_dtype)
    if key not in _STEPS:
        _STEPS[key] = jax.jit(JS.make_train_step(
            jget(arch, reduced=True), JO.AdamW(lr=LR), z_loss=Z,
            compute_dtype=compute_dtype))
    return _STEPS[key]


def _leaves(out, key, field):
    names = sorted(k for k in out if k.startswith(f"{key}/{field}/"))
    return [out[k] for k in names]


def _jstate(params, out, key):
    """The reference's ``TrainState`` from a child's gathered state."""
    treedef = jax.tree.structure(params)
    tree = {f: jax.tree.unflatten(treedef, [jnp.asarray(a) for a in
                                            _leaves(out, key, f)])
            for f in ("params", "mu", "nu")}
    return JS.TrainState(tree["params"], JO.AdamWState(
        jnp.asarray(int(out[f"{key}/step"]), jnp.int32), tree["mu"],
        tree["nu"]), None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The children's out.npz by world, and the reference's step 1 for
    each arch: the 4-rank child trains and saves its checkpoint, the
    2-rank one trains, takes a bf16 step and restores that checkpoint,
    while this process compiles and runs the reference's steps."""
    base = tmp_path_factory.mktemp("zero")
    for world in WORLDS:
        (base / f"world{world}").mkdir()
    refs = {}
    for arch in ARCHS:
        cfg, params, batch = _reference(arch)
        refs[arch] = (params, batch)
        for world in WORLDS:
            np.savez(base / f"world{world}" / f"params-{arch}.npz",
                     **_flat_np(np_tree(params)))
            np.savez(base / f"world{world}" / f"batch-{arch}.npz", **batch)
    procs = {}
    for world, jobs in ((4, ("train", "save", "uses")),
                        (2, ("train", "bf16", "restore", "uses"))):
        log = open(base / f"world{world}.log", "w")
        procs[world] = (subprocess.Popen(
            [sys.executable, "-c", CHILD, str(base / f"world{world}"),
             str(world), *jobs], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT), log)
    want = {}
    for arch in ARCHS:
        params, batch = refs[arch]
        jopt = JO.AdamW(lr=LR)
        state = JS.TrainState(params, jopt.init(params), None)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want[arch] = (params, batch, _jax_step(arch)(state, jb))
        if arch == CKPT_ARCH:
            want["bf16"] = _jax_step(arch, compute_dtype=jnp.bfloat16)(
                state, jb)
    out = {}
    for world, (proc, log) in procs.items():
        proc.wait(timeout=600)
        log.close()
        assert proc.returncode == 0, (
            base / f"world{world}.log").read_text()[-4000:]
        with np.load(base / f"world{world}" / "out.npz") as f:
            out[world] = dict(f)
    return out, want, base / "ckpt"


def _hold_step(got, key, want_state, want_metrics, grads, what):
    """A step's loss, gradient norm, params and moments against the
    reference's, by ``test_torch_training``'s rule."""
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[f"{key}/{k}"]),
                                   float(want_metrics[k]), **TOL,
                                   err_msg=f"{what} {k}")
    assert int(got[f"{key}/step"]) == int(want_state.opt.step)
    ex = ill_conditioned(grads)
    hold(_leaves(got, key, "params"), want_state.params,
         what=f"{what} params", exempt=ex, bound=STEP_BOUND)
    hold(_leaves(got, key, "mu"), want_state.opt.mu, what=f"{what} mu",
         exempt=ex)
    hold(_leaves(got, key, "nu"), want_state.opt.nu,
         tol=dict(rtol=3e-5, atol=1e-9), what=f"{what} nu", exempt=ex)


def _port_inputs(arch, params_np, batch):
    tcfg = tget(arch, reduced=True)
    return tcfg, TT.params_from_numpy(params_np), {
        k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_zero_step_matches_reference(runs, world, arch):
    """Step 1 of the placed state on ``world`` ranks against the
    reference's one-device step on the whole batch (f32)."""
    out, want, _ = runs
    params, batch, (jstate, jm) = want[arch]
    tcfg, tparams, tb = _port_inputs(arch, np_tree(params), batch)
    _hold_step(out[world], f"{arch}/1", jstate, jm,
               step_grads(tcfg, tparams, tb), f"{arch} world {world}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_zero_grad_accum_step_matches_reference(runs, world, arch):
    """Step 2, ``grad_accum=2`` (each rank gathers once, takes two
    micro-slices of its rows and reduces once), from the world's own
    step-1 state, against the reference's step from that state on the
    whole batch."""
    out, want, _ = runs
    params, batch, _ = want[arch]
    got = out[world]
    start = _jstate(params, got, f"{arch}/1")
    jstate, jm = _jax_step(arch)(
        start, {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg, tparams, tb = _port_inputs(arch, np_tree(start.params), batch)
    _hold_step(got, f"{arch}/2", jstate, jm,
               step_grads(tcfg, tparams, tb, grad_accum=2),
               f"{arch} world {world} grad_accum")


@pytest.mark.parametrize("world", WORLDS)
def test_placed_state_layout_and_bytes(runs, world):
    """``place_state`` gathered whole is the state it placed; each rank
    holds its spec tree's bytes a device; on the (2, 2) mesh some leaves
    are split over both axes on one dim."""
    got = runs[0][world]
    for arch in ARCHS:
        assert got[f"{arch}/whole_equal"], arch
        assert list(got[f"{arch}/bytes"]) == [int(
            got[f"{arch}/spec_bytes"])] * world, arch
    both = int(got[f"{CKPT_ARCH}/both_axes"])
    assert both > 0 if world == 4 else both == 0
    assert "Shard(dim=" in str(got["ckpt/placements"])


def test_zero_bf16_step_matches_reference(runs):
    """A bf16 compute copy (the default): each rank casts its blocks and
    gathers the bf16 copy; loss, gradient norm and the first moment (the
    clipped gradient's tenth) within 3e-2 relative l2 of the reference's
    bf16 step; the master params stay f32."""
    out, want, _ = runs
    got = out[2]
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


def test_zero_checkpoint_restores_bit_equal(runs):
    """The 4-rank ZeRO state after step 2, saved by every rank together,
    restored onto one process and onto the 2-rank mesh (its own blocks):
    bit-equal to the state that was saved."""
    out, want, ckpt = runs
    saved = out[4]
    key = f"{CKPT_ARCH}/2"
    cfg = tget(CKPT_ARCH, reduced=True)
    opt = TO.AdamW(lr=LR)
    template = TS.init_state(cfg, 0, opt, device="cpu")
    one = CK.restore(template, str(ckpt))
    assert int(one.opt.step) == 2
    for field, tree in (("params", one.params), ("mu", one.opt.mu),
                        ("nu", one.opt.nu)):
        for a, b in zip(pytree.leaves(tree), _leaves(saved, key, field)):
            np.testing.assert_array_equal(a.numpy(), b)
        for a, b in zip(_leaves(out[2], "restored", field),
                        _leaves(saved, key, field)):
            np.testing.assert_array_equal(a, b)
    assert int(out[2]["restored/step"]) == 2
    assert out[2]["restored/local_equal"]


def use_events(got, key):
    """A child's use-site log: (kind, group, leaf, bytes) in order."""
    return [(k, g, n, int(b)) for k, g, n, b in
            (e.split("|") for e in got[f"uses/{key}/events"])]


def _layer_of(name):
    """The layer of a use site's leaf (``layers/<i>/<leaf>``), or None (a
    leaf of no layer, or a stacked leaf gathered whole, ``layers/<leaf>``)."""
    parts = name.split("/")
    return int(parts[1]) if parts[0] == "layers" and parts[1].isdigit() \
        else None


def hold_use_order(events, layers):
    """Each layer leaf gathered twice (the forward, then remat's
    recomputation) and reduce-scattered once, every other leaf reduced as
    often as it is gathered; the layers gathered in order in the forward,
    and each layer's reduce-scatters all before the recomputation of the
    layer below it regathers it."""
    def at(kind, group):
        return [i for i, (k, g, _, _) in enumerate(events)
                if k == kind and g == group]

    names = {n for _, _, n, _ in events}
    for name in names:
        g = sum(1 for k, _, n, _ in events if k == "gather" and n == name)
        r = sum(1 for k, _, n, _ in events if k == "scatter" and n == name)
        assert (g, r) == ((2, 1) if _layer_of(name) is not None else (r, r)
                          ), (name, g, r)
    assert {_layer_of(n) for n in names} - {None} == set(range(layers))
    gathers = [at("gather", f"layers/{i}") for i in range(layers)]
    forward = [g[:len(g) // 2] for g in gathers]
    again = [g[len(g) // 2:] for g in gathers]
    assert sum(forward, []) == sorted(sum(forward, []))
    for i in range(1, layers):
        assert max(forward[i - 1]) < min(forward[i]), i
        assert max(at("scatter", f"layers/{i}")) < min(again[i - 1]), i
        assert max(again[i]) < min(at("scatter", f"layers/{i}")), i


def hold_high_water(got, key, what):
    """The gathered bytes alive at once: at most the two largest use
    sites' (a layer's blocks, the embedding, the head), below the whole
    compute copy a rank gathered before; the port's ``Meter`` agrees."""
    sizes: dict = {}
    for kind, group, name, n in use_events(got, key):
        if kind == "gather":
            sizes.setdefault(group, {})[name] = n
    kept = [g for g in sizes if g.startswith("layers/")
            and _layer_of(g + "/x") is None]
    top2 = sum(sorted(sum(v.values()) for g, v in sizes.items()
                      if g not in kept)[-2:])
    bound = top2 + sum(sum(sizes[g].values()) for g in kept)
    peak = int(got[f"uses/{key}/peak"])
    whole = int(got[f"uses/{key}/whole"])
    print(f"{what}: gathered high-water {peak} B, the two largest use "
          f"sites {top2} B (and {bound - top2} B gathered for the whole "
          f"step), the whole compute copy {whole} B")
    assert 0 < peak <= bound < whole
    assert list(got[f"uses/{key}/meter"]) == [peak, bound]


USE_KEYS = USE_ARCHS + (f"{STACKED_ARCH}/stacked",)


@pytest.mark.parametrize("key", USE_KEYS)
@pytest.mark.parametrize("world", WORLDS)
def test_use_sites_gather_and_reduce_in_order(runs, world, key):
    """The placed step's data-axis gathers and reduce-scatters, per use
    (``repro_torch.distributed.fsdp``), at USE_LAYERS layers: a tied
    embedding's two use sites each reduced once; a stacked leaf split on
    its layer dim gathered and reduced once, before the layers and after
    them."""
    events = use_events(runs[0][world], key)
    hold_use_order(events, USE_LAYERS)
    embed = [k for k, _, n, _ in events if n == "embed"]
    tied = tget(key.split("/")[0], reduced=True).tie_embeddings
    assert embed.count("gather") == embed.count("scatter") == 1 + tied
    stacks = [(k, i) for i, (k, _, n, _) in enumerate(events)
              if n in ("layers/A_log", "layers/D_skip", "layers/dt_bias")]
    if key in USE_ARCHS:
        assert not stacks
        return
    layer = [i for i, (*_, n, _) in enumerate(events)
             if _layer_of(n) is not None]
    assert sorted(k for k, _ in stacks) == ["gather"] * 3 + ["scatter"] * 3
    assert all(i < min(layer) if k == "gather" else i > max(layer)
               for k, i in stacks)


@pytest.mark.parametrize("key", USE_KEYS)
@pytest.mark.parametrize("world", WORLDS)
def test_use_sites_high_water(runs, world, key):
    """No rank holds the whole compute copy: the gathered bytes alive at
    once stay within two use sites (and the stacked leaves gathered for
    the whole step)."""
    hold_high_water(runs[0][world], key, f"{key} world {world}")


@pytest.mark.parametrize("world", WORLDS)
def test_stacked_split_leaves_train_as_their_columns(runs, world):
    """mamba2's per-head vectors split on their layer dim over the data
    axes train as on ``zero1_specs``' own layout (split on their heads):
    every param of the two steps within 3e-5."""
    got = runs[0][world]
    key = f"{STACKED_ARCH}/stacked"
    assert "Shard(dim=0)" in str(got[f"uses/{key}/placements"])
    assert float(got[f"uses/{key}/diff"]) <= 3e-5


@pytest.mark.parametrize("world", WORLDS)
def test_use_site_gradient_is_the_f32_scatter_sum(runs, world):
    """``UseSite`` on an f32 block split over every data axis: forward the
    bf16 cast gathered whole, backward the f32 block that ``scatter_sum``
    makes of the ranks' bf16 gradients widened to f32, bit for bit."""
    got = runs[0][world]
    assert str(got["grad/dtype"]) == "torch.float32"
    assert got["grad/equal"] and got["grad/forward"]
    assert [tuple(s) for s in got["grad/shapes"]] == [(16 // world, 8),
                                                      (16, 8)]
