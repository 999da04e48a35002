"""Checkpointing, fault tolerance and gradient compression on the port,
and checkpoints that cross between the two packages.

The reference's ``TestCheckpoint`` (roundtrip, atomic commit, gc, bf16,
async), ``TestFaultTolerance`` (recovery, loss decreases, gives up) and
``TestCompression`` on the port, on the CPU; the port's recovery is held
bit for bit.  Then the reference's ``repro.distributed.checkpoint`` and
the port's read each other's checkpoints: a JAX ``TrainState`` after 3
steps, saved by the reference and restored by the port, trained 2 more
steps on the port, equals the reference's 5-step state, and the reverse;
bf16 leaves cross as their raw bits.  Tolerances: f32 ``rtol=atol=3e-5``
(``tests/test_kernels.py``), bit-equal where both sides run the same
package.  The reference's multi-device cases (``compressed_psum``,
restore onto shardings, ``reshard``) are ROADMAP A10; the port's
``restore`` refuses shardings.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.distributed import checkpoint as jckpt
from repro.distributed import compression as JC
from repro.models import transformer as JT
from repro.training import optim as JO
from repro.training import train_step as JS
from repro_torch.configs import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.compression import (CompressionState,
                                                 compress_grads)
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     NodeFailure,
                                                     run_supervised)
from repro_torch.models import transformer as TT
from repro_torch.training import pytree
from repro_torch.training.data import DataConfig, SyntheticStream
from repro_torch.training.optim import AdamW, warmup_cosine
from repro_torch.training.train_step import (init_state, make_train_step,
                                             state_from_params)
from test_torch_training import STEP_BOUND, ill_conditioned

TOL = dict(rtol=3e-5, atol=3e-5)


class TestCheckpoint:
    def test_roundtrip(self):
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "b": {"c": torch.ones((5,), dtype=torch.int32)}}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(tree, d, step=7)
            assert ckpt.latest_step(d) == 7
            out = ckpt.restore(tree, d)
            assert torch.equal(out["a"], tree["a"])
            assert out["b"]["c"].dtype == torch.int32

    def test_atomic_no_partial_commit(self):
        tree = {"a": torch.zeros((4,))}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(tree, d, step=1)
            # simulate a crashed save: stray tmp dir must be ignored
            os.makedirs(os.path.join(d, "step_00000002.tmp"))
            assert ckpt.latest_step(d) == 1
            ckpt.restore(tree, d)

    def test_gc_keeps_recent(self):
        tree = {"a": torch.zeros((2,))}
        with tempfile.TemporaryDirectory() as d:
            for s in range(6):
                ckpt.save(tree, d, step=s)
            kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
            assert kept == [f"step_{s:08d}" for s in (3, 4, 5)]

    def test_bf16_roundtrip(self):
        """bf16 is written as numpy void16 and viewed back."""
        tree = {"w": torch.arange(8.0, dtype=torch.bfloat16),
                "q": torch.arange(4, dtype=torch.int8)}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(tree, d, step=1)
            out = ckpt.restore(tree, d)
            assert out["w"].dtype == torch.bfloat16
            assert torch.equal(out["w"], tree["w"])
            assert torch.equal(out["q"], tree["q"])

    def test_async_save_snapshots_at_the_call(self):
        tree = {"a": torch.arange(6.0)}
        with tempfile.TemporaryDirectory() as d:
            saver = ckpt.AsyncCheckpointer()
            saver.save_async(tree, d, step=3)
            tree["a"].add_(100.0)  # after the snapshot: not saved
            saver.wait()
            assert ckpt.latest_step(d) == 3
            assert torch.equal(ckpt.restore(tree, d)["a"], torch.arange(6.0))

    def test_restore_onto_shardings_is_not_ported(self):
        tree = {"a": torch.zeros((2,))}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(tree, d, step=1)
            with pytest.raises(NotImplementedError, match="ROADMAP A10"):
                ckpt.restore(tree, d, shardings={"a": None})


def _setup(total=40):
    cfg = get_config("tinyllama-1.1b", reduced=True)
    opt = AdamW(lr=warmup_cosine(3e-3, 5, total), weight_decay=0.01)
    step_fn = make_train_step(cfg, opt, remat=True, compute_dtype=None)
    state = init_state(cfg, 0, opt, device="cpu")
    ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4))

    def batch_fn(s):
        return {k: torch.from_numpy(v) for k, v in ds.batch_at(s).items()}

    return state, step_fn, batch_fn


class TestFaultTolerance:
    @pytest.mark.parametrize("async_save", [False, True])
    def test_recovery_bitwise_identical(self, async_save):
        state, step_fn, batch_fn = _setup()
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            a = run_supervised(init_state=state, step_fn=step_fn,
                               batch_fn=batch_fn, total_steps=8,
                               ckpt_dir=d1, ckpt_every=3, async_save=False)
            b = run_supervised(
                init_state=state, step_fn=step_fn, batch_fn=batch_fn,
                total_steps=8, ckpt_dir=d2, ckpt_every=3,
                injector=FailureInjector(fail_at_steps=(4, 7)),
                async_save=async_save)
            assert b.restarts == 2 and a.steps_completed == 8
            assert a.losses[-1] == b.losses[-1]
            fa = ckpt.restore(state, d1)
            fb = ckpt.restore(state, d2)
            for x, y in zip(pytree.leaves(fa), pytree.leaves(fb)):
                assert torch.equal(x, y)

    def test_loss_decreases(self):
        state, step_fn, batch_fn = _setup()
        with tempfile.TemporaryDirectory() as d:
            rep = run_supervised(init_state=state, step_fn=step_fn,
                                 batch_fn=batch_fn, total_steps=25,
                                 ckpt_dir=d, ckpt_every=10,
                                 async_save=False)
        assert rep.losses[-1] < rep.losses[0] * 0.8

    def test_gives_up_after_max_restarts(self):
        state, step_fn, batch_fn = _setup()
        with tempfile.TemporaryDirectory() as d:
            with pytest.raises(NodeFailure):
                run_supervised(
                    init_state=state, step_fn=step_fn, batch_fn=batch_fn,
                    total_steps=10, ckpt_dir=d, ckpt_every=100,
                    injector=FailureInjector(fail_at_steps=(1,)),
                    max_restarts=0)


class TestCompression:
    def test_error_feedback_unbiased(self):
        """Long-run mean of compressed grads ≈ mean of true grads."""
        rng = np.random.default_rng(0)
        g_true = torch.from_numpy(rng.normal(size=(64, 64)).astype(
            np.float32))
        state = CompressionState.init({"w": g_true})
        acc = torch.zeros_like(g_true)
        for _ in range(50):
            out, state = compress_grads({"w": g_true}, state)
            acc = acc + out["w"]
        np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(),
                                   atol=5e-3)

    def test_compress_grads_matches_reference(self):
        """Three rounds of error feedback over a matrix and a vector."""
        rng = np.random.default_rng(1)
        gs = [{"m": rng.normal(size=(32, 48)).astype(np.float32),
               "v": rng.normal(size=(48,)).astype(np.float32)}
              for _ in range(3)]
        js = JC.CompressionState.init(jax.tree.map(jnp.asarray, gs[0]))
        ts = CompressionState.init(
            {k: torch.from_numpy(v) for k, v in gs[0].items()})
        for g in gs:
            jo, js = JC.compress_grads(jax.tree.map(jnp.asarray, g), js)
            to, ts = compress_grads(
                {k: torch.from_numpy(v) for k, v in g.items()}, ts)
            for k in g:
                np.testing.assert_allclose(to[k].numpy(),
                                           np.asarray(jo[k]), **TOL)
                np.testing.assert_allclose(ts.error[k].numpy(),
                                           np.asarray(js.error[k]), **TOL)

    def test_training_with_compression_converges(self):
        cfg = get_config("tinyllama-1.1b", reduced=True)
        opt = AdamW(lr=3e-3)
        step = make_train_step(cfg, opt, compression=True,
                               compute_dtype=None)
        state = init_state(cfg, 0, opt, compression=True, device="cpu")
        ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=4))
        losses = []
        for s in range(20):
            batch = {k: torch.from_numpy(v)
                     for k, v in ds.batch_at(s).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# Checkpoints that cross between the packages
# ---------------------------------------------------------------------------
CROSS_STEPS, CROSS_AT = 5, 3


def _cross_cfg():
    return jget("tinyllama-1.1b", reduced=True)


def _cross_setup(compression):
    jcfg = _cross_cfg()
    tcfg = get_config("tinyllama-1.1b", reduced=True)
    sched = dict(peak_lr=1e-3, warmup=2, total=CROSS_STEPS)
    jopt = JO.AdamW(lr=JO.warmup_cosine(**sched))
    topt = AdamW(lr=warmup_cosine(**sched))
    jparams = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    jstate = JS.TrainState(
        jparams, jopt.init(jparams),
        JC.CompressionState.init(jparams) if compression else None)
    tstate = state_from_params(
        TT.params_from_numpy(jax.tree.map(np.asarray, jparams)), topt,
        compression)
    kw = dict(compute_dtype=None, compression=compression)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, **kw))
    tstep = make_train_step(tcfg, topt, **kw)
    ds = SyntheticStream(DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                    global_batch=4))
    return jstate, tstate, jstep, tstep, ds


def _hold_state(got, want, what, exempt=None):
    """The port's state against the reference's, leaf for leaf in
    checkpoint order (the step count exactly).  ``exempt`` marks, per
    param, the elements where a step is ill-conditioned
    (``test_torch_training.ill_conditioned``): there params, moments and
    error need only stay within the steps' bound."""
    gl, wl = pytree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    n = len(exempt) if exempt is not None else 0
    # Leaves: params, the step, mu, nu[, error]; the masks repeat.
    masks = ([None] * len(gl) if exempt is None else
             exempt + [None] + exempt * ((len(gl) - n - 1) // n))
    for i, (g, w, m) in enumerate(zip(gl, wl, masks)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, i)
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=what)
            continue
        if m is not None:
            assert np.abs(g - w)[m].max(initial=0.0) <= 2 * STEP_BOUND
            g, w = g[~m], w[~m]
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"{what} leaf {i}")


def _exempt(jcfg, states, batches, compression):
    """The union of the ill-conditioned elements of the steps run on
    different packages, from the reference's states before them."""
    masks = None
    for st, b in zip(states, batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g = jax.grad(lambda p: JT.loss_fn(jcfg, p, jb, z_loss=1e-4)[0])(
            st.params)
        m = ill_conditioned([np.asarray(x) for x in jax.tree.leaves(g)],
                            compression=compression,
                            error=(jax.tree.leaves(st.comp.error)
                                   if compression else None))
        masks = m if masks is None else [x | y for x, y in zip(masks, m)]
    return masks


@pytest.mark.parametrize("compression", [False, True])
def test_reference_checkpoint_restores_on_the_port(compression):
    """3 steps on the reference, its checkpoint restored by the port, 2
    more steps on the port: the reference's 5-step state."""
    jstate, tstate, jstep, tstep, ds = _cross_setup(compression)
    before = []
    for s in range(CROSS_STEPS):
        if s == CROSS_AT:
            with tempfile.TemporaryDirectory() as d:
                jckpt.save(jstate, d, CROSS_AT)
                tstate = ckpt.restore(tstate, d)
            _hold_state(tstate, jstate, "restored")
        batch = ds.batch_at(s)
        if s >= CROSS_AT:
            before.append(jstate)
            tstate, _ = tstep(tstate, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    assert int(tstate.opt.step) == CROSS_STEPS
    _hold_state(tstate, jstate, "5 steps", _exempt(
        _cross_cfg(), before,
        [ds.batch_at(s) for s in range(CROSS_AT, CROSS_STEPS)], compression))


@pytest.mark.parametrize("compression", [False, True])
def test_port_checkpoint_restores_on_the_reference(compression):
    """3 steps on the port, its checkpoint restored by the reference, 2
    more steps on the reference: the port's 5-step state."""
    jstate, tstate, jstep, tstep, ds = _cross_setup(compression)
    before = []
    for s in range(CROSS_STEPS):
        if s == CROSS_AT:
            with tempfile.TemporaryDirectory() as d:
                ckpt.save(tstate, d, CROSS_AT)
                jstate = jckpt.restore(jstate, d)
            _hold_state(tstate, jstate, "restored")
        batch = ds.batch_at(s)
        tstate, _ = tstep(tstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        if s >= CROSS_AT:
            before.append(jstate)
            jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    assert int(jstate.opt.step) == CROSS_STEPS
    _hold_state(tstate, jstate, "5 steps", _exempt(
        _cross_cfg(), before,
        [ds.batch_at(s) for s in range(CROSS_AT, CROSS_STEPS)], compression))


def test_bf16_leaves_cross_both_ways():
    """bf16, int8, int32 and f32 leaves, bit for bit in both directions,
    in the same files and manifest dtypes."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(w, jnp.bfloat16),
             "q": jnp.asarray(rng.integers(-128, 127, (7,)), jnp.int8),
             "n": {"s": jnp.asarray(3, jnp.int32), "f": jnp.asarray(w)}}
    ttree = {"w": torch.from_numpy(w).to(torch.bfloat16),
             "q": torch.from_numpy(np.asarray(jtree["q"])),
             "n": {"s": torch.tensor(3, dtype=torch.int32),
                   "f": torch.from_numpy(w)}}
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        jckpt.save(jtree, d1, 1)
        ckpt.save(ttree, d2, 1)
        for name in ("manifest.json",):
            import json
            with open(os.path.join(d1, "step_00000001", name)) as f:
                jm = json.load(f)
            with open(os.path.join(d2, "step_00000001", name)) as f:
                tm = json.load(f)
            assert jm["leaves"] == tm["leaves"]
        got = ckpt.restore(ttree, d1)
        back = jckpt.restore(jtree, d2)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], ttree["w"])
    for k in ("q",):
        assert torch.equal(got[k], ttree[k])
    assert torch.equal(got["n"]["s"], ttree["n"]["s"])
    assert torch.equal(got["n"]["f"], ttree["n"]["f"])
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["w"]).view(np.uint16),
        np.asarray(jtree["w"]).view(np.uint16))
    np.testing.assert_array_equal(np.asarray(back["q"]),
                                  np.asarray(jtree["q"]))
