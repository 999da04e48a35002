"""Training on the port against the JAX package's, on the CPU: the dense,
vision and audio families (the SSM, hybrid and MoE families are in
``test_torch_training_families.py``, which imports the checks below).

For every reduced architecture, with the reference's weights carried over
as numpy (``params_from_numpy``) and the same numpy batch:

* the counterpart of ``test_models.py::test_smoke_forward_and_train_step``;
* ``loss_fn``'s loss, nll, accuracy and z-loss term against the
  reference's;
* every gradient leaf against ``jax.grad`` at f32 (``compute_dtype=None``);
* one ``make_train_step`` step's params and AdamW moments against JAX's,
  and again with ``grad_accum=2`` and with ``compression=True``;
* ``remat=True`` gradients equal to ``remat=False`` ones.

Also the loss over chunks of ``CE_CHUNK`` with a remainder, the
mixed-precision (bf16) gradients and step, and ``warmup_cosine``.
Tolerances: f32 ``rtol=atol=3e-5`` as in ``tests/test_kernels.py`` (a
step's params and moments at all but its ill-conditioned elements, see
``ill_conditioned``); a bf16 compute copy 3e-2 relative l2.
"""
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
from repro_torch.models import transformer as TT
from repro_torch.training import optim as TO
from repro_torch.training import pytree
from repro_torch.training import train_step as TS

TOL = dict(rtol=3e-5, atol=3e-5)
BF16_REL_L2 = 3e-2
DENSE = ["tinyllama-1.1b", "yi-6b", "granite-3-2b", "gemma2-2b",
         "musicgen-large", "internvl2-1b"]
Z = 1e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def make_batch(cfg, B=2, S=16, seed=0):
    """numpy tokens (B, S) or (B, S, Kcb), labels (the tokens rolled by
    one) and, for the vision stub, patch embeddings."""
    rng = np.random.default_rng(seed)
    shape = (B, S) if cfg.num_codebooks == 1 else (B, S, cfg.num_codebooks)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def setup(arch, seed=0, B=2, S=16):
    jcfg, tcfg = jget(arch, reduced=True), tget(arch, reduced=True)
    jparams = JT.init_params(jcfg, jax.random.key(seed), jnp.float32)
    tparams = TT.params_from_numpy(np_tree(jparams))
    jb, tb = both(make_batch(jcfg, B, S, seed))
    return jcfg, tcfg, jparams, tparams, jb, tb


def hold(got, want, tol=TOL, what="", exempt=None, bound=None):
    """Every leaf of the port's tree against the reference's.  Elements
    that ``exempt`` (a list of boolean arrays, one a leaf) marks need not
    meet the tolerance; with ``bound``, they stay within it."""
    gl = pytree.leaves(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g)
        w = np.asarray(w, np.float32)
        assert np.isfinite(g).all(), (what, i)
        if exempt is not None:
            err = np.abs(g - w)[exempt[i]]
            if bound is not None:
                assert err.max(initial=0.0) <= bound, (what, i)
            g, w = g[~exempt[i]], w[~exempt[i]]
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} leaf {i}")


def torch_grads(tcfg, tparams, tb, remat=False):
    flat, structure = pytree.flatten(tparams)
    leaves = [p.detach().requires_grad_() for p in flat]
    loss, _ = TT.loss_fn(tcfg, pytree.unflatten(structure, leaves), tb,
                         remat=remat, z_loss=Z)
    return pytree.unflatten(structure, torch.autograd.grad(loss, leaves))


def check_smoke(arch):
    """One forward and one real train step: shapes, finiteness, every
    parameter tree moved (the reference's smoke test on the port)."""
    cfg = tget(arch, reduced=True)
    _, tb = both(make_batch(cfg))
    opt = TO.AdamW(lr=1e-3)
    state = TS.init_state(cfg, 0, opt, dtype=torch.float32, device="cpu")
    logits = TT.forward(cfg, state.params, tb)
    B, S = tb["tokens"].shape[:2]
    S_total = S + cfg.num_meta_tokens + (
        cfg.num_vision_tokens if cfg.frontend == "vision_stub" else 0)
    assert logits.shape == (B, S_total, cfg.num_codebooks, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    step = TS.make_train_step(cfg, opt, remat=True, compute_dtype=None)
    new_state, metrics = step(state, tb)
    assert np.isfinite(float(metrics["loss"]))
    delta = sum(float((a - b).abs().sum()) for a, b in zip(
        pytree.leaves(state.params), pytree.leaves(new_state.params)))
    assert delta > 0.0
    assert int(new_state.opt.step) == 1


def check_loss(arch):
    jcfg, tcfg, jparams, tparams, jb, tb = setup(arch)
    jl, jm = JT.loss_fn(jcfg, jparams, jb, remat=False, z_loss=Z)
    tl, tm = TT.loss_fn(tcfg, tparams, tb, remat=False, z_loss=Z)
    for k in ("loss", "nll", "accuracy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl - tm["nll"]),
                               float(jl - jm["nll"]), rtol=3e-5, atol=1e-9)
    assert float(tl - tm["nll"]) > 0  # the z-loss term is there


def check_grads(arch):
    jcfg, tcfg, jparams, tparams, jb, tb = setup(arch)
    jg = jax.grad(lambda p: JT.loss_fn(jcfg, p, jb, remat=False,
                                       z_loss=Z)[0])(jparams)
    hold(torch_grads(tcfg, tparams, tb), jg, what=f"{arch} grads")


def check_remat(arch):
    _, tcfg, _, tparams, _, tb = setup(arch)
    a = pytree.leaves(torch_grads(tcfg, tparams, tb, remat=False))
    b = pytree.leaves(torch_grads(tcfg, tparams, tb, remat=True))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


LR = 1e-3
# Adam's first step moves each element by lr g / (|g| + eps), nearly
# +-lr whatever |g|, and an int8-compressed gradient rounds g / scale to
# an integer.  So a step is ill-conditioned at two kinds of elements: a
# gradient that the gradient check itself cannot tell from zero (within
# its 3e-5 of the tree's largest; top-1 routing's router gradient is zero
# in exact arithmetic), whose relative error can be large and which can
# step either way, and a compressed element on a rounding boundary
# (g / scale within 1e-3 of a half), which can round either way.  The step's params,
# moments and error are held at the f32 tolerance everywhere else, and
# those params within the step's bound; the gradients themselves are
# held element by element (check_grads).
NOISE = 3e-5
STEP_BOUND = 2 * LR * (1 + 0.1 * 4.0)  # lr (|update| + decay |p|), |p| < 4


def ill_conditioned(grads, compression=False, error=None):
    """The elements of a step where the two packages may part (above),
    from the step's gradient leaves (numpy, one a leaf; the compression's
    carried ``error`` leaves added, if any), one boolean array a leaf."""
    top = max(float(np.abs(x).max()) for x in grads)
    out = []
    for i, x in enumerate(grads):
        bad = np.abs(x) <= NOISE * top
        if compression and x.ndim >= 2:
            if error is not None:
                x = x + np.asarray(error[i])
            r = x / (max(float(np.abs(x).max()), 1e-12) / 127.0)
            bad |= np.abs(np.abs(r - np.trunc(r)) - 0.5) < 1e-3
        out.append(bad)
    return out


def step_grads(tcfg, tparams, tb, grad_accum=1):
    """The gradient leaves a step takes (the mean over its micro-slices),
    numpy, the port's: the gradient check holds them to the reference's."""
    def micro(i):
        return {k: v[i * (v.shape[0] // grad_accum):
                     (i + 1) * (v.shape[0] // grad_accum)]
                for k, v in tb.items()}

    grads = [pytree.leaves(torch_grads(tcfg, tparams, micro(i)))
             for i in range(grad_accum)]
    return [np.mean([g[j].numpy() for g in grads], axis=0)
            for j in range(len(grads[0]))]


def check_step(arch, **kw):
    """One train step (f32 compute) against the reference's: params,
    both moments, the step count, the loss and the gradient norm."""
    jcfg, tcfg, jparams, tparams, jb, tb = setup(arch)
    jopt, topt = JO.AdamW(lr=LR), TO.AdamW(lr=LR)
    comp = kw.get("compression", False)
    jstate = JS.TrainState(
        jparams, jopt.init(jparams),
        JS.CompressionState.init(jparams) if comp else None)
    tstate = TS.state_from_params(tparams, topt, compression=comp)
    jstate, jm = JS.make_train_step(jcfg, jopt, compute_dtype=None,
                                    **kw)(jstate, jb)
    tstate, tm = TS.make_train_step(tcfg, topt, compute_dtype=None,
                                    **kw)(tstate, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), **TOL)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 1
    ex = ill_conditioned(step_grads(tcfg, tparams, tb,
                                    kw.get("grad_accum", 1)), comp)
    hold(tstate.params, jstate.params, what=f"{arch} params {kw}",
         exempt=ex, bound=STEP_BOUND)
    hold(tstate.opt.mu, jstate.opt.mu, what=f"{arch} mu {kw}", exempt=ex)
    hold(tstate.opt.nu, jstate.opt.nu, tol=dict(rtol=3e-5, atol=1e-9),
         what=f"{arch} nu {kw}", exempt=ex)
    if comp:
        hold(tstate.comp.error, jstate.comp.error, what=f"{arch} error",
             exempt=ex)


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_forward_and_train_step(arch):
    check_smoke(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_matches_reference(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_remat_grads_equal_plain(arch):
    check_remat(arch)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("kw", [{}, dict(grad_accum=2),
                                dict(compression=True)],
                         ids=["step", "grad_accum", "compression"])
def test_train_step_matches_reference(arch, kw):
    check_step(arch, **kw)


def test_loss_over_chunks_and_remainder():
    """1100 positions: two chunks of CE_CHUNK (512), each checkpointed,
    and a remainder of 76; loss and gradients against the reference's."""
    jcfg, tcfg, jparams, tparams, jb, tb = setup("tinyllama-1.1b", B=1,
                                                 S=1100)
    jl, jm = JT.loss_fn(jcfg, jparams, jb, remat=True, z_loss=Z)
    tl, tm = TT.loss_fn(tcfg, tparams, tb, remat=True, z_loss=Z)
    for k in ("loss", "nll", "accuracy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    jg = jax.grad(lambda p: JT.loss_fn(jcfg, p, jb, remat=True,
                                       z_loss=Z)[0])(jparams)
    hold(torch_grads(tcfg, tparams, tb, remat=True), jg,
         what="chunked grads")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b"])
def test_mixed_precision_matches_reference(arch):
    """A bf16 compute copy (the default): the gradients through the cast
    against the reference's, all leaves together within 3e-2 relative l2
    (both packages round activations to bf16, at other places: the
    reference also rounds its softmax weights); the step keeps f32 master
    leaves, its loss and gradient norm within 3e-2."""
    jcfg, tcfg, jparams, tparams, jb, tb = setup(arch, B=4)

    def jcast(p):
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                            if x.ndim >= 2 else x, p)

    jg = jax.grad(lambda p: JT.loss_fn(jcfg, jcast(p), jb, z_loss=Z)[0])(
        jparams)
    flat, structure = pytree.flatten(tparams)
    leaves = [p.detach().requires_grad_() for p in flat]
    tcast = pytree.tree_map(lambda p: p.to(torch.bfloat16)
                            if p.ndim >= 2 else p,
                            pytree.unflatten(structure, leaves))
    loss, _ = TT.loss_fn(tcfg, tcast, tb, z_loss=Z)
    tg = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == torch.float32 for g in tg)
    got = np.concatenate([g.numpy().ravel() for g in tg])
    want = np.concatenate([np.asarray(g, np.float32).ravel()
                           for g in jax.tree.leaves(jg)])
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)
    jopt, topt = JO.AdamW(lr=1e-3), TO.AdamW(lr=1e-3)
    _, jm = JS.make_train_step(jcfg, jopt)(
        JS.TrainState(jparams, jopt.init(jparams), None), jb)
    tnew, tm = TS.make_train_step(tcfg, topt)(
        TS.state_from_params(tparams, topt), tb)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=BF16_REL_L2)
    assert all(p.dtype == torch.float32 for p in pytree.leaves(tnew.params))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 30, 60, 100])
def test_warmup_cosine_matches_reference(step):
    j = JO.warmup_cosine(3e-3, 10, 60)(jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(TO.warmup_cosine(3e-3, 10, 60)(step),
                               float(j), rtol=1e-6)
