"""The ``flash_attention`` kernel's backward
(``repro_torch/csrc/flash_attention_bwd.cu``): its plan and the plain
model of its two passes, on the CPU.

The kernel runs only on the card (``test_torch_train_cuda.py``, and
``chip_smoke.py``'s phase 10).  Here its plain model,
``repro_torch.kernels.ref.flash_attention_bwd_tiles`` (the dQ pass over
the key tiles a query tile can see, the dK/dV pass over the rows that
can see each key tile, the head split of the bf16 path's dK/dV blocks, P
recomputed from the forward's log-sum-exp, rows that see no key), at the
bf16 path's tiles and the f32 path's, is held against ``jax.vjp`` of the
JAX package's ``repro.kernels.ref.flash_attention`` from the same numpy
inputs, f32 ``rtol=atol=3e-5`` (``tests/test_kernels.py``), in every mask
mode; and ``flash_bwd_plan`` cuts the main path's shapes within the
card's limits on both paths, the bf16 path's grids filling the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

TOL = dict(rtol=3e-5, atol=3e-5)
# (B, S, H, KV, D): the sweep of tests/test_kernels.py, tinyllama-1.1b's
# heads at a serving prompt, and D = 256 over three tiles of each pass.
SHAPES = [(1, 64, 4, 4, 32), (2, 160, 8, 4, 64), (1, 257, 6, 2, 128),
          (2, 128, 25, 5, 64), (4, 12, 32, 4, 64), (1, 80, 4, 2, 256)]
MODES = [{}, dict(causal=False), dict(window=32), dict(softcap=20.0),
         dict(window=16, prefix=8), dict(window=32, softcap=50.0, prefix=4),
         dict(q_offset=64), dict(window=8, q_offset=5)]
# (B, S, T, H, KV, D): the main path's and the training run's shapes.
MAIN = [(4, 12, 12, 32, 4, 64), (1, 4, 4, 32, 4, 64), (4, 12, 12, 8, 4, 256),
        (4, 1024, 1024, 32, 4, 64), (1, 4200, 4200, 8, 4, 256),
        (2, 128, 128, 25, 5, 64), (1, 257, 257, 6, 2, 128),
        (1, 300, 300, 8, 4, 40)]


@pytest.fixture(autouse=True)
def _one_thread():
    """The tile models run thousands of tiny ops: one intra-op thread a
    test keeps parallel test workers from waking each other's pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _inputs(B, S, T, H, KV, D, seed=50):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))


def _bwd_reference(arrays, do, kwargs):
    """(dq, dk, dv) of the JAX package's plain attention by ``jax.vjp``:
    the gradient XLA takes where the reference trains."""
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention(q, k, v,
                                                           **kwargs),
                     *[jnp.asarray(a) for a in arrays])
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do))]


# Every mode on a multi-tile GQA shape and on D = 256, every shape with
# no mask beyond causal and with window, softcap and prefix together.
CASES = sorted({(s, i) for s in (1, 5) for i in range(len(MODES))}
               | {(s, i) for s in range(len(SHAPES)) for i in (0, 5)})


@pytest.mark.parametrize("shape,kwargs", [(SHAPES[s], MODES[i])
                                          for s, i in CASES])
def test_backward_model_matches_reference(shape, kwargs):
    """``ref.flash_attention_bwd_tiles`` at the bf16 backward plan's tiles
    and head split (the kernel's dQ pass over key tiles, its dK/dV pass
    over the rows that can see each key tile, P from the forward's
    log-sum-exp) against ``jax.vjp`` of the reference's attention, f32,
    from the same numpy inputs; the port's autograd oracle too."""
    B, S, H, KV, D = shape
    arrays = _inputs(B, S, S, H, KV, D)
    do = np.random.default_rng(51).standard_normal(
        (B, S, H, D)).astype(np.float32)
    t = [torch.from_numpy(a) for a in arrays]
    out, lse = tref.flash_attention_lse(*t, **kwargs)
    p = tfa.flash_bwd_plan(B, S, S, H, KV, D, True)
    got = tref.flash_attention_bwd_tiles(*t, out, torch.from_numpy(do), lse,
                                         big=p.big, small=p.small,
                                         splits=p.head_split, **kwargs)
    oracle = tref.flash_attention_bwd(*t, torch.from_numpy(do), **kwargs)
    for g, o, w in zip(got, oracle, _bwd_reference(arrays, do, kwargs)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
        np.testing.assert_allclose(o.numpy(), w, **TOL)


@pytest.mark.parametrize("kwargs,T", [(dict(window=8, q_offset=20), 40),
                                      (dict(window=4, q_offset=100), 40),
                                      (dict(causal=False, window=4,
                                            q_offset=30), 20)])
def test_backward_model_rows_that_see_nothing(kwargs, T):
    """Rows past T + window - 1 see no key: the forward's lse is -inf
    there, their dQ is zero, and each adds dO / T to every key's dV, as
    the reference's finite mask does (the wrapper flags such calls); at
    the f32 path's tiles, and split over the two heads of a KV head as
    the bf16 path's dK/dV blocks may be."""
    B, S, H, KV, D = 1, 64, 4, 2, 32
    arrays = _inputs(B, S, T, H, KV, D)
    do = np.random.default_rng(52).standard_normal(
        (B, S, H, D)).astype(np.float32)
    t = [torch.from_numpy(a) for a in arrays]
    out, lse = tref.flash_attention_lse(*t, **kwargs)
    assert torch.isneginf(lse).any()
    assert tfa.has_empty_rows(S, T, kwargs.get("causal", True),
                              kwargs["window"], 0, kwargs["q_offset"])
    for big, small, splits in ((64, 64, 1), (64, 32, 2), (32, 32, 1),
                               (16, 8, 2)):
        got = tref.flash_attention_bwd_tiles(
            *t, out, torch.from_numpy(do), lse, big=big, small=small,
            splits=splits, **kwargs)
        for g, w in zip(got, _bwd_reference(arrays, do, kwargs)):
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        empty = torch.isneginf(lse).permute(0, 2, 1)
        assert (got[0][empty] == 0).all()


@pytest.mark.parametrize("S,T,kwargs,empty", [
    (12, 12, {}, False), (64, 128, dict(q_offset=64), False),
    (4200, 4200, dict(window=4096), False),
    (64, 40, dict(window=8, q_offset=20), True),
    (64, 40, dict(window=8, q_offset=20, prefix=2), False),
    (10, 5, dict(causal=False, window=3, q_offset=4), True)])
def test_has_empty_rows(S, T, kwargs, empty):
    assert tfa.has_empty_rows(S, T, kwargs.get("causal", True),
                              kwargs.get("window", 0),
                              kwargs.get("prefix", 0),
                              kwargs.get("q_offset", 0)) == empty


@pytest.mark.parametrize("shape", MAIN)
def test_backward_plan_fits_the_card(shape):
    """The f32 path: D pads to 64, 128 or 256; the tiles are (64, 64),
    (64, 32) and (32, 32); the shared bytes are the source's layout and
    fit a block (two an SM at D <= 64); the grids cover every query row
    and key."""
    B, S, T, H, KV, D = shape
    p = tfa.flash_bwd_plan(*shape)
    assert p.path == "f32" and (p.col_split, p.stages, p.head_split) == (
        1, 1, 1)
    assert p.dp in (64, 128, 256) and D <= p.dp
    assert (p.big, p.small) == {64: (64, 64), 128: (64, 32),
                                256: (32, 32)}[p.dp]
    assert p.threads == 256
    assert p.smem == tfa._bwd_smem(p.dp, p.big, p.small)
    assert p.smem <= 227 * 1024
    assert p.sm_blocks == (2 if p.dp == 64 else 1)
    assert p.q_blocks == B * H * -(-S // p.big)
    assert p.kv_blocks == B * KV * -(-T // p.big)
    # The register tiles of the two kernels divide evenly among threads.
    assert p.big * p.small % (4 * p.threads) == 0
    assert (p.dp // 4) % (p.threads // (p.big // 4)) == 0


@pytest.mark.parametrize("shape", MAIN)
def test_backward_bf16_plan_fits_and_fills_the_card(shape):
    """The bf16 path: own rows, streamed rows and warps to a 16-row slice
    are (64, 64, 1), (64, 32, 2) and (64, 64, 2) at D padded to 64, 128
    and 256; a block's shared bytes are the source's ``layout16`` and fit
    the card's 227 KB, two stages of the streamed tiles among them; the
    grids cover every query row and key; the dK/dV grid is split over a
    KV head's query heads (a divisor of G, at most 8) until it holds four
    blocks an SM, or as far as G allows; the dQ grid is never split."""
    B, S, T, H, KV, D = shape
    G = H // KV
    p = tfa.flash_bwd_plan(*shape, True)
    assert p.path == "bf16" and D <= p.dp
    assert (p.big, p.small, p.col_split) == {64: (64, 64, 1),
                                             128: (64, 32, 2),
                                             256: (64, 64, 2)}[p.dp]
    assert p.threads == 32 * p.big // 16 * p.col_split and p.stages == 2
    assert p.smem == tfa._bwd16_smem(p.dp) <= 227 * 1024
    assert p.sm_blocks >= 1
    assert p.q_blocks == B * H * -(-S // p.big)
    tiles = B * KV * -(-T // p.big)
    assert p.kv_blocks == tiles * p.head_split
    assert G % p.head_split == 0 and p.head_split <= 8
    fewer = [d for d in range(1, p.head_split) if G % d == 0]
    assert all(tiles * d < 4 * tfa.H100_SMS for d in fewer)
    assert (p.kv_blocks >= 4 * tfa.H100_SMS or p.head_split ==
            max(d for d in range(1, min(G, 8) + 1) if G % d == 0))


@pytest.mark.parametrize("G,blocks,hs", [(8, 256, 4), (4, 264, 2),
                                         (5, 170, 5), (2, 528, 1),
                                         (1, 4, 1), (16, 8, 8), (6, 100, 6),
                                         (6, 200, 3)])
def test_head_split(G, blocks, hs):
    """tinyllama (G = 8, 256 key tiles), gemma2 at D = 256 (G = 2), hymba
    (G = 5, 170 tiles), and the edges: one head, a G past the cluster's
    8, a split that reaches four blocks an SM before G does."""
    assert tfa.head_split(G, blocks, 132) == hs


def test_backward_plan_refuses_wide_heads():
    with pytest.raises(ValueError, match="D <= 256"):
        tfa.flash_bwd_plan(1, 8, 8, 2, 2, 320)
