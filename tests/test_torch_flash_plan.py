"""The ``flash_attention`` kernel's plan and key tiles, on the CPU.

The kernel itself (``repro_torch/csrc/flash_attention.cu``) runs only on
the card (``test_torch_kernels_cuda.py``).  Here its plain model,
``repro_torch.kernels.ref.flash_attention_tiles`` (query tiles of the
plan's positions with all query heads of a KV head together, key tiles
over the range the rows can see, the row max and sum once a tile, rows
with nothing visible in a tile left alone), is held against the JAX
package's ``repro.kernels.ref.flash_attention`` and its Pallas kernel in
interpret mode, from the same numpy inputs, at the tolerances of
``tests/test_kernels.py`` (f32 3e-5, bf16 3e-2): in every mask mode
(causal, window, window with prefix, softcap, ``q_offset``, tiles where a
row sees nothing, rows that see nothing at all), at the plan's tiles and
at every key tile.  And ``flash_plan`` cuts the main path's shapes within
the card's limits, from the shapes alone.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_plan

TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, S, H, KV, D): the sweep of tests/test_kernels.py, tinyllama-1.1b's
# and gemma2-2b's heads at a serving prompt, and a grouped long prompt.
SHAPES = [(1, 64, 4, 4, 32), (2, 160, 8, 4, 64), (1, 257, 6, 2, 128),
          (2, 128, 25, 5, 64), (4, 12, 32, 4, 64), (2, 12, 8, 4, 256),
          (1, 300, 8, 4, 256)]
MODES = [{}, dict(causal=False), dict(window=32), dict(softcap=20.0),
         dict(window=16, prefix=8), dict(window=32, softcap=50.0, prefix=4),
         dict(q_offset=64), dict(window=8, q_offset=5)]


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


def _run(shape, dtype, kwargs, bq, bk, T=None):
    B, S, H, KV, D = shape
    arrays = _inputs(B, S, T or S, H, KV, D)
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays]
    got = tref.flash_attention_tiles(*t, bq=bq, bk=bk, **kwargs)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    return got.float().numpy(), j


def _plan(shape, dtype, T=None):
    B, S, H, KV, D = shape
    return flash_plan(B, S, T or S, H, KV, D, TDT[dtype])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", MODES)
def test_tile_model_matches_reference(shape, dtype, kwargs):
    p = _plan(shape, dtype)
    got, j = _run(shape, dtype, kwargs, p.bq, p.bk)
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention(*j, **kwargs), np.float32),
        **TOL[dtype])


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]])
@pytest.mark.parametrize("bq,bk", [(8, 16), (16, 32), (64, 64), (3, 16)])
@pytest.mark.parametrize("kwargs", [MODES[0], MODES[4], MODES[5]])
def test_tile_model_at_every_tile(shape, bq, bk, kwargs):
    """Every key tile the kernel is built for, grouped (8 positions of
    every head) and not, also against the Pallas kernel in interpret
    mode."""
    got, j = _run(shape, "float32", kwargs, bq, bk)
    want = np.asarray(jref.flash_attention(*j, **kwargs), np.float32)
    np.testing.assert_allclose(got, want, **TOL["float32"])
    pallas = jfa.flash_attention(*j, block_q=32, block_k=32, interpret=True,
                                 **kwargs)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               **TOL["float32"])


def test_tile_model_rows_that_see_nothing():
    """q_offset past the window of every key: every row is masked in every
    tile and gets the mean of v over all T, as the reference's softmax of
    an all-masked row does; and a tile where only later rows see keys."""
    shape = (2, 6, 4, 2, 32)
    for kwargs in (dict(window=4, q_offset=100), dict(window=2)):
        got, j = _run(shape, "float32", kwargs, bq=3, bk=16, T=40)
        want = jref.flash_attention(*j, **kwargs)
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **TOL["float32"])


def test_tile_model_one_tile_equals_plain():
    """One query tile and one key tile holding everything: the plain
    version's arithmetic up to the order of one sum."""
    t = [torch.from_numpy(a) for a in _inputs(2, 12, 12, 8, 4, 64)]
    torch.testing.assert_close(
        tref.flash_attention_tiles(*t, bq=12, bk=16),
        tref.flash_attention(*t), rtol=1e-6, atol=1e-6)


# (B, S, T, H, KV, D): the serving prefill of tinyllama-1.1b and gemma2-2b
# (batch 1 and 4), the replay's prefills (4 x 1024, 2 x 4200), the sweep.
MAIN = [(4, 12, 12, 32, 4, 64), (1, 4, 4, 32, 4, 64), (4, 12, 12, 8, 4, 256),
        (1, 4, 4, 8, 4, 256), (4, 1024, 1024, 32, 4, 64),
        (2, 4200, 4200, 8, 4, 256), (2, 128, 128, 25, 5, 64),
        (1, 257, 257, 6, 2, 128), (1, 300, 300, 8, 4, 40)]


@pytest.mark.parametrize("shape", MAIN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plan_fits_the_card(shape, dtype):
    B, S, T, H, KV, D = shape
    p = flash_plan(*shape, dtype)
    assert p.dp in (32, 64, 128, 256) and p.dp // 2 < D <= p.dp
    assert p.rows == (32 if p.dp == 256 else 64) and p.threads == 128
    assert p.heads in (1, H // KV) and p.bq * p.heads <= p.rows
    assert p.bk in (16, 32, 64) and p.stages == (1 if T <= p.bk else 2)
    assert p.smem <= 227 * 1024 and p.sm_blocks >= 2
    assert p.smem == tfa._smem(p.dp, p.rows, p.bk,
                               2 if dtype == torch.bfloat16 else 4, p.stages)
    heads_grid = KV if p.heads > 1 else H
    assert p.blocks == B * heads_grid * -(-S // p.bq)
    if p.heads > 1:  # grouping only where the grid still fills the card
        assert p.blocks >= tfa.H100_SMS
    if S <= 12:  # serving: one head a block gives more blocks
        assert p.heads == 1 and p.stages == 1 and p.bk == 16
    if S >= 1024:  # the replay groups: K/V staged once for G heads
        assert p.heads == H // KV and p.stages == 2


def test_flash_plan_groups_when_the_grid_fills():
    """At 132 SMs tinyllama's 4 x 1024 groups; on a card of 4096 SMs the
    grouped grid (2048 blocks) would not fill it, so it does not."""
    assert flash_plan(4, 1024, 1024, 32, 4, 64, torch.float32).heads == 8
    assert flash_plan(4, 1024, 1024, 32, 4, 64, torch.float32,
                      sms=4096).heads == 1

