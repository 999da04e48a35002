"""The split-key decode kernel's plan and two-pass arithmetic, on the CPU.

The kernel itself (``repro_torch/csrc/decode_attention.cu``) runs only on
the card (``test_torch_kernels_cuda.py``).  Here its plain model,
``repro_torch.kernels.ref.decode_attention_splits`` and the paged
counterpart (per-split partials over the visible keys, folded in split
order, empty splits skipped), is held against the JAX package's
``repro.kernels.ref`` from the same numpy inputs, at the tolerances of
``tests/test_kernels.py``: on its sweeps at several split lengths, and at
the masks that cut splits.  And ``split_plan`` cuts a dense cache and its
pages at the same logical rows, from the shapes alone.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as da
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DECODE_SHAPES = [(2, 300, 8, 4, 64), (1, 64, 4, 4, 32), (3, 1000, 14, 2, 64)]
PAGED_SHAPES = [(2, 300, 8, 4, 64, 128), (3, 96, 4, 2, 32, 16),
                (1, 64, 4, 4, 32, 64), (2, 37, 4, 2, 16, 5)]
MODES = [{}, dict(window=64), dict(softcap=30.0), dict(window=32, prefix=8)]
SPLITS = [16, 64, None]  # None: the whole cache in one split


def _inputs(seed, B, T, H, KV, D, dtype, lens=None):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, H, D), (B, T, KV, D), (B, T, KV, D))]
    if lens is None:
        lens = rng.integers(1, T, B)
    lens = np.asarray(lens, np.int32)
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return (*j, jnp.asarray(lens)), (*t, torch.from_numpy(lens))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("B,T,H,KV,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kwargs", MODES)
def test_split_model_matches_reference(B, T, H, KV, D, dtype, split, kwargs):
    jargs, targs = _inputs(20, B, T, H, KV, D, dtype)
    got = tref.decode_attention_splits(*targs, split=split or T, **kwargs)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, D)
    _close(got, jref.decode_attention(*jargs, **kwargs), dtype)


@pytest.mark.parametrize("B,T,H,KV,D,ps", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", SPLITS)
def test_paged_split_model_matches_reference(B, T, H, KV, D, ps, dtype,
                                             split):
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(21, B, T, H, KV, D, dtype)
    jpages = da.paginate_kv(jk, jv, jl, ps)
    tpages = ops.paginate_kv(tk, tv, tl, ps)
    got = tref.paged_decode_attention_splits(tq, *tpages, tl,
                                             split=split or T, window=32,
                                             prefix=4)
    _close(got, jref.paged_decode_attention(jq, *jpages, jl, window=32,
                                            prefix=4), dtype)


# Masks that cut the splits (split length 16 over 200 rows):
EDGES = {
    # the window's first key falls inside a split
    "window_starts_mid_split": (dict(window=40), [150, 71]),
    # a prefix and a window with empty splits between them
    "prefix_then_window": (dict(window=20, prefix=8), [190, 120]),
    # rows with nothing visible: the mean of v over all rows
    "zero_length": ({}, [0, 17]),
    # lengths past the cache: every row visible
    "lengths_past_T": (dict(softcap=20.0), [205, 200]),
}


@pytest.mark.parametrize("case", sorted(EDGES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_edges(case, dtype):
    kwargs, lens = EDGES[case]
    jargs, targs = _inputs(22, 2, 200, 4, 2, 32, dtype, lens)
    got = tref.decode_attention_splits(*targs, split=16, **kwargs)
    _close(got, jref.decode_attention(*jargs, **kwargs), dtype)


@pytest.mark.parametrize("case", sorted(EDGES))
@pytest.mark.parametrize("ps", [5, 16])
def test_paged_split_model_edges(case, ps):
    """The same masks through pages whose size does not line up with the
    splits (5), and the rows of a ragged last page."""
    kwargs, lens = EDGES[case]
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(23, 2, 200, 4, 2, 32,
                                                 "float32", lens)
    jpages = da.paginate_kv(jk, jv, jl, ps)
    tpages = ops.paginate_kv(tk, tv, tl, ps)
    got = tref.paged_decode_attention_splits(tq, *tpages, tl, split=16,
                                             **kwargs)
    _close(got, jref.paged_decode_attention(jq, *jpages, jl, **kwargs),
           "float32")


# (B, H, KV, D, cache dtype) of the main path: tinyllama's and gemma2's
# decode at the serving batch and in the replay, and the test sweeps.
PLAN_SHAPES = [(4, 32, 4, 64, torch.bfloat16), (4, 8, 4, 256, torch.bfloat16),
               (2, 8, 4, 256, torch.bfloat16), (4, 32, 4, 64, torch.float32),
               (3, 14, 2, 64, torch.float32), (2, 4, 2, 16, torch.float32),
               (1, 40, 8, 128, torch.bfloat16)]


@pytest.mark.parametrize("B,H,KV,D,kv_dtype", PLAN_SHAPES)
@pytest.mark.parametrize("ps", [5, 16, 128])
def test_split_plan_same_rows_dense_and_paged(B, H, KV, D, kv_dtype, ps):
    """A dense cache of T rows and its ``paginate_kv`` pool (NP * ps
    rows) split at the same logical rows below T; the pool's extra splits
    start at or past T, where no key of a length <= T is visible."""
    T = 1027
    k = torch.zeros((B, T, KV, D), dtype=kv_dtype)
    _, _, table = ops.paginate_kv(k, k, torch.full((B,), T), ps)
    rows = table.shape[1] * ps
    dense = ops.split_plan(B, H, KV, D, kv_dtype, T)
    paged = ops.split_plan(B, H, KV, D, kv_dtype, rows)
    assert (paged.split, paged.tile, paged.heads) == (dense.split, dense.tile,
                                                      dense.heads)
    starts_d = list(range(0, T, dense.split))
    starts_p = list(range(0, rows, paged.split))
    assert starts_p[:len(starts_d)] == starts_d
    assert all(s >= T for s in starts_p[len(starts_d):])
    assert len(starts_d) == dense.splits and len(starts_p) == paged.splits


@pytest.mark.parametrize("B,H,KV,D,kv_dtype", PLAN_SHAPES)
def test_split_plan_fits_the_kernel(B, H, KV, D, kv_dtype):
    """What the kernel's launcher accepts: a tile of 8 to 64 rows (a power
    of two) whose k takes at most 8 KB, a split a whole number of tiles,
    at most 8 query heads a block."""
    plan = ops.split_plan(B, H, KV, D, kv_dtype, 4096)
    esz = torch.empty((), dtype=kv_dtype).element_size()
    assert plan.tile in (8, 16, 32, 64) and plan.split % plan.tile == 0
    assert plan.tile * D * esz <= 8192
    chunks = -(-(H // KV) // plan.heads)  # blocks per KV head and split
    assert 1 <= plan.heads <= 8 and (H // KV) <= plan.heads * chunks
    assert plan.blocks == B * KV * chunks * plan.splits


@pytest.mark.parametrize("B,T,H,KV,D,splits", [
    (4, 20, 32, 4, 64, 1),     # tinyllama serving decode: one launch
    (4, 20, 8, 4, 256, 1),     # gemma2 serving decode: one launch
    (2, 4204, 8, 4, 256, 66),  # gemma2 replay: 8 pairs fill the card
    (4, 1028, 32, 4, 64, 33),  # tinyllama replay
])
def test_split_plan_at_the_main_path(B, T, H, KV, D, splits):
    plan = ops.split_plan(B, H, KV, D, torch.bfloat16, T)
    assert plan.splits == splits


def test_split_plan_never_reads_lengths():
    """The plan takes shapes and a type, not the lengths, and neither
    wrapper reads anything back to the host (a sync per layer)."""
    assert "lengths" not in inspect.signature(ops.split_plan).parameters
    for fn in (tda.decode_attention, tda.paged_decode_attention, tda._launch,
               tda.split_plan):
        src = inspect.getsource(fn)
        for host_read in (".item(", ".cpu(", ".tolist(", ".numpy("):
            assert host_read not in src, (fn.__name__, host_read)
