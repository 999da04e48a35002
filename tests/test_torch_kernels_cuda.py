"""Each hand-written Hopper kernel against its plain PyTorch version, on
the card (marked ``cuda``; skipped without an sm_90 device).  The shapes
are the sweeps of ``test_kernels.py`` plus the main path's widths
(tinyllama's and gemma2's attention, D=256 with window and softcap, and
the replay's grouped prefill; mamba2's scan at every chunk the plan picks;
the paged decode at the replay's long caches), in the
dtype combinations the serving path uses; the paged decode also against
the dense kernel on the same logical cache, bit for bit; the split-key
decode at the replay's shapes, two calls bit-identical, and at masks
that cut its splits; ``quant_matmul`` at every main-path projection
(decode and prefill), the replay's prefill, hymba-1.5b's N = 3257 and
each cluster size, one launch a call, two calls bit-identical; the
prefill attention and the scan two calls bit-identical; and the
int8-cache decode step on the card against the CPU.  Imports no JAX: it
runs on the machine with the card.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_plan
from repro_torch.kernels.quant_matmul import qmm_plan
from repro_torch.kernels.ssd_scan import ssd_plan

TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
QMM_TOL = dict(rtol=2e-4, atol=2e-4)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [(1, 64, 4, 4, 32), (2, 160, 8, 4, 64), (1, 257, 6, 2, 128),
                (2, 128, 25, 5, 64), (4, 12, 32, 4, 64), (4, 12, 8, 4, 256),
                (1, 300, 8, 4, 256)]
FLASH_MODES = [dict(window=32), dict(softcap=20.0), dict(window=16, prefix=8),
               dict(window=32, softcap=50.0, prefix=4), dict(q_offset=64)]
DECODE_SHAPES = [(2, 300, 8, 4, 64), (1, 64, 4, 4, 32), (3, 1000, 14, 2, 64),
                 (4, 20, 32, 4, 64), (4, 20, 8, 4, 256), (2, 300, 8, 4, 256)]
# gemma2-2b's attention: window 4096 with logit softcap 50 (at D=256 above).
GEMMA2_MODE = dict(window=4096, softcap=50.0)
SSD_SHAPES = [(1, 64, 2, 16, 1, 8), (2, 96, 4, 32, 2, 16),
              (1, 50, 2, 16, 1, 8), (2, 128, 48, 64, 1, 128),
              (4, 12, 48, 64, 1, 128),  # mamba2-780m serving prefill
              (1, 300, 48, 64, 1, 128),  # several chunks, ragged
              # The plan's edges: kQ = 32 in one stage with G > 1 and
              # N = 16; kQ = 64 (N = 16) over ragged chunks; two slices at
              # kQ = 32; P = 18 (no 16-byte rows: element-wise staging,
              # a second slice of 2 columns) with G = 3 and N = 12.
              (2, 20, 4, 64, 2, 16), (1, 150, 5, 64, 5, 16),
              (1, 200, 4, 32, 1, 128), (2, 33, 6, 18, 3, 12)]
QMM_SHAPES = [(64, 256, 128, 128, 8), (100, 384, 200, 128, 8),
              (32, 128, 64, 32, 4), (8, 512, 512, 512, 8)]
# Every distinct per-layer (K, N) at full width: tinyllama-1.1b,
# mamba2-780m (ssm_in, ssm_out), gemma2-2b.
QMM_MAIN_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                   (1536, 6448), (3072, 1536), (2304, 2048), (2304, 1024),
                   (2048, 2304), (2304, 9216), (9216, 2304)]


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def sm90():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


def _on(dev, *arrays, dtype="float32"):
    return [torch.from_numpy(a).to(dev, TDT[dtype]) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", [{}] + FLASH_MODES + [GEMMA2_MODE])
def test_flash_attention_kernel(sm90, B, S, H, KV, D, dtype, kwargs):
    rng = np.random.default_rng(8)
    q, k, v = _on(sm90, rand(rng, B, S, H, D), rand(rng, B, S, KV, D),
                  rand(rng, B, S, KV, D), dtype=dtype)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = tref.flash_attention(q, k, v, **kwargs)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


def test_flash_shapes_reach_every_tile():
    """The card cases above run every key tile, one and two stages, and
    D padded to 32, 64, 128 and 256; the grouped cases below group."""
    plans = [flash_plan(B, S, S, H, KV, D, torch.float32)
             for B, S, H, KV, D in FLASH_SHAPES]
    assert {p.bk for p in plans} == {16, 32, 64}
    assert {p.stages for p in plans} == {1, 2}
    assert {p.dp for p in plans} == {32, 64, 128, 256}
    for B, S, T, H, KV, D in FLASH_GROUPED:
        assert flash_plan(B, S, T, H, KV, D, torch.float32).heads == H // KV


# Shapes whose grid is large enough for the plan to group the query heads
# of a KV head (the replay's tinyllama prefill; gemma2-2b's heads at 600
# tokens); an odd T past S (a prefill continuing at q_offset); G = 5.
FLASH_GROUPED = [(4, 1024, 1024, 32, 4, 64), (2, 600, 600, 8, 4, 256),
                 (4, 77, 77, 32, 4, 64), (2, 200, 333, 25, 5, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,D", FLASH_GROUPED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", [{}, dict(window=64, softcap=50.0),
                                    dict(window=16, prefix=8)])
def test_flash_attention_kernel_grouped(sm90, B, S, T, H, KV, D, dtype,
                                        kwargs):
    """Grouped heads, T != S (q_offset = T - S), odd T, D = 256."""
    rng = np.random.default_rng(14)
    q, k, v = _on(sm90, rand(rng, B, S, H, D), rand(rng, B, T, KV, D),
                  rand(rng, B, T, KV, D), dtype=dtype)
    kwargs = dict(kwargs, q_offset=T - S)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = tref.flash_attention(q, k, v, **kwargs)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,D,kwargs", [
    (2, 12, 40, 4, 2, 64, dict(window=4, q_offset=100)),
    (1, 64, 64, 4, 4, 32, dict(window=2, prefix=0)),
    (2, 300, 300, 8, 4, 256, dict(window=24, prefix=40))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_masked_rows_and_tiles(sm90, B, S, T, H, KV,
                                                      D, kwargs, dtype):
    """Rows that see no key at all (the mean of v over T), tiles in which
    a row sees nothing, and the prefix before a window's range."""
    rng = np.random.default_rng(15)
    q, k, v = _on(sm90, rand(rng, B, S, H, D), rand(rng, B, T, KV, D),
                  rand(rng, B, T, KV, D), dtype=dtype)
    got = ops.flash_attention(q, k, v, **kwargs)
    want = tref.flash_attention(q, k, v, **kwargs)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,kwargs", [
    (4, 12, 32, 4, 64, {}), (4, 12, 8, 4, 256, GEMMA2_MODE),
    (4, 1024, 32, 4, 64, {}), (2, 600, 8, 4, 256, GEMMA2_MODE)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_run_to_run_bit_equal(sm90, B, S, H, KV, D,
                                                     kwargs, dtype):
    rng = np.random.default_rng(16)
    q, k, v = _on(sm90, rand(rng, B, S, H, D), rand(rng, B, S, KV, D),
                  rand(rng, B, S, KV, D), dtype=dtype)
    one = ops.flash_attention(q, k, v, **kwargs)
    two = ops.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype,kv_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("kwargs", [{}, dict(window=64), dict(softcap=30.0),
                                    dict(window=32, prefix=8), GEMMA2_MODE])
def test_decode_attention_kernel(sm90, B, T, H, KV, D, dtype, kv_dtype,
                                 kwargs):
    rng = np.random.default_rng(9)
    (q,) = _on(sm90, rand(rng, B, H, D), dtype=dtype)
    k, v = _on(sm90, rand(rng, B, T, KV, D), rand(rng, B, T, KV, D),
               dtype=kv_dtype)
    lens = torch.from_numpy(rng.integers(1, T, B).astype(np.int32)).to(sm90)
    got = ops.decode_attention(q, k, v, lens, **kwargs)
    want = tref.decode_attention(q, k, v, lens, **kwargs)
    tol = TOL["bfloat16" if "bfloat16" in (dtype, kv_dtype) else "float32"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,group,bits", QMM_SHAPES + [
    (4, 2048, 2048, 32, 8), (48, 5632, 2048, 32, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_kernel(sm90, M, K, N, group, bits, dtype):
    rng = np.random.default_rng(10)
    (x,) = _on(sm90, rand(rng, M, K), dtype=dtype)
    (w,) = _on(sm90, rand(rng, K, N))
    wq, sc = ops.quantize_weights(w, bits=bits, group=group)
    got = ops.quant_matmul(x, wq, sc)
    want = tref.quant_matmul(x, wq, sc)
    tol = QMM_TOL if dtype == "float32" else TOL["bfloat16"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


def _qmm_case(dev, M, K, N, dtype, group=32, bits=8, seed=11):
    rng = np.random.default_rng(seed)
    (x,) = _on(dev, rand(rng, M, K), dtype=dtype)
    (w,) = _on(dev, rand(rng, K, N, scale=K ** -0.5))
    wq, sc = ops.quantize_weights(w, bits=bits, group=group)
    return x, wq, sc


def _qmm_check(x, wq, sc, dtype):
    """One call against the plain version; one launch counted."""
    before = ops.quant_matmul.launches
    got = ops.quant_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert ops.quant_matmul.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (x.shape[0], wq.shape[1])
    want = tref.quant_matmul(x, wq, sc)
    tol = QMM_TOL if dtype == "float32" else TOL["bfloat16"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", QMM_MAIN_SHAPES)
@pytest.mark.parametrize("M", [4, 48])  # decode at max_batch; prefill
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_main_shapes(sm90, M, K, N, dtype):
    """Every distinct per-layer (K, N) of the served tenants, int8 at
    group 32 as the 8-bit variant holds them."""
    _qmm_check(*_qmm_case(sm90, M, K, N, dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (4096, 2048, 5632),  # the replay's tinyllama prefill (wg, wu)
    (4, 1600, 3257), (48, 1600, 3257),  # hymba-1.5b's ssm_in: N % 4 != 0
    (3, 96, 40), (70, 200, 72)])  # odd widths, a second M chunk
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_replay_and_odd_widths(sm90, M, K, N, dtype):
    group = 32 if K % 32 == 0 else (8 if K % 8 == 0 else K)
    _qmm_check(*_qmm_case(sm90, M, K, N, dtype, group=group), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,S", [(4096, 1024, 1024, 1),
                                     (4, 1024, 17920, 2),
                                     (4, 2304, 9216, 4), (4, 2048, 2048, 8)])
def test_quant_matmul_cluster_sizes(sm90, M, K, N, S):
    """Shapes whose plan is a cluster of each size, on an H100's 132 SMs."""
    assert qmm_plan(M, K, N, 32, 132).cluster == S
    sms = torch.cuda.get_device_properties(sm90).multi_processor_count
    if sms != 132:
        pytest.skip(f"the shapes are picked for 132 SMs; this card has {sms}")
    _qmm_check(*_qmm_case(sm90, M, K, N, "float32"), "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 5632, 2048), (48, 2048, 5632),
                                   (4, 1600, 3257)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_bit_identical(sm90, M, K, N, dtype):
    """The split-K sum is taken in a fixed order: two calls agree bit for
    bit."""
    x, wq, sc = _qmm_case(sm90, M, K, N, dtype)
    assert torch.equal(ops.quant_matmul(x, wq, sc),
                       ops.quant_matmul(x, wq, sc))


def _ssd_inputs(dev, B, S, H, P, G, N, dtype):
    rng = np.random.default_rng(12)
    x = rand(rng, B, S, H, P, scale=0.5)
    dt = np.logaddexp(rand(rng, B, S, H), 0).astype(np.float32)
    A = -np.exp(rand(rng, H, scale=0.5))
    Bm, Cm = rand(rng, B, S, G, N, scale=0.3), rand(rng, B, S, G, N,
                                                    scale=0.3)
    D = rand(rng, H)
    init = rand(rng, B, H, P, N, scale=0.5)
    xs, dts, Bs, Cs = _on(dev, x, dt, Bm, Cm, dtype=dtype)
    As, Ds, inits = _on(dev, A, D, init)
    return xs, dts, As, Bs, Cs, Ds, inits


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,G,N", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_kernel(sm90, B, S, H, P, G, N, dtype, with_init):
    """y and the final state against the sequential oracle (f32: 2e-4;
    bf16 inputs: y at the bf16 tolerance, the f32 state at 2e-4), and one
    launch counted per call."""
    x, dt, A, Bm, Cm, D, init = _ssd_inputs(sm90, B, S, H, P, G, N, dtype)
    init = init if with_init else None
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(x, dt, A, Bm, Cm, D, init_state=init,
                            return_state=True)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert y.dtype == x.dtype and state.dtype == torch.float32
    want_y, want_s = tref.ssd_scan(x, dt, A, Bm, Cm, D, init_state=init,
                                   return_state=True)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        y.float().cpu().numpy(), want_y.float().cpu().numpy(),
        **(tol if dtype == "float32" else TOL["bfloat16"]))
    np.testing.assert_allclose(state.cpu().numpy(), want_s.cpu().numpy(),
                               **tol)
    y_only = ops.ssd_scan(x, dt, A, Bm, Cm, D, init_state=init)
    assert ops.ssd_scan.launches == before + 2
    assert torch.equal(y_only, y)


def test_ssd_shapes_reach_every_chunk():
    """The card cases above run every kQ the kernel is built for, one and
    two stages, and clusters of 1, 2 and 4."""
    plans = [ssd_plan(*shape, torch.float32) for shape in SSD_SHAPES]
    assert {p.kq for p in plans} == {16, 32, 64}
    assert {p.stages for p in plans} == {1, 2}
    assert {p.cluster for p in plans} == {1, 2, 4}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,G,N", [(4, 12, 48, 64, 1, 128),
                                         (1, 300, 48, 64, 1, 128),
                                         (1, 150, 5, 64, 5, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_run_to_run_bit_equal(sm90, B, S, H, P, G, N,
                                              dtype):
    """Two calls on the same inputs give the same bits, y and state."""
    x, dt, A, Bm, Cm, D, init = _ssd_inputs(sm90, B, S, H, P, G, N, dtype)
    y1, s1 = ops.ssd_scan(x, dt, A, Bm, Cm, D, init_state=init,
                          return_state=True)
    y2, s2 = ops.ssd_scan(x, dt, A, Bm, Cm, D, init_state=init,
                          return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
def test_ssd_scan_kernel_reads_column_slices_in_place(sm90):
    """The model hands the scan column slices of one (B, S, C) tensor:
    the kernel reads them through their row stride and agrees with the
    same inputs made contiguous."""
    B, S, H, P, G, N = 2, 70, 4, 16, 1, 8
    rng = np.random.default_rng(13)
    (xbc,) = _on(sm90, rand(rng, B, S, H * P + 2 * G * N, scale=0.3))
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    assert not x.is_contiguous()
    dt, A, D = _on(sm90, np.logaddexp(rand(rng, B, S, H), 0),
                   -np.exp(rand(rng, H)), rand(rng, H))
    got = ops.ssd_scan(x, dt, A, Bm, Cm, D)
    want = ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(),
                        Cm.contiguous(), D)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ssd_scan_kernel_refuses_what_it_cannot_take(sm90):
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(sm90, 1, 8, 4, 16, 2, 8, "float32")
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, D)
    with pytest.raises(TypeError):
        ops.ssd_scan(x.half(), dt.half(), A, Bm.half(), Cm.half(), D)
    with pytest.raises(ValueError):  # H % G != 0
        ops.ssd_scan(x[:, :, :3], dt[:, :, :3], A[:3], Bm, Cm, D[:3])
    with pytest.raises(ValueError):  # P beyond the shared-memory state
        ops.ssd_scan(torch.zeros((1, 8, 4, 65), device=sm90), dt, A, Bm, Cm,
                     D)
    with pytest.raises(ValueError):  # mixed devices
        ops.ssd_scan(x, dt, A.cpu(), Bm, Cm, D)


PAGED_SHAPES = [(2, 300, 8, 4, 64, 128), (3, 96, 4, 2, 32, 16),
                (1, 64, 4, 4, 32, 64),
                (2, 37, 4, 2, 16, 5)]  # a page size that does not divide T
DTYPE_PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
               ("float32", "bfloat16"), ("bfloat16", "float32")]


def _paged_case(dev, B, T, H, KV, D, ps, dtype, kv_dtype, lens, seed=11):
    rng = np.random.default_rng(seed)
    (q,) = _on(dev, rand(rng, B, H, D), dtype=dtype)
    k, v = _on(dev, rand(rng, B, T, KV, D), rand(rng, B, T, KV, D),
               dtype=kv_dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, lens, ops.paginate_kv(k, v, lens, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,D,ps", PAGED_SHAPES)
@pytest.mark.parametrize("dtype,kv_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("kwargs", [{}, dict(window=64), dict(softcap=30.0),
                                    dict(window=32, prefix=8)])
def test_paged_decode_attention_kernel(sm90, B, T, H, KV, D, ps, dtype,
                                       kv_dtype, kwargs):
    """Against the plain version at the tolerance of the inputs' types,
    and equal to the dense kernel on the same logical cache (one body
    serves both layouts); one launch counted per call."""
    lens = np.random.default_rng(B * T).integers(1, T, B).tolist()
    q, k, v, lens, pages = _paged_case(sm90, B, T, H, KV, D, ps, dtype,
                                       kv_dtype, lens)
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, *pages, lens, **kwargs)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    want = tref.paged_decode_attention(q, *pages, lens, **kwargs)
    tol = TOL["bfloat16" if "bfloat16" in (dtype, kv_dtype) else "float32"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
    dense = ops.decode_attention(q, k, v, lens, **kwargs)
    assert torch.equal(got, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("ps", [16, 5])
def test_paged_decode_attention_kernel_empty_rows(sm90, dtype, kv_dtype, ps):
    """Rows with nothing visible (lengths == 0) get the mean of v over
    every gathered row, read through the table (page 0 repeated, the zero
    tail of a ragged last page included)."""
    q, k, v, lens, pages = _paged_case(sm90, 3, 37, 4, 2, 32, ps, dtype,
                                       kv_dtype, [0, 20, 0])
    got = ops.paged_decode_attention(q, *pages, lens)
    want = tref.paged_decode_attention(q, *pages, lens)
    tol = TOL["bfloat16" if "bfloat16" in (dtype, kv_dtype) else "float32"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,D,dtype,kwargs", [
    (4, 1027, 32, 4, 64, "float32", {}),  # tinyllama, 8-bit, 1024 + 3
    (2, 4203, 8, 4, 256, "bfloat16", GEMMA2_MODE)])  # gemma2, 16-bit
@pytest.mark.parametrize("ps", [16, 128])
def test_paged_decode_attention_kernel_replay_shapes(sm90, B, T, H, KV, D,
                                                     dtype, kwargs, ps):
    """One layer of the real-cache replay: a bf16 cache of the replay's
    length, rows ending at different points (gemma2's past its window)."""
    lens = [T - 1 - 7 * i for i in range(B)]
    q, k, v, lens, pages = _paged_case(sm90, B, T, H, KV, D, ps, dtype,
                                       "bfloat16", lens)
    got = ops.paged_decode_attention(q, *pages, lens, **kwargs)
    want = tref.paged_decode_attention(q, *pages, lens, **kwargs)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL["bfloat16"])
    assert torch.equal(got, ops.decode_attention(q, k, v, lens, **kwargs))


# One layer of each replay: tinyllama (4 rows of 1024 + 3, f32 query of
# the 8-bit variant) and gemma2 (2 rows of 4200 + 3, 16-bit), bf16 caches.
REPLAY_SHAPES = [(4, 1027, 32, 4, 64, "float32", {}),
                 (2, 4203, 8, 4, 256, "bfloat16", GEMMA2_MODE)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,D,dtype,kwargs", REPLAY_SHAPES)
def test_decode_attention_kernel_replay_shapes(sm90, B, T, H, KV, D, dtype,
                                               kwargs):
    """The dense kernel at the replay's shapes (tens of splits, then the
    combine) against the plain version; one launch counted per call."""
    lens = [T - 1 - 7 * i for i in range(B)]
    q, k, v, lens, _ = _paged_case(sm90, B, T, H, KV, D, 16, dtype,
                                   "bfloat16", lens)
    assert ops.split_plan(B, H, KV, D, k.dtype, T).splits > 1
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, k, v, lens, **kwargs)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    want = tref.decode_attention(q, k, v, lens, **kwargs)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,D,dtype,kwargs", REPLAY_SHAPES)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_kernel_run_to_run_bit_equal(sm90, B, T, H, KV, D,
                                                      dtype, kwargs, paged):
    """The combine reduces the splits in a fixed order, without atomics:
    two calls on the same inputs give the same bits."""
    lens = [T - 1 - 7 * i for i in range(B)]
    q, k, v, lens, pages = _paged_case(sm90, B, T, H, KV, D, 16, dtype,
                                       "bfloat16", lens)
    if paged:
        first = ops.paged_decode_attention(q, *pages, lens, **kwargs)
        second = ops.paged_decode_attention(q, *pages, lens, **kwargs)
    else:
        first = ops.decode_attention(q, k, v, lens, **kwargs)
        second = ops.decode_attention(q, k, v, lens, **kwargs)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("ps", [5, 16])
@pytest.mark.parametrize("case", ["splits_past_length", "window_mid_split",
                                  "prefix_then_window"])
def test_decode_attention_kernel_split_edges(sm90, dtype, kv_dtype, ps,
                                             case):
    """Masks that cut the splits: lengths that leave whole splits empty,
    a window that starts inside a split, and a prefix plus a window with
    empty splits between them.  Against the plain version, and the paged
    kernel equal to the dense one bit for bit (page sizes that do not
    line up with the splits)."""
    B, T, H, KV, D = 3, 700, 8, 2, 64
    plan = ops.split_plan(B, H, KV, D, TDT[kv_dtype], T)
    L = plan.split
    assert plan.splits >= 5
    kwargs, lens = {}, [L + 3, 2 * L, T - 1]
    if case == "window_mid_split":
        kwargs = dict(window=2 * L + L // 2 + 1)
        lens = [T - 1, T - 50, 3 * L + 7]
    elif case == "prefix_then_window":
        kwargs = dict(window=L + 5, prefix=8)
        lens = [T - 1, T - 50, 3 * L + 7]
    q, k, v, lens, pages = _paged_case(sm90, B, T, H, KV, D, ps, dtype,
                                       kv_dtype, lens)
    got = ops.decode_attention(q, k, v, lens, **kwargs)
    want = tref.decode_attention(q, k, v, lens, **kwargs)
    tol = TOL["bfloat16" if "bfloat16" in (dtype, kv_dtype) else "float32"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
    assert torch.equal(ops.paged_decode_attention(q, *pages, lens, **kwargs),
                       got)


@pytest.mark.cuda
def test_paged_decode_attention_refuses_what_it_cannot_take(sm90):
    q, k, v, lens, (kp, vp, tab) = _paged_case(
        sm90, 2, 40, 4, 2, 32, 8, "float32", "float32", [10, 30])
    with pytest.raises(TypeError):  # an int64 table
        ops.paged_decode_attention(q, kp, vp, tab.long(), lens)
    with pytest.raises(ValueError):  # mixed devices
        ops.paged_decode_attention(q, kp, vp, tab.cpu(), lens)
    with pytest.raises(ValueError):  # a non-contiguous pool
        ops.paged_decode_attention(q, kp.transpose(1, 2), vp.transpose(1, 2),
                                   tab, lens)
    with pytest.raises(TypeError):  # k and v pools of different types
        ops.paged_decode_attention(q, kp, vp.bfloat16(), tab, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "gemma2-2b"])
def test_int8_cache_decode_step_on_card(sm90, name):
    """prefill(quantize_cache=True) and 4 greedy decode steps of the
    reduced 8-bit variant on the card against the same on the CPU: logits
    at quant_matmul's tolerance, equal ids, and the int8 cache equal
    within one quantization step."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.quant.quantize import quantize_params, tree_map

    cfg = get_config(name, reduced=True)
    host = quantize_params(T.init_params(cfg, 0, torch.float32,
                                         device="cpu"), bits=8, group=32)
    card = tree_map(lambda _, t: t.to(sm90), host)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    outs = []
    for params, dev in ((card, sm90), (host, torch.device("cpu"))):
        with torch.inference_mode():
            logits, cache = T.prefill(cfg, params, {"tokens": prompts.to(dev)},
                                      max_len=16, quantize_cache=True)
            steps = [logits]
            for _ in range(4):
                logits, cache = T.decode_step(cfg, params, cache,
                                              T.greedy_token(cfg, logits))
                steps.append(logits)
        outs.append(([t.cpu() for t in steps],
                     {n: t.cpu() for n, t in cache.items()}))
    (got, gc), (want, wc) = outs
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **QMM_TOL)
        assert torch.equal(T.greedy_token(cfg, g), T.greedy_token(cfg, w))
    assert gc["k"].dtype == torch.int8
    for n in ("k", "v"):
        deq = lambda c: c[n].float() * c[n + "_scale"][..., None]  # noqa: E731
        assert ((deq(gc) - deq(wc)).abs()
                <= wc[n + "_scale"][..., None] * 1.001 + 1e-12).all()
