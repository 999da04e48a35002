"""Training on the card (marked ``cuda``; skipped without an sm_90 device).

The backward kernel (``repro_torch/csrc/flash_attention_bwd.cu``) against
``torch.autograd.grad`` through the plain ``ref.flash_attention`` on the
same card tensors: the sweep of ``test_kernels.py``, tinyllama-1.1b's and
gemma2-2b's heads, every mask mode (causal, none, window, window with
prefix, softcap, ``q_offset``, rows that see no key at all), f32 and
bf16.  Tolerances: f32 ``rtol=atol=3e-5`` element-wise (the kernel and
autograd both sum in f32, in other orders); bf16 ``rtol=atol=3e-2``
element-wise and, since a gradient summed over many rows can sit near
zero, also 1e-2 relative l2.  Then: two calls bit-identical (no float
atomics); the bf16 path (tensor cores) at its tile edges: S and T ragged
against its tiles, D = 36 (not whole 16-byte rows), 40, 128 and 256, G =
1, 5 and 8, a window whose prefix ends mid-tile, ``q_offset``, rows that
see nothing; a call with a float32 q and bf16 k and v takes the f32
kernels, bit-equal to the same call with f32 k and v; the autograd
Function's gradients equal the kernel's; the three kernels without a
backward refuse a grad; and one supervised run of a
reduced model with an injected failure ends bit-equal to an unbroken
run.  The scan's backward kernel (``repro_torch/csrc/ssd_scan_bwd.cu``)
against ``ref.ssd_scan_bwd`` (autograd through the plain chunked form) at
the sweep of ``test_kernels.py``, with and without an initial state and a
final-state cotangent, from column slices of one tensor as the model
passes them, every gradient element-wise: f32 within 2e-4 (the scan's
tolerance), bf16 within 3e-2 and 1e-2 relative l2.  The oracle runs at
the kernel's own chunk (``ssd_bwd_plan``): at another chunk dA, a sum
over every token of the batch, differs past 2e-4 by the order of the
sums alone (``test_torch_ssd_bwd_plan.py::
test_token_sums_round_with_their_scale``).  Two calls bit-equal, and
autograd through ``ops.ssd_scan`` runs it.  Imports no JAX: it runs on
the machine with the card.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_lse,
                                                 flash_bwd_plan)
from repro_torch.kernels.ssd_scan import ssd_bwd_plan, ssd_scan_bwd

TOL = {torch.float32: dict(rtol=3e-5, atol=3e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
REL_L2 = 1e-2  # bf16: relative l2 of each gradient
# (B, S, T, H, KV, D): the sweep of test_kernels.py; a prefill continuing
# past its keys; tinyllama-1.1b's and gemma2-2b's heads.
SHAPES = [(1, 64, 64, 4, 4, 32), (2, 160, 160, 8, 4, 64),
          (1, 257, 257, 6, 2, 128), (2, 128, 128, 25, 5, 64),
          (1, 64, 128, 4, 2, 64), (2, 256, 256, 32, 4, 64),
          (1, 300, 300, 8, 4, 256)]
MODES = [{}, dict(causal=False), dict(window=32), dict(softcap=20.0),
         dict(window=16, prefix=8), dict(window=32, softcap=50.0, prefix=4),
         dict(q_offset=64)]
# Rows past T + window - 1 see nothing (the forward gives them the mean
# of v): zero dQ, dO / T to every key's dV.
EMPTY = [((1, 64, 40, 4, 2, 64), dict(window=8, q_offset=20)),
         ((2, 70, 30, 8, 4, 256), dict(window=16, q_offset=30,
                                       softcap=30.0)),
         ((1, 50, 20, 6, 3, 128), dict(causal=False, window=4,
                                       q_offset=30))]


@pytest.fixture
def sm90():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


def _inputs(dev, B, S, T, H, KV, D, dtype, seed=3):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev, dtype) for s in
            ((B, S, H, D), (B, T, KV, D), (B, T, KV, D), (B, S, H, D))]


def _hold(got, want, dtype, what):
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        a, b = a.float().cpu(), b.float().cpu()
        assert torch.isfinite(a).all(), (what, name)
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL[dtype],
                                   err_msg=f"{what} d{name}")
        if dtype == torch.bfloat16:
            rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
            assert rel <= REL_L2, (what, name, rel)


def _check(dev, shape, dtype, kw):
    B, S, T, H, KV, D = shape
    q, k, v, do = _inputs(dev, B, S, T, H, KV, D, dtype)
    out, lse = flash_attention_lse(q, k, v, **kw)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = tref.flash_attention_bwd(q, k, v, do, **kw)
    _hold(got, want, dtype, f"{shape} {dtype} {kw}")
    return q, k, v, do, out, lse, got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", MODES)
def test_flash_backward_kernel(sm90, shape, dtype, kw):
    _check(sm90, shape, dtype, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", EMPTY)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_rows_that_see_nothing(sm90, shape, dtype, kw):
    q, k, v, do, out, lse, (dq, _, _) = _check(sm90, shape, dtype, kw)
    empty = torch.isneginf(lse).permute(0, 2, 1)  # (B, S, H)
    assert empty.any()
    assert (dq[empty] == 0).all()


# The bf16 path's tile edges (64 own rows a block, streamed tiles of 32 to
# 64 rows worked 32 at a time): S and T off every tile; D = 40 (padded to
# 64), 128 and 256; D = 36, staged element by element (rows of whole 16
# bytes take cp.async); G = 1, 5 (a cluster of 5) and 8; a window whose
# prefix ends mid-tile; q_offset with T > S; rows that see nothing.
EDGES16 = [((1, 77, 77, 4, 4, 64), {}),
           ((1, 70, 70, 4, 2, 36), dict(softcap=20.0)),
           ((2, 100, 131, 8, 4, 40), dict(q_offset=31)),
           ((1, 150, 150, 10, 2, 128), dict(window=50, prefix=37)),
           ((1, 203, 203, 16, 2, 256), dict(window=70, prefix=21,
                                            softcap=30.0)),
           ((2, 95, 95, 8, 1, 64), dict(causal=False, window=33, prefix=9)),
           ((1, 130, 60, 5, 1, 128), dict(window=10, q_offset=40)),
           ((1, 90, 200, 8, 8, 40), dict(causal=False, q_offset=17))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", EDGES16)
def test_flash_backward_bf16_tile_edges(sm90, shape, kw):
    assert flash_bwd_plan(*shape, True).path == "bf16"
    _check(sm90, shape, torch.bfloat16, kw)


@pytest.mark.cuda
def test_flash_backward_mixed_types_take_the_f32_kernels(sm90):
    """f32 q and dO with bf16 k and v go to the CUDA-core kernels, which
    widen k and v exactly: the call equals the same call with f32 k and v
    bit for bit (dK and dV rounded to bf16 once, as the kernel rounds)."""
    kw = dict(window=40, softcap=20.0)
    shape = (2, 150, 150, 8, 4, 64)
    q, _, _, do = _inputs(sm90, *shape, torch.float32)
    _, k, v, _ = _inputs(sm90, *shape, torch.bfloat16)
    out, lse = flash_attention_lse(q, k, v, **kw)
    mixed = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    wide = flash_attention_bwd(q, k.float(), v.float(), out, do, lse, **kw)
    assert mixed[0].dtype == torch.float32 and torch.equal(mixed[0], wide[0])
    for a, b in zip(mixed[1:], wide[1:]):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic_and_autograd_uses_it(sm90, dtype):
    """Two calls bit-identical; gradients through ``ops.flash_attention``
    under autograd are the kernel's, one forward and one backward launch."""
    kw = dict(window=48, softcap=30.0)
    q, k, v, do = _inputs(sm90, 2, 200, 200, 8, 4, 128, dtype)
    out, lse = flash_attention_lse(q, k, v, **kw)
    a = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    b = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    f0 = ops.flash_attention.launches
    b0 = flash_attention_bwd.launches
    o = ops.flash_attention(*leaves, **kw)
    assert o.grad_fn is not None and torch.equal(o, out)
    grads = torch.autograd.grad(o, leaves, do)
    assert ops.flash_attention.launches == f0 + 1
    assert flash_attention_bwd.launches == b0 + 1
    for x, y in zip(grads, a):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_grad(sm90):
    """A CUDA input that requires grad, under grad mode, raises: a
    silent detach would lose every gradient below the call.  Under
    ``torch.no_grad()`` the same calls run."""
    x = torch.randn(4, 64, device=sm90, requires_grad=True)
    wq, ws = ops.quantize_weights(torch.randn(64, 32, device=sm90), bits=8)
    q = torch.randn(2, 8, 64, device=sm90, requires_grad=True)
    kc = torch.randn(2, 32, 4, 64, device=sm90)
    lens = torch.full((2,), 20, dtype=torch.int32, device=sm90)
    kp, vp, table = ops.paginate_kv(kc, kc, lens, 16)
    calls = {
        "quant_matmul": lambda: ops.quant_matmul(x, wq, ws),
        "decode_attention": lambda: ops.decode_attention(q, kc, kc, lens),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q, kp, vp, table, lens),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: no backward"):
            call()
        with torch.no_grad():
            call()


@pytest.mark.cuda
def test_supervised_recovery_is_bit_equal_on_the_card(sm90, tmp_path):
    """Reduced tinyllama trained 5 steps on the card by ``run_supervised``
    (bf16 compute, remat, the attention kernels' forward and backward),
    with a node failure at step 3 and checkpoints every 2 steps: the
    final state equals an unbroken run's bit for bit.  Runs in a child
    process so that deterministic algorithms and cuBLAS's fixed
    workspace hold from the start."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    child = f"""
import json, torch
torch.use_deterministic_algorithms(True)
from repro_torch.configs import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     run_supervised)
from repro_torch.kernels import ops
from repro_torch.training import pytree
from repro_torch.training.data import DataConfig, SyntheticStream
from repro_torch.training.optim import AdamW, warmup_cosine
from repro_torch.training.train_step import init_state, make_train_step
cfg = get_config("tinyllama-1.1b", reduced=True)
opt = AdamW(lr=warmup_cosine(3e-3, 2, 5))
state = init_state(cfg, 0, opt, device="cuda")
step = make_train_step(cfg, opt)
ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                global_batch=4))
def batch(s):
    return {{k: torch.from_numpy(v).cuda() for k, v in ds.batch_at(s).items()}}
out = {{}}
for name, inj in (("a", None), ("b", FailureInjector(fail_at_steps=(3,)))):
    rep = run_supervised(init_state=state, step_fn=step, batch_fn=batch,
                         total_steps=5, ckpt_dir={str(tmp_path)!r} + "/" + name,
                         ckpt_every=2, injector=inj)
    out[name] = (rep.restarts,
                 pytree.leaves(ckpt.restore(state, {str(tmp_path)!r} + "/" + name)))
equal = all(torch.equal(x, y) for x, y in zip(out["a"][1], out["b"][1]))
print(json.dumps({{"restarts": out["b"][0], "equal": equal,
                  "bwd": ops.flash_attention_bwd.launches}}))
"""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", child], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["restarts"] == 1 and res["equal"] and res["bwd"] > 0, res


SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
           torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
# (B, S, H, P, G, N): the sweep of test_kernels.py (ragged tails, G > 1,
# mamba2-780m's heads) and hymba-1.5b's branch.
SSD_SHAPES = [(1, 64, 2, 16, 1, 8), (2, 96, 4, 32, 2, 16),
              (1, 50, 2, 16, 1, 8), (2, 128, 48, 64, 1, 128),
              (1, 200, 25, 64, 5, 16)]
SSD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")


def _ssd_inputs(dev, B, S, H, P, G, N, dtype, seed=5):
    """x, B and C as column slices of one (B, S, .) tensor (the model's
    xbc), dt, A, D, an initial state, dy and a final-state cotangent."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    xbc = torch.cat([r(B, S, H * P, scale=0.5), r(B, S, 2 * G * N,
                                                  scale=0.3)], -1)
    xbc = xbc.to(dev, dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(r(B, S, H)).to(dev, dtype)
    A = -torch.exp(r(H, scale=0.5)).to(dev)
    D = r(H).to(dev)
    init = r(B, H, P, N, scale=0.5).to(dev)
    dy = r(B, S, H, P).to(dev, dtype)
    dstate = r(B, H, P, N, scale=0.5).to(dev)
    return (x, dt, A, Bm, Cm, D), init, dy, dstate


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_ssd_backward_kernel(sm90, shape, dtype, with_init, with_dstate):
    args, init, dy, dstate = _ssd_inputs(sm90, *shape, dtype)
    kw = dict(init_state=init if with_init else None,
              dstate=dstate if with_dstate else None)
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd(*args, dy, **kw)
    assert ssd_scan_bwd.launches == before + 1
    want = tref.ssd_scan_bwd(*args, dy, chunk=ssd_bwd_plan(*shape).kq, **kw)
    for name, a, b, t in zip(SSD_NAMES, got, want, args + (init,)):
        if not with_init and name == "dinit":
            assert a is None and b is None
            continue
        assert a.shape == t.shape and a.dtype == b.dtype, name
        assert a.is_contiguous(), name
        err = float((a.float() - b.float()).abs().max())
        torch.testing.assert_close(a.float(), b.float(),
                                   msg=f"{name}: max abs err {err:.3g}",
                                   **SSD_TOL[a.dtype])
        if a.dtype == torch.bfloat16:
            rel = float((a.float() - b.float()).norm() / b.float().norm())
            assert rel <= REL_L2, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_is_deterministic_and_autograd_uses_it(sm90, dtype):
    """Two calls bit-identical; gradients through ``ops.ssd_scan`` under
    autograd (with the final state used) are the kernel's, one forward
    and one backward launch."""
    args, init, dy, dstate = _ssd_inputs(sm90, 2, 100, 8, 64, 2, 128, dtype)
    a = ssd_scan_bwd(*args, dy, init_state=init, dstate=dstate)
    b = ssd_scan_bwd(*args, dy, init_state=init, dstate=dstate)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    leaves = [t.detach().clone().requires_grad_() for t in args]
    linit = init.clone().requires_grad_()
    f0, b0 = ops.ssd_scan.launches, ssd_scan_bwd.launches
    y, h = ops.ssd_scan(*leaves, init_state=linit, return_state=True)
    assert y.grad_fn is not None
    grads = torch.autograd.grad((y, h), leaves + [linit], (dy, dstate))
    assert ops.ssd_scan.launches == f0 + 1
    assert ssd_scan_bwd.launches == b0 + 1
    for x, y in zip(grads, a):
        assert torch.equal(x, y)
