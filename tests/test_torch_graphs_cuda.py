"""``TenantRuntime.generate`` on the card as one CUDA graph per batch shape,
against the eager loop (marked ``cuda``; skipped without an sm_90 device).

Reduced tinyllama, gemma2, mamba2, hymba and olmoe at 16 and 8 bits: a
key's first call runs eagerly and captures nothing, its second captures,
its third replays, the graph's greedy ids equal to the eager
``_generate_tokens`` on the card; a captured ``decode_step`` gives the
eager step's logits bit for bit; past ``MAX_GRAPHS`` the least recently
replayed graph goes; a variant swap drops the old variant's graphs (no
stale ids after 16 → 8 → 16) and eviction gives back their memory; a
capture while another thread stages a variant succeeds; a launch that
fails during a capture makes ``generate`` raise; batches with extra
inputs stay eager; the MoE FFN's ``ragged`` form refuses a capture.
Served through the engine, a capture raises ``used_mb`` by the measured
pool and an eviction returns it.  Imports no JAX: it runs on the
machine with the card.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs_cuda.py
"""
import functools
import gc
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import quant_matmul as qmm_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models import transformer as T
from repro_torch.serving import server as server_mod
from repro_torch.serving.server import (MB, TenantRuntime, _generate_tokens,
                                        capture, pool_bytes)

ARCHS = ("tinyllama-1.1b", "gemma2-2b", "mamba2-780m", "hymba-1.5b",
         "olmoe-1b-7b")
BITS = (16, 8)


@pytest.fixture
def sm90():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


def runtime(arch: str, seed: int = 0) -> TenantRuntime:
    cfg = get_config(arch, reduced=True)
    params = T.init_params(cfg, seed, torch.float32, device="cuda")
    return TenantRuntime(arch, cfg, params, precisions=BITS, device="cuda")


@functools.lru_cache(maxsize=None)
def shared(arch: str) -> TenantRuntime:
    """One runtime per architecture for the tests that only read it."""
    return runtime(arch)


def prompts_for(cfg, B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def eager(rt: TenantRuntime, prompts: np.ndarray, max_new: int,
          extra=None) -> np.ndarray:
    S = prompts.shape[1]
    with torch.inference_mode():
        return _generate_tokens(
            rt.cfg, rt.device_params, torch.from_numpy(prompts).cuda(),
            max_new=max_new, max_len=S + max_new, extra=extra).cpu().numpy()


def load(rt: TenantRuntime, bits: int) -> None:
    rt.set_variant(rt.zoo.by_bits(bits))


def captured(rt: TenantRuntime, prompts: np.ndarray, max_new: int):
    """A key's first call (eager) and its second (the capture); the
    second's ids."""
    rt.generate(prompts, max_new)
    return rt.generate(prompts, max_new)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", BITS)
def test_graph_ids_equal_eager_and_replay_captures_nothing(sm90, arch, bits):
    rt = shared(arch)
    load(rt, bits)
    for i, (B, S, max_new) in enumerate(((3, 7, 5), (1, 12, 8), (4, 4, 1))):
        prompts = prompts_for(rt.cfg, B, S, seed=i)
        before, replays = rt.captures, rt.replays
        want = eager(rt, prompts, max_new)
        got = rt.generate(prompts, max_new)  # the key's first call: eager
        assert rt.captures == before and rt.replays == replays
        assert got.dtype == np.int32 and got.shape == (B, max_new)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(rt.generate(prompts, max_new), want)
        assert rt.captures == before + 1 and rt.replays == replays + 1
        # The same key again, with other prompts: a replay, no capture.
        other = prompts_for(rt.cfg, B, S, seed=i + 10)
        np.testing.assert_array_equal(rt.generate(other, max_new),
                                      eager(rt, other, max_new))
        assert rt.captures == before + 1 and rt.replays == replays + 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", BITS)
def test_captured_decode_step_equals_eager(sm90, arch, bits):
    rt = shared(arch)
    load(rt, bits)
    cfg, params = rt.cfg, rt.device_params
    prompts = torch.from_numpy(prompts_for(cfg, 2, 9)).cuda()
    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, {"tokens": prompts},
                                  max_len=12)
        tok = T.greedy_token(cfg, logits)
        want, _ = T.decode_step(cfg, params,
                                {n: t.clone() for n, t in cache.items()}, tok)
        static = {n: t.clone() for n, t in cache.items()}
        graph, (got, new_cache) = capture(
            lambda: T.decode_step(cfg, params, static, tok), sm90,
            torch.cuda.graph_pool_handle())
        # The warm-up moved the SSM state on in place: start the replay
        # from the prefill's cache again.
        for n, t in static.items():
            t.copy_(cache[n])
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(new_cache["lengths"], cache["lengths"] + 1)


# The replay's long caches (tinyllama at 1028 rows, gemma2's global and
# local layers at 4204): the split kernel and the combine, a programmatic
# dependent launch, captured.
SPLIT_SHAPES = [(4, 1028, 32, 4, 64, "float32", {}),
                (2, 4204, 8, 4, 256, "bfloat16", dict(softcap=50.0)),
                (2, 4204, 8, 4, 256, "bfloat16",
                 dict(window=4096, softcap=50.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,D,dtype,kw", SPLIT_SHAPES)
def test_captured_split_decode_equals_eager(sm90, B, T, H, KV, D, dtype,
                                            kw):
    from repro_torch.kernels import ops

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(T)
    q = torch.randn((B, H, D), generator=g, device="cuda")
    k, v = (torch.randn((B, T, KV, D), generator=g, device="cuda").to(dt)
            for _ in range(2))
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    assert ops.split_plan(B, H, KV, D, dt, T).splits > 1
    want = ops.decode_attention(q, k, v, lens, **kw)
    graph, got = capture(lambda: ops.decode_attention(q, k, v, lens, **kw),
                         sm90, torch.cuda.graph_pool_handle())
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_variant_swaps_drop_stale_graphs(sm90, arch):
    rt = runtime(arch, seed=1)
    prompts = prompts_for(rt.cfg, 2, 6)
    seen = {}
    for bits in (16, 8, 16):
        load(rt, bits)
        assert rt.pool is None and not rt._graphs
        got = captured(rt, prompts, 6)
        np.testing.assert_array_equal(got, eager(rt, prompts, 6))
        seen.setdefault(bits, got)
        np.testing.assert_array_equal(got, seen[bits])
        np.testing.assert_array_equal(rt.generate(prompts, 6), got)
    assert rt.captures == 3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_least_recently_replayed_graph_is_dropped(sm90, arch, monkeypatch):
    monkeypatch.setattr(server_mod, "MAX_GRAPHS", 2)
    rt = runtime(arch, seed=6)
    load(rt, 8)
    keys = [prompts_for(rt.cfg, 2, S, seed=S) for S in (5, 6, 7)]
    captured(rt, keys[0], 3)
    captured(rt, keys[1], 3)
    rt.generate(keys[0], 3)  # a replay: now keys[1] is the oldest
    captured(rt, keys[2], 3)
    assert rt.captures == 3 and len(rt._graphs) == 2
    assert [k[2] for k in rt._graphs] == [5, 7]
    # The dropped key captures anew, into the same pool, and is right.
    pool = rt.pool
    np.testing.assert_array_equal(rt.generate(keys[1], 3),
                                  eager(rt, keys[1], 3))
    assert rt.captures == 4 and rt.pool == pool
    assert [k[2] for k in rt._graphs] == [7, 6]
    for prompts in keys:
        np.testing.assert_array_equal(rt.generate(prompts, 3),
                                      eager(rt, prompts, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_eviction_gives_back_the_graphs_memory(sm90, arch):
    rt = runtime(arch, seed=2)
    prompts = prompts_for(rt.cfg, 3, 8)
    # A first load, capture and eviction: the capture stream's one-time
    # set-up (cuBLAS's workspace) is allocated there, outside any pool.
    load(rt, 16)
    captured(rt, prompts, 4)
    rt.set_variant(None)
    gc.collect()
    torch.cuda.synchronize()
    level = torch.cuda.memory_allocated()
    for bits in (8, 16):
        load(rt, bits)
        assert torch.cuda.memory_allocated() > level  # the params
        captured(rt, prompts, 4)
        captured(rt, prompts[:1, :5], 3)
        pool = rt.pool
        assert rt.captures and pool_bytes(pool) > 0
        rt.set_variant(None)
        assert rt.pool is None and not rt._graphs
        assert pool_bytes(pool) == 0
        assert torch.cuda.memory_allocated() == level


@pytest.mark.cuda
def test_capture_while_another_thread_stages_a_variant(sm90):
    rt, other = runtime("tinyllama-1.1b", seed=3), runtime("gemma2-2b",
                                                           seed=3)
    load(rt, 8)
    stop = threading.Event()
    staged = []
    errors = []

    def stage():
        try:
            while not stop.is_set():
                for bits in (16, 8):
                    load(other, bits)
                    staged.append(bits)
        except BaseException as e:  # reported by the test below
            errors.append(e)

    worker = threading.Thread(target=stage)
    worker.start()
    try:
        results = []
        for S in range(4, 12):
            prompts = prompts_for(rt.cfg, 2, S, seed=S)
            results.append((prompts, captured(rt, prompts, 5)))
    finally:
        stop.set()
        worker.join(timeout=120)
    assert not worker.is_alive() and not errors, errors
    assert rt.captures == 8 and len(staged) > 8
    for prompts, got in results:
        np.testing.assert_array_equal(got, eager(rt, prompts, 5))


def _failing(real):
    """A launcher that refuses every launch made during a capture."""
    def launch(*args):
        if torch.cuda.is_current_stream_capturing():
            return 1  # cudaErrorInvalidValue
        return real(*args)
    return launch


# Each kernel of the path, and a tenant and variant whose generate runs it.
FAILING = {"quant_matmul": (qmm_mod, "tinyllama-1.1b", 8),
           "flash_attention": (fa_mod, "gemma2-2b", 16),
           "ssd_scan": (ssd_mod, "mamba2-780m", 16),
           "decode_attention": (da_mod, "tinyllama-1.1b", 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(FAILING))
def test_failed_capture_raises(sm90, kernel, monkeypatch):
    mod, arch, bits = FAILING[kernel]
    rt = runtime(arch, seed=4)
    load(rt, bits)
    prompts = prompts_for(rt.cfg, 2, 7)
    if mod is da_mod:  # its launchers are looked up at each call
        monkeypatch.setattr(mod, "launcher", lambda *a: _failing(
            build.launcher(*a)))
    else:
        real = mod._launcher()
        monkeypatch.setattr(mod, "_launcher", lambda: _failing(real))
    want = rt.generate(prompts, 4)  # the first call: eager, launches fine
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        rt.generate(prompts, 4)
    assert rt.captures == 0 and not rt._graphs and rt.pool_mb == 0.0
    monkeypatch.undo()
    np.testing.assert_array_equal(want, eager(rt, prompts, 4))
    np.testing.assert_array_equal(rt.generate(prompts, 4),
                                  eager(rt, prompts, 4))
    assert rt.captures == 1


@pytest.mark.cuda
def test_batches_with_extras_stay_eager(sm90):
    rt = runtime("internvl2-1b", seed=5)
    load(rt, 8)
    cfg = rt.cfg
    prompts = prompts_for(cfg, 2, 6)
    vis = np.random.default_rng(5).standard_normal(
        (2, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    got = rt.generate(prompts, 4, extra={"patch_embeds": vis})
    assert rt.captures == 0 and rt.replays == 0 and rt.pool is None
    np.testing.assert_array_equal(got, eager(
        rt, prompts, 4, extra={"patch_embeds": torch.from_numpy(vis).cuda()}))


@pytest.mark.cuda
def test_ragged_moe_refuses_a_capture(sm90):
    from repro_torch.models import layers as L

    rt = shared("olmoe-1b-7b")
    load(rt, 16)
    cfg = rt.cfg
    lp = T._layer(rt.device_params["layers"], 0)
    x = torch.randn((2, 5, cfg.d_model), device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        L.moe_ffn(cfg, lp, x, impl="ragged")  # eager: runs
        with pytest.raises(RuntimeError, match="ragged"):
            capture(lambda: L.moe_ffn(cfg, lp, x, impl="ragged"), sm90,
                    torch.cuda.graph_pool_handle())


@pytest.mark.cuda
def test_engine_charges_the_pool_from_capture_to_eviction(sm90):
    """Reduced tinyllama and olmoe served through the engine on the card:
    a key's first batch charges no pool, its second charges the pool the
    allocator holds for the tenant's graphs, its third replays; every
    event within budget; an eviction through the loader returns the
    charge and the pool's memory."""
    from repro_torch.core import actions as RA
    from repro_torch.serving import EdgeServer
    from repro_torch.serving.api import ServingConfig, TenantSpec

    srv = EdgeServer.build(ServingConfig(
        tenants=(TenantSpec("tinyllama-1.1b"), TenantSpec("olmoe-1b-7b")),
        executor="real", budget_mb=4096.0), device="cuda")
    st = srv.manager.state
    for app in srv.tenants:
        prompts = prompts_for(srv.tenants[app].cfg, 3, 6)
        for i in range(3):
            r = srv.serve(app, prompts, max_new=4, now_ms=1000.0 * i)
            assert not r.failed
            rt = srv.tenants[app]
            assert rt.captures == (i > 0) and rt.replays == (i > 0) * i
            if i == 0:
                assert st.tenants[app].pool_mb == 0.0
        held = pool_bytes(rt.pool) / MB
        assert held > 0 and st.tenants[app].pool_mb == held == rt.pool_mb
        assert st.used_mb == pytest.approx(st.weights_mb + st.pool_mb)
    srv.engine.check_event_invariant()
    assert any(e.kind == "pool" and e.pool_mb > 0
               for e in srv.engine.events)
    pools = {app: rt.pool for app, rt in srv.tenants.items()}
    for app in srv.tenants:
        srv.loader.execute(RA.ResidencyPlan((RA.Unload(app),)), 5000.0)
    srv.close()
    assert st.pool_mb == 0.0 and st.used_mb == 0.0
    assert all(pool_bytes(p) == 0 for p in pools.values())
