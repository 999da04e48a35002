"""The port's counterpart of ``tests/test_serving.py``: end-to-end
multi-tenant serving, real models under a memory budget, on the CPU;
the batcher; the RNN arrival predictor."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.predictor import RequestPredictor
from repro_torch.models import transformer as T
from repro_torch.serving import Batcher, EdgeServer, Request, kv_cache_mb

TENANTS = ["tinyllama-1.1b", "mamba2-780m", "gemma2-2b"]


@pytest.fixture(scope="module")
def server():
    srv = EdgeServer(budget_mb=1e9, policy="iws-bfe", delta_ms=1000.0,
                     device="cpu")
    for name in TENANTS:
        cfg = get_config(name, reduced=True)
        params = T.init_params(cfg, hash(name) % 2 ** 31, torch.float32,
                               device="cpu")
        srv.register(name, cfg, params)
    # Feasible contention, with headroom for the largest decode cache
    # these tests admit (batch 2, total length 10).
    kv = max(kv_cache_mb(get_config(n, reduced=True), 2, 10)
             for n in TENANTS)
    srv.budget_mb = srv.contention_budget(kv)
    srv.start()
    return srv


def test_zoo_sizes_real(server):
    for name in TENANTS:
        zoo = server.tenants[name].zoo
        assert zoo.largest.bits == 16
        assert zoo.smallest.size_mb < zoo.largest.size_mb * 0.85


def test_budget_contention(server):
    total16 = sum(t.zoo.largest.size_mb for t in server.tenants.values())
    assert total16 > server.budget_mb, "budget must force contention"


def test_serve_empty_prompts_no_crash(server):
    r = server.serve(TENANTS[0], np.zeros((0, 4), np.int32), max_new=2,
                     now_ms=0.0)
    assert not r.failed
    assert r.tokens.shape == (0, 2)


def test_serve_generates_tokens(server):
    cfg = get_config(TENANTS[0], reduced=True)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    r = server.serve(TENANTS[0], prompts, max_new=4, now_ms=0.0)
    assert not r.failed
    assert r.tokens.shape == (2, 4)
    assert np.all(r.tokens < cfg.vocab_size)


def test_rotation_under_contention(server):
    """All tenants get served despite the budget fitting ~1 bf16 model."""
    rng = np.random.default_rng(1)
    now = 10_000.0
    for i in range(9):
        name = TENANTS[i % 3]
        cfg = get_config(name, reduced=True)
        prompts = rng.integers(0, cfg.vocab_size, size=(1, 5)).astype(np.int32)
        r = server.serve(name, prompts, max_new=2, now_ms=now)
        assert not r.failed, (name, server.manager.state.used_mb)
        now += 5000.0  # beyond the LRU history window
    stats = server.stats()
    assert stats.resident_mb <= server.budget_mb
    assert stats.fail_ratio == 0.0


def test_manager_accounting_matches_devices(server):
    """Manager's notion of residency agrees with actual device params."""
    st = server.manager.state
    for name, t in server.tenants.items():
        if st.tenants[name].loaded is None:
            assert t.device_params is None
        else:
            assert t.device_params is not None
            assert t.loaded_bits == st.tenants[name].loaded.bits


def test_batcher_right_aligned_padding():
    b = Batcher(max_batch=4, pad_id=0)
    lens = [2, 5, 3]
    for i, n in enumerate(lens):
        b.submit(Request(app="x",
                         prompt=(10 * (i + 1)
                                 + np.arange(n)).astype(np.int32)))
    batch = b.next_batch()
    assert batch.prompts.shape == (3, 5)
    for i, n in enumerate(lens):
        row = batch.prompts[i]
        assert np.all(row[: 5 - n] == 0), "left side must be padding"
        expect = (10 * (i + 1) + np.arange(n)).astype(np.int32)
        assert np.array_equal(row[5 - n:], expect), "prompt right-aligned"


def test_batcher_fifo_within_tenant():
    b = Batcher(max_batch=8)
    reqs = [Request(app="x", prompt=np.arange(3, dtype=np.int32))
            for _ in range(5)]
    for r in reqs:
        b.submit(r)
    batch = b.next_batch()
    assert [r.rid for r in batch.requests] == [r.rid for r in reqs]


def test_batcher_max_batch_splitting():
    b = Batcher(max_batch=3)
    for _ in range(7):
        b.submit(Request(app="x", prompt=np.arange(4, dtype=np.int32)))
    sizes = []
    while (batch := b.next_batch()) is not None:
        sizes.append(len(batch.requests))
    assert sizes == [3, 3, 1]


def test_batcher_largest_queue_first():
    b = Batcher(max_batch=8)
    for app, n in (("small", 2), ("big", 5), ("mid", 3)):
        for _ in range(n):
            b.submit(Request(app=app, prompt=np.arange(3, dtype=np.int32)))
    assert b.next_batch().app == "big"
    assert b.next_batch().app == "mid"
    assert b.next_batch().app == "small"
    assert b.next_batch() is None
    assert b.pending() == 0


def test_batcher_tie_break_oldest_head():
    b = Batcher(max_batch=8)
    b.submit(Request(app="late", prompt=np.arange(3, dtype=np.int32),
                     arrival_ms=200.0))
    b.submit(Request(app="early", prompt=np.arange(3, dtype=np.int32),
                     arrival_ms=100.0))
    # equal queue depth: the tenant whose head waited longest goes first
    assert b.next_batch().app == "early"
    assert b.next_batch().app == "late"


def test_batcher_groups_and_pads():
    b = Batcher(max_batch=3)
    for i in range(5):
        b.submit(Request(app="x", prompt=np.arange(3 + i, dtype=np.int32)))
    batch = b.next_batch()
    assert batch.app == "x"
    assert len(batch.requests) == 3
    assert batch.prompts.shape == (3, 5)  # padded to longest
    # right-aligned: last token of each row is the prompt's last token
    assert batch.prompts[0, -1] == 2
    rest = b.next_batch()
    assert len(rest.requests) == 2
    assert b.next_batch() is None


def test_rnn_predictor_learns_pattern():
    rng = np.random.default_rng(0)
    p = RequestPredictor(context=8, hidden=16, seed=0)
    t = 0.0
    for i in range(160):
        gap = 100.0 if i % 2 == 0 else 300.0
        t += gap + rng.normal(0, 5.0)
        p.observe_request(t)
    loss = p.fit(steps=250)
    assert loss < 0.05
    pred_gap = p.predict()
    assert abs(pred_gap - 100.0) < 60.0  # next gap in the pattern
