"""The elastic mesh's drain on the card (marked ``cuda``; skipped without
an sm_90 device).

Reduced tinyllama and mamba2 served from a (4,) logical mesh on one card,
each at 16 bits with a captured ``generate`` graph and its pool charged;
chip 3 goes down, and the survivors can absorb one tenant's share but not
both, so the drain migrates one and downgrades the other.  The
downgraded tenant's graphs and pool charge go with its variant, its next
batch gives the eager loop's greedy ids at 8 bits, and ``chip_up``
restores its 16-bit variant through a staged load.  Imports no JAX: it
runs on the machine with the card.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_elastic_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.serving import EdgeServer
from repro_torch.serving.api import FaultSpec
from repro_torch.serving.server import _generate_tokens, pool_bytes

ARCHS = ("tinyllama-1.1b", "mamba2-780m")
N_DEV = 4
MB = 1024 * 1024


@pytest.fixture
def sm90():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


def eager(tr, prompts: np.ndarray, max_new: int) -> np.ndarray:
    S = prompts.shape[1]
    with torch.inference_mode():
        return _generate_tokens(
            tr.cfg, tr.device_params, torch.from_numpy(prompts).cuda(),
            max_new=max_new, max_len=S + max_new).cpu().numpy()


def elastic_server() -> EdgeServer:
    """Both tenants fit at 16 bits (with room for their pools) globally
    and per chip; the three survivors of a loss hold the larger 16-bit
    share, not both."""
    srv = EdgeServer(budget_mb=0.0, max_batch=4, sharded_mesh=(N_DEV,),
                     device="cuda")
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch, reduced=True)
        srv.register(arch, cfg, T.init_params(cfg, i, torch.float32,
                                              device="cuda"))
    mesh = SH.serving_mesh((N_DEV,))
    big = [tr.zoo.largest.size_mb * SH.weight_shard_fraction(tr.cfg, mesh)
           for tr in srv.tenants.values()]
    srv.budget_mb = 2 * sum(tr.zoo.largest.size_mb
                            for tr in srv.tenants.values()) + 512.0
    srv.device_budget_mb = sum(big) + 1.1 * max(big) / (N_DEV - 1)
    srv.sync_predictor_fits = True
    srv.fault = FaultSpec(events=((1000.0, 3, "down"), (5000.0, 3, "up")))
    srv.start()
    return srv


@pytest.mark.cuda
def test_drain_downgrade_drops_graphs_and_chip_up_restores(sm90):
    srv = elastic_server()
    st, ctl = srv.manager.state, srv.elastic
    vocab = min(tr.cfg.vocab_size for tr in srv.tenants.values())
    prompts = np.random.default_rng(0).integers(
        0, vocab, (2, 6)).astype(np.int32)
    for i in range(3):  # eager, capture, replay
        for j, arch in enumerate(ARCHS):
            r = srv.serve(arch, prompts, max_new=4, now_ms=10.0 * i + j)
            assert not r.failed and r.bits == 16
    for arch in ARCHS:
        tr = srv.tenants[arch]
        assert tr.captures == 1 and tr.replays == 2  # the capture replays
        assert st.tenants[arch].pool_mb == pool_bytes(tr.pool) / MB > 0
    srv.engine._now = 1000.0
    ctl.poll(1000.0)
    assert ctl.chips_lost == 1 and ctl.drain_unloads == 0
    assert ctl.drain_downgrades == 1 and ctl.drain_migrations >= 1
    low = [a for a in ARCHS if st.tenants[a].loaded.bits == 8]
    assert len(low) == 1
    arch = low[0]
    tr = srv.tenants[arch]
    assert tr.loaded_bits == 8
    assert not tr._graphs and tr.pool is None and tr.pool_mb == 0.0
    assert st.tenants[arch].pool_mb == 0.0
    srv.engine.check_event_invariant()
    st.devices.check_invariant()
    r = srv.serve(arch, prompts, max_new=4, now_ms=2000.0)
    assert not r.failed and r.bits == 8
    np.testing.assert_array_equal(r.tokens, eager(tr, prompts, 4))
    srv.engine._now = 5000.0
    ctl.poll(5000.0)
    assert ctl.chips_recovered == 1 and ctl.repromotions == 1
    r = srv.serve(arch, prompts, max_new=4, now_ms=6000.0)
    assert not r.failed and r.bits == 16
    assert tr.loaded_bits == 16 and st.tenants[arch].loaded.bits == 16
    np.testing.assert_array_equal(r.tokens, eager(tr, prompts, 4))
    srv.engine.check_event_invariant()
    st.devices.check_invariant()
    srv.close()
