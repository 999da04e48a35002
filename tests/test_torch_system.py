"""The port's counterpart of ``tests/test_system.py``: the paper's
framework driving real models on the CPU, training end to end, the
public API, and the training launcher run as a user runs it."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.paper_edge import paper_zoos
from repro_torch.core import generate_workload, simulate
from repro_torch.models import transformer as T
from repro_torch.serving import EdgeServer, kv_cache_mb

ROOT = Path(__file__).resolve().parents[1]


def test_public_api_importable():
    import repro_torch.core as core
    import repro_torch.distributed.checkpoint  # noqa: F401
    import repro_torch.kernels.ops as ops  # noqa: F401
    import repro_torch.quant.quantize  # noqa: F401
    import repro_torch.serving  # noqa: F401
    import repro_torch.training.train_step  # noqa: F401

    assert {"lfe", "bfe", "ws-bfe", "iws-bfe",
            "batch-bfe"} <= set(core.available_policies())
    assert len(ARCH_NAMES) == 10


def test_end_to_end_paper_pipeline():
    """Workload → simulate all policies → paper-shaped outcome."""
    zoos = paper_zoos()
    wl = generate_workload(list(zoos), requests_per_app=40,
                           deviation=0.3, seed=0)
    results = {p: simulate(zoos, wl, policy=p)
               for p in ("none", "iws-bfe")}
    assert (results["iws-bfe"].metrics.warm_ratio
            > results["none"].metrics.warm_ratio * 1.4)


def test_end_to_end_serving_with_predictors():
    """Tenants served warm after the RNN predictor learns the cadence."""
    srv = EdgeServer(budget_mb=1e9, policy="iws-bfe", delta_ms=500.0,
                     device="cpu")
    names = ["tinyllama-1.1b", "mamba2-780m"]
    for n in names:
        cfg = get_config(n, reduced=True)
        srv.register(n, cfg, T.init_params(cfg, 1, torch.float32,
                                           device="cpu"))
    # Feasible contention, with headroom for the largest per-request
    # decode cache (max_new=2 on a 4-token prompt).
    kv = max(kv_cache_mb(get_config(n, reduced=True), 1, 6) for n in names)
    srv.budget_mb = srv.contention_budget(kv)
    srv.start()
    rng = np.random.default_rng(0)
    now = 0.0
    for i in range(10):
        n = names[i % 2]
        cfg = get_config(n, reduced=True)
        srv.predict_and_preload(now)
        prompts = rng.integers(0, cfg.vocab_size, (1, 4)).astype(np.int32)
        r = srv.serve(n, prompts, max_new=2, now_ms=now)
        assert not r.failed
        now += 1000.0
    s = srv.stats()
    assert s.requests == 10
    assert s.fail_ratio == 0.0
    srv.close()


def test_training_end_to_end_loss_decreases():
    from repro_torch.training.data import DataConfig, SyntheticStream
    from repro_torch.training.optim import AdamW, warmup_cosine
    from repro_torch.training.train_step import init_state, make_train_step

    cfg = get_config("mamba2-780m", reduced=True)
    opt = AdamW(lr=warmup_cosine(3e-3, 5, 30))
    step = make_train_step(cfg, opt, compute_dtype=None)
    state = init_state(cfg, 0, opt, device="cpu")
    ds = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4))
    losses = []
    for s in range(30):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(s).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::10]


def _train_cli(*args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)


def test_train_launcher_recovers_from_a_failure(tmp_path):
    """``launch/train.py --reduced`` on the CPU through ``run_supervised``:
    a node failure at step 3, restored from the step-2 checkpoint, the
    run ends at step 6."""
    out = _train_cli("--reduced", "--device", "cpu", "--steps", "6",
                     "--fail-at", "3", "--ckpt-every", "2",
                     tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "steps=6 restarts=1" in out.stdout
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "step_00000002", "step_00000004", "step_00000006"]


def test_train_launcher_full_config_and_missing_card_raise(tmp_path):
    """Without ``--reduced`` the launcher runs the ``train_4k`` cell's
    dry-run on ``meta`` tensors (no device) and prints its line with the
    H100 roofline terms; the default device without a card names the
    cause."""
    out = _train_cli("--arch", "tinyllama-1.1b", "--steps", "1",
                     tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "tinyllama-1.1b × train_4k: OK" in out.stdout
    assert "compute=" in out.stdout and "memory=" in out.stdout
    if not torch.cuda.is_available():
        out = _train_cli("--reduced", "--steps", "1", tmp_path=tmp_path)
        assert out.returncode != 0
        assert "no CUDA device is available" in out.stderr


def test_train_launcher_full_config_fails_unless_the_cell_is_ok(monkeypatch):
    """A ``train_4k`` cell that comes back FAIL or SKIP ends the
    full-config launcher with a non-zero exit naming the status."""
    import pytest

    from repro_torch.launch import dryrun, train

    for status in ("FAIL", "SKIP(full-attn)"):
        monkeypatch.setattr(dryrun, "run_cell",
                            lambda *a, status=status, **k: {"status": status})
        with pytest.raises(SystemExit) as e:
            train.main(["--arch", "tinyllama-1.1b"])
        assert e.value.code not in (0, None) and status in str(e.value.code)
