"""The port's examples on the CPU, against the reference's.

``examples/torch_quickstart.py`` and ``examples/quickstart.py`` both run
the sim executor, so the two runs' stats and audit trails are equal.  The
real-executor examples run at their smallest arguments (``--device cpu``),
and what does not depend on the wall clock or on the weights' random
numbers is held to the reference's: the multi-tenant example's zoo sizes,
budget and trace, and the zoo explorer's variant sizes.
"""
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.quant.quantize import params_nbytes, quantize_params
from repro.serving import poisson_trace as jpoisson_trace
from repro.serving.api import BatchingSpec as JBatchingSpec
from repro.serving.api import EdgeServer as JEdgeServer
from repro.serving.api import ServingConfig as JServingConfig
from repro.serving.api import TenantSpec as JTenantSpec

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(EXAMPLES / name), *args],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _globals(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return runpy.run_path(str(EXAMPLES / name), run_name="__main__")


def test_quickstart_equals_reference(monkeypatch, capsys):
    port = _globals("torch_quickstart.py", ["--device", "cpu"], monkeypatch)
    port_out = capsys.readouterr().out
    ref = _globals("quickstart.py", [], monkeypatch)
    assert port_out == capsys.readouterr().out
    assert port["stats"].to_dict() == ref["stats"].to_dict()
    trail = [str(e.audit) for e in port["server"].engine.events]
    assert trail == [str(e.audit) for e in ref["server"].engine.events]
    assert len(trail) > 40


@pytest.mark.parametrize("name", ["torch_multi_tenant_serving.py",
                                  "torch_zoo_fidelity.py"])
def test_real_examples_default_to_the_card(name):
    """Without ``--device`` the models run on the card; on a box without
    one the example says so and stops, and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(EXAMPLES / name)], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr


def test_multi_tenant_serving_on_the_cpu():
    out = _run("torch_multi_tenant_serving.py", "--device", "cpu",
               "--requests", "2")
    tenants = ["tinyllama-1.1b", "mamba2-780m", "gemma2-2b"]
    srv = JEdgeServer.build(JServingConfig(
        tenants=tuple(JTenantSpec(n) for n in tenants), policy="iws-bfe",
        delta_ms=1500.0, batching=JBatchingSpec(max_batch=4,
                                                window_ms=100.0),
        kv_headroom_shape=(4, 12 + 6)))
    try:
        for name in tenants:
            zoo = srv.tenants[name].zoo
            line = f"tenant {name:16s} zoo: " + "  ".join(
                f"{v.bits}bit={v.size_mb:.2f}MB" for v in zoo.variants)
            assert line in out
        assert f"budget: {srv.budget_mb:.2f} MB" in out
        trace, wl = jpoisson_trace(
            {n: srv.tenants[n].cfg for n in tenants}, requests_per_app=2,
            mean_iat_ms=800.0, deviation=0.3, seed=0, max_new=6)
    finally:
        srv.close()
    assert (f"trace: {len(trace)} requests over {wl.horizon_ms / 1e3:.1f}s "
            f"(virtual), KL={wl.kl:.3f}") in out
    served = [int(n) for n in re.findall(r" n=\s*(\d+) ", out)]
    assert sum(served) == len(trace) and "fail=0.00" in out


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_zoo_fidelity_on_the_cpu(arch):
    out = _run("torch_zoo_fidelity.py", "--device", "cpu", "--archs", arch)
    cfg = jget(arch, reduced=True)
    params = JT.init_params(cfg, jax.random.key(0), jnp.float32)
    base = params_nbytes(params)
    rows = re.findall(r"int(\d+)\s+size=\s*([\d.]+)x agree=\s*([\d.]+)%",
                      out)
    assert [int(b) for b, _, _ in rows] == [16, 8, 4]
    for bits, size, agree in rows:
        want = params_nbytes(quantize_params(params, bits=int(bits),
                                             group=32)) / base
        assert size == f"{want:.2f}"
        assert 0.0 <= float(agree) <= 100.0
    assert float(rows[0][2]) == 100.0 and float(rows[1][2]) > 50.0
