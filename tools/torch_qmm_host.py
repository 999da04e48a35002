"""Host cost of the port's ``quant_matmul`` wrapper, and the wall time of
an 8-bit tinyllama-1.1b ``generate``, on one CUDA card.

    python3 tools/torch_qmm_host.py [--src DIR] [--runs N]

``--src`` names the directory that holds the ``repro_torch`` package to
measure (by default this checkout's ``src``), so that two trees of the
port can be measured by the same script on one card: run it for each,
alternating (parent, change, change, parent).  Prints the card's name
and power limit, then one JSON line:

- ``host_us``: host microseconds of one wrapper call at tinyllama's decode
  shapes (M = 4, f32 x, int8 group 32), each the median over 9 passes of
  one decode step's 154 calls begun on an idle card, for ``--runs`` runs;
- ``python_us``: the same with the C launcher replaced by one that
  launches nothing, so the wrapper's Python alone (its checks, the
  output's allocation, the plan); ``host_us`` less this is the ctypes
  call, the tensor maps and the launch;
- ``generate_ms``: the wall time of ``--runs`` 8-bit ``generate`` calls
  (4 prompts of 12 tokens, 8 new), full width, weights random from a
  seed, after two warm-up calls (where ``generate`` runs CUDA graphs,
  the first of them captures and the timed calls replay).
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ARCH = "tinyllama-1.1b"
BATCH, PROMPT, NEW = 4, 12, 8


def host_us(ops, cfg, g) -> float:
    """Median host microseconds a call over 9 passes of one decode step's
    projections (every layer's), each pass begun on an idle card."""
    D, F_, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    shapes = [(D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D), (D, F_),
              (D, F_), (F_, D)]
    weights = [ops.quantize_weights(
        torch.randn(K, N, generator=g, device="cuda") * K ** -0.5, bits=8,
        group=32) for _ in range(cfg.num_layers) for K, N in shapes]
    xs = {K: torch.randn(BATCH, K, generator=g, device="cuda")
          for K, _ in shapes}

    def step():
        for wq, sc in weights:
            ops.quant_matmul(xs[wq.shape[0]], wq, sc)

    step()
    times = []
    for _ in range(9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e6 / len(weights))
    torch.cuda.synchronize()
    return float(np.median(times))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.serving.api import (BatchingSpec, EdgeServer,
                                         ServingConfig, TenantSpec)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; package: {build.CSRC.parent}")
    build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    cfg = get_config(ARCH)
    host = [host_us(ops, cfg, g) for _ in range(args.runs)]
    mod = importlib.import_module("repro_torch.kernels.quant_matmul")
    real = mod.launcher
    mod.launcher = lambda *a, **k: (lambda *b: 0)
    if hasattr(mod, "_launcher"):  # a wrapper that keeps its launcher
        mod._launcher.cache_clear()
    python = [host_us(ops, cfg, g) for _ in range(args.runs)]
    mod.launcher = real
    if hasattr(mod, "_launcher"):
        mod._launcher.cache_clear()
    torch.cuda.empty_cache()

    srv = EdgeServer.build(ServingConfig(
        executor="real", tenants=(TenantSpec(ARCH, reduced=False),),
        kv_headroom_shape=(BATCH, 32),
        batching=BatchingSpec(max_batch=BATCH)), device="cuda")
    tr = srv.tenants[ARCH]
    tr.set_variant(tr.zoo.by_bits(8))
    batch = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    walls = []
    for i in range(args.runs + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.generate(batch, NEW)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    srv.close()
    print(json.dumps({"src": args.src, "host_us": host,
                      "python_us": python, "generate_ms": walls,
                      "host_us_median": float(np.median(host)),
                      "python_us_median": float(np.median(python)),
                      "generate_ms_median": float(np.median(walls))}))


if __name__ == "__main__":
    main()
