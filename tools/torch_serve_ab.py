"""Per-batch latency of the main path's serving trace, unprofiled, on one
CUDA card.

    python3 tools/torch_serve_ab.py [--src DIR]

Builds ``chip_smoke.py``'s server (tinyllama-1.1b, mamba2-780m and
gemma2-2b at full width, random weights from seeds, contended budget)
from the ``repro_torch`` package in ``--src`` (by default this
checkout's ``src``) and serves ``chip_smoke.py``'s trace through it
(``serve_trace``: the trace and the server have one home, this
checkout's ``chip_smoke.py``), with no profiler attached, after
building the kernels.  Two trees of
the port are compared on one card by running it for each, alternating
(parent, change, change, parent), in one call.  Prints the card's name
and power limit, one line a batch, then one JSON line: ``batches``
(tenant, batch size, prompt length, bits, warm, how it ran: "captured",
"replayed" or "eager", latency ms) and ``service_s``, their sum.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build

    print(chip_smoke.card())
    print(f"kernels built in {build.build_all():.1f} s")
    srv = chip_smoke.build_server()
    rows = []
    for b, r, caps, reps in chip_smoke.serve_trace(srv):
        how = "captured" if caps else "replayed" if reps else "eager"
        rows.append(dict(app=b.app, batch=len(b.requests),
                         prompt=int(b.prompts.shape[1]), bits=r.bits,
                         warm=r.warm, ran=how,
                         latency_ms=r.latency_s * 1e3))
        print(f"  batch {b.app} x{len(b.requests)} prompt "
              f"{b.prompts.shape[1]}: bits={r.bits} "
              f"{'warm' if r.warm else 'cold'}"
              f"{' FAILED' if r.failed else ''}, {how}, latency "
              f"{r.latency_s * 1e3:.1f} ms")
        if r.failed:
            sys.exit(f"{b.app}: a batch failed")
    srv.close()
    print(json.dumps({"src": args.src, "batches": rows, "service_s": sum(
        row["latency_ms"] for row in rows) / 1e3}))


if __name__ == "__main__":
    main()
