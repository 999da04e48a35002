#!/usr/bin/env python3
"""Device time of the scan's backward, ``ssd_scan_bwd``, for any tree's
``repro_torch``, at the training rows as ``chip_smoke.py`` lists them
(``SSD_BWD_ROWS``: mamba2-780m 4 x 1024, hymba-1.5b's branch 1 x 2176,
bf16), in all and by kernel.

    python3 tools/torch_ssd_bwd_ab.py --src <dir holding repro_torch>

Needs a CUDA card.  Builds the tree's forward and backward scan kernels,
holds each row's gradients to autograd through the plain chunked form at
the kernel's own chunk (``chip_smoke.hold_ssd_grads`` against
``chip_smoke.ssd_oracle``), then prints the
device time of one call by ``chip_smoke.kernel_ms`` and the device time of
each kernel the call launches, averaged by ``torch.profiler`` over five
calls (``tools/torch_flash_bwd_ab.py``'s ``by_kernel``; this checkout's
smoke and tools, whatever the tree), and last one JSON line with the card
and every row.  To compare two trees on one card, unpack one with ``git
archive`` and run parent, change, change, parent in turns: only numbers
from one card compare.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402
from tools.torch_flash_bwd_ab import by_kernel  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="directory that holds the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_ssd_bwd_ab: no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd_scan as sm

    card = smoke.card()
    built = build.build_all(("ssd_scan", "ssd_scan_bwd"))
    g = torch.Generator(device="cuda").manual_seed(0)

    rows = {}
    for arch, B, S in smoke.SSD_BWD_ROWS:
        cfg = get_config(arch)
        shape = (B, S, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                 cfg.ssm_state)
        x, dt, A, Bm, Cm, D, _ = smoke.ssd_inputs(g, *shape, torch.bfloat16)
        ins = (x, dt, A, Bm, Cm, D)
        dy = smoke.rand(g, *shape[:4], dtype=torch.bfloat16)
        kq = sm.ssd_bwd_plan(*shape).kq
        what = f"{arch} {shape}"
        smoke.hold_ssd_grads(what, sm.ssd_scan_bwd(*ins, dy),
                             smoke.ssd_oracle(ref, ins, dy, kq))
        torch.cuda.empty_cache()

        def bwd():
            return sm.ssd_scan_bwd(*ins, dy)

        rows[what] = dict(device_ms=smoke.kernel_ms(bwd),
                          kernels_ms=by_kernel(bwd))
        del x, dt, Bm, Cm, dy, ins
        torch.cuda.empty_cache()
    for what, r in rows.items():
        print(f"{what}: {r['device_ms']:.4f} ms; " + "; ".join(
            f"{n} {ms:.4f}" for n, ms in r["kernels_ms"].items()))
    print(json.dumps({"src": args.src, "card": card, "built_s": built,
                      "rows": rows}))


if __name__ == "__main__":
    main()
