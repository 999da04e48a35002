#!/usr/bin/env python3
"""Device time of the two prefill kernels, ``ssd_scan`` and
``flash_attention``, for any tree's ``repro_torch``, at the main path's
shapes as ``chip_smoke.py`` lists them (``ssd_main_rows``,
``flash_main_rows``): mamba2-780m's scan at the serving prefill (f32 and
bf16) and at a long prompt; tinyllama-1.1b's and gemma2-2b's attention at
the serving prefill and at the replay's prompts.

    python3 tools/torch_prefill_ab.py --src <dir holding repro_torch>

Needs a CUDA card.  Builds the tree's two kernels, then prints, for each
shape, the device time of one call by ``chip_smoke.kernel_ms`` (this
checkout's smoke, whatever the tree), and last one JSON line with the
card and every row.  To compare two trees on one card, unpack one with
``git archive`` and run parent, change, change, parent in turns: only
numbers from one card compare.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="directory that holds the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_prefill_ab: no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops

    card = smoke.card()
    built = build.build_all(("ssd_scan", "flash_attention"))
    g = torch.Generator(device="cuda").manual_seed(0)
    cfgs = [get_config(a) for a in smoke.ARCHS]

    rows = {}
    for label, shape, dt in smoke.ssd_main_rows(
            next(c for c in cfgs if c.uses_ssm)):
        x, dt_, A, Bm, Cm, D, _ = smoke.ssd_inputs(g, *shape, dt)
        rows[f"ssd {label} {shape} {dt}"] = smoke.kernel_ms(
            lambda: ops.ssd_scan(x, dt_, A, Bm, Cm, D, return_state=True))
    for what, B, S, H, KV, D, dt, kw in smoke.flash_main_rows(cfgs):
        q, k, v = (smoke.rand(g, B, S, n, D, dtype=dt) for n in (H, KV, KV))
        rows[f"flash {what} {(B, S, H, KV, D)} {dt} {kw}"] = smoke.kernel_ms(
            lambda: ops.flash_attention(q, k, v, **kw))
        del q, k, v
    for label, ms in rows.items():
        print(f"{label}: {ms:.4f} ms")
    print(json.dumps({"src": args.src, "card": card, "built_s": built,
                      "device_ms": rows}))


if __name__ == "__main__":
    main()
