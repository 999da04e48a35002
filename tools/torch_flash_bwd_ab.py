#!/usr/bin/env python3
"""Device time of the attention backward, ``flash_attention_bwd``, for any
tree's ``repro_torch``, at the training rows as ``chip_smoke.py`` lists
them (``flash_bwd_rows``: tinyllama-1.1b 4 x 1024, gemma2-2b's local and
global layers at 1 x 4200, bf16), in all and by kernel.

    python3 tools/torch_flash_bwd_ab.py --src <dir holding repro_torch>

Needs a CUDA card.  Builds the tree's forward and backward attention
kernels, holds each row's gradients to autograd through the plain version
(``chip_smoke.hold_grads``), then prints the device time of one call by
``chip_smoke.kernel_ms`` and the device time of each kernel the call
launches, averaged by ``torch.profiler`` over five calls (this checkout's
smoke, whatever the tree), and last one JSON line with the card and every
row.  To compare two trees on one card, unpack one with ``git archive``
and run parent, change, change, parent in turns: only numbers from one
card compare.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

CALLS = 5  # profiled calls a row


def by_kernel(fn) -> dict:
    """Device ms a call of each kernel ``fn`` launches, averaged over
    CALLS profiled calls, by the kernel's name without its arguments."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^void |\(.*$", "", e.name.replace(
                "(anonymous namespace)::", ""))
            ms[name] = ms.get(name, 0.0) + e.device_time / 1e3 / CALLS
    return ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="directory that holds the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_flash_bwd_ab: no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa

    card = smoke.card()
    built = build.build_all(("flash_attention", "flash_attention_bwd"))
    g = torch.Generator(device="cuda").manual_seed(0)
    cfgs = [get_config(a) for a in smoke.ARCHS]

    rows = {}
    for what, B, S, H, KV, D, dt, kw in smoke.flash_bwd_rows(cfgs):
        q, k, v, do = (smoke.rand(g, B, S, n, D, dtype=dt)
                       for n in (H, KV, KV, H))
        out, lse = fa.flash_attention_lse(q, k, v, **kw)
        smoke.hold_grads(what, fa.flash_attention_bwd(q, k, v, out, do, lse,
                                                      **kw),
                         ref.flash_attention_bwd(q, k, v, do, **kw), dt)

        def bwd():
            return fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)

        rows[what] = dict(device_ms=smoke.kernel_ms(bwd),
                          kernels_ms=by_kernel(bwd))
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    for what, r in rows.items():
        print(f"{what}: {r['device_ms']:.4f} ms; " + "; ".join(
            f"{n} {ms:.4f}" for n, ms in r["kernels_ms"].items()))
    print(json.dumps({"src": args.src, "card": card, "built_s": built,
                      "rows": rows}))


if __name__ == "__main__":
    main()
