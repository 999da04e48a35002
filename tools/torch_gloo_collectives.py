#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, and how fast, with two ranks
sharing one card (NCCL refuses two ranks on one device, so the placed and
ZeRO phases of ``chip_smoke.py`` run over gloo).

    python3 tools/torch_gloo_collectives.py [--mb 256]

Needs a CUDA card.  Spawns two ranks (file rendezvous in a temporary
directory under ``build/``) that call ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``reduce_scatter`` on small f32 and bf16 CUDA tensors, each result held to
its exact value, then time one call of each on ``--mb`` MB a rank (f32 and
bf16; the card synchronized around it).  Prints one JSON line a rank: each
call's result or its error, and the seconds of each timed call.
"""
from __future__ import annotations

import argparse
import datetime
import json
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]


def checks(rank: int) -> dict:
    """Each collective on two small CUDA tensors: "ok", or its error."""
    x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
    total = torch.arange(8, dtype=torch.float32, device="cuda") * 2 + 1

    def mine(dt):  # a copy: the in-place collectives leave x alone
        return x.to(dt, copy=True)

    def reduce_scatter(dt):
        out = torch.empty(4, dtype=dt, device="cuda")
        dist.reduce_scatter_tensor(out, mine(dt))
        return out, total[rank * 4:(rank + 1) * 4]

    def reduce_scatter_list(dt):
        out = torch.empty(4, dtype=dt, device="cuda")
        dist.reduce_scatter(out, list(mine(dt).chunk(2)))
        return out, total[rank * 4:(rank + 1) * 4]

    def all_gather(dt):
        out = torch.empty(16, dtype=dt, device="cuda")
        dist.all_gather_into_tensor(out, mine(dt))
        return out, torch.cat([x - rank, x - rank + 1])

    def all_reduce(dt):
        y = mine(dt)
        dist.all_reduce(y)
        return y, total

    res = {}
    for fn in (all_reduce, all_gather, reduce_scatter, reduce_scatter_list):
        for dt in (torch.float32, torch.bfloat16):
            key = f"{fn.__name__}/{str(dt).split('.')[-1]}"
            try:
                got, want = fn(dt)
                torch.cuda.synchronize()
                res[key] = ("ok" if torch.equal(got.float(), want.float())
                            else f"wrong: {got.tolist()}")
            except Exception as e:  # the answer this tool looks for
                res[key] = f"{type(e).__name__}: {str(e)[:200]}"
    return res


def rates(mb: int) -> dict:
    """Seconds of one call of each collective on ``mb`` MB a rank."""
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        n = mb * 2 ** 20 // dt.itemsize
        src = torch.ones(n, dtype=dt, device="cuda")
        calls = {
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(2 * n, dtype=dt, device="cuda"), src),
            "all_reduce": lambda: dist.all_reduce(src.clone()),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(n // 2, dtype=dt, device="cuda"), src)}
        for name, call in calls.items():
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            out[f"{name}/{str(dt).split('.')[-1]}/s"] = (
                time.perf_counter() - t0)
    return out


def rank_main(rank: int, root: str, mb: int) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = {"rank": rank, "checks": checks(rank), "mb": mb}
        out.update(rates(mb))
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        mp.start_processes(rank_main, args=(root, args.mb), nprocs=2,
                           start_method="spawn")


if __name__ == "__main__":
    main()
