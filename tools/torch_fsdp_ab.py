#!/usr/bin/env python3
"""Phases 13 and 14 (a) of a tree's own ``chip_smoke.py``, alone: ZeRO
training on 2 gloo ranks and tensor-parallel training on a (data 2,
model 2) mesh of 4, each rank sharing the one card, at the smoke's cuts.

    python3 tools/torch_fsdp_ab.py --tree <checkout root>

Needs a CUDA card.  Builds the tree's kernels, spawns the tree's
``zero_run`` and ``tp_run`` ranks (each step 1 held to one process's plain
step as the smoke holds it), and prints one JSON line: the card, and for
each phase, rank and model the allocator's peak over the timed step
(GB), the step's seconds, the seconds in gloo, the bytes a step by
collective kind and mesh axis, the allocator's peak at the entry of the
timed step's AdamW update (the forward, the backward and the gradients'
reduction; recorded by this script the same way for every tree), and
the gathered high-water mark where the tree's step records one.  To
compare two trees on one card, unpack the other with ``git archive`` and
run parent, change, change, parent in turns: only numbers from one card
compare.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path


def ranked(name: str, rank: int, world: int) -> dict:
    """The tree's ``chip_smoke.<name>`` on one spawned rank, with every
    ``AdamW.update`` recording the allocator's peak at its entry; the
    first entry after each ``reset_peak_memory_stats`` is the timed
    step's.  Rank 0's result gains every rank's list, in rank order."""
    import torch
    import torch.distributed as dist

    import chip_smoke as smoke
    from repro_torch.training import optim

    seen, marks = [], []
    update, reset = optim.AdamW.update, torch.cuda.reset_peak_memory_stats

    def entry(self, *a, **k):
        seen.append(torch.cuda.max_memory_allocated() / 1e9)
        return update(self, *a, **k)

    def marked(*a, **k):
        marks.append(len(seen))
        return reset(*a, **k)

    optim.AdamW.update = entry
    torch.cuda.reset_peak_memory_stats = marked
    out = getattr(smoke, name)(rank, world)
    every = [None] * world
    dist.all_gather_object(every, [seen[i] for i in marks])
    if rank == 0:
        out["pre_update_gb"] = every
    return out


def zero_ranked(rank: int, world: int) -> dict:
    return ranked("zero_run", rank, world)


def tp_ranked(rank: int, world: int) -> dict:
    return ranked("tp_run", rank, world)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="a checkout's root: chip_smoke.py and src/")
    tree = Path(ap.parse_args().tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_fsdp_ab: no CUDA device")
    import chip_smoke as smoke
    from repro_torch.kernels import build

    build.build_all()
    out = {"tree": str(tree), "card": smoke.card(), "runs": []}
    for phase, run, world in (
            ("13", zero_ranked, smoke.ZERO_RANKS),
            ("14a", tp_ranked, math.prod(smoke.TP_MESH))):
        # Phase 14's ranks take the allocator setting check_tp gives them.
        if phase == "14a":
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        res = smoke.spawn_ranks(run, world)
        for r, rk in enumerate(res["ranks"]):
            for x, pre in zip(rk["runs"], res["pre_update_gb"][r]):
                out["runs"].append({
                    "phase": phase, "rank": r, "arch": x["arch"],
                    "layers": x["layers"], "peak_gb": x["peak_gb"],
                    "pre_update_gb": pre,
                    "step_s": x["step_s"], "gloo_s": x["gloo_s"],
                    "bytes": x.get("by_axis") or x["bytes"],
                    "gathered_peak": x.get("gathered_peak"),
                    "gathered_bound": x.get("gathered_bound"),
                    "whole_copy": x.get("whole_copy")})
        print(f"torch_fsdp_ab: phase {phase} held: "
              + json.dumps(res["held"]), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
