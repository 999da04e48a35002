"""Multi-tenant serving launcher: Edge-MultiAI managing real (reduced)
models under a device memory budget, driven by a synthetic request trace.
The stack comes up through the declarative API — every CLI flag maps
onto a :class:`~repro_torch.serving.api.ServingConfig` field and
``EdgeServer.build`` does the wiring.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --tenants tinyllama-1.1b gemma2-2b mamba2-780m --requests 30 \
        --budget-mb 6

Real tenants run on ``--device`` (default ``cuda``; asking for it without
a card raises).  ``--sharded-mesh`` serves from a mesh, weights accounted
per chip under per-device budgets: on one card the mesh is logical; on a
machine with as many cards as the mesh has devices the launcher starts
one rank a card (NCCL carries the tensors, gloo rank 0's calls), places
every tenant across them, and rank 0 serves and prints.  ``--nproc N``
starts N ranks on any device, e.g. on gloo CPU ranks:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --nproc 2 --sharded-mesh 2 --requests 8
"""
from __future__ import annotations

import argparse
import math
import tempfile

import numpy as np
import torch

from repro_torch.core.policies import available_policies
from repro_torch.serving import Batcher, Request
from repro_torch.serving.api import (BatchingSpec, EdgeServer, LoaderSpec,
                                     ServingConfig, TenantSpec)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", nargs="+",
                    default=["tinyllama-1.1b", "gemma2-2b", "mamba2-780m"])
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--budget-mb", type=float, default=6.0)
    ap.add_argument("--policy", default="iws-bfe",
                    choices=["none", *available_policies()])
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sim", action="store_true",
                    help="sim-time executors (no model, deterministic)")
    ap.add_argument("--sharded-mesh", type=int, nargs="+", default=None,
                    metavar="N", help="serve from a device mesh, e.g. "
                    "'--sharded-mesh 8' (8-way tensor parallel): weights "
                    "shard per chip, loads stage per shard under "
                    "per-device budgets")
    ap.add_argument("--device", default="cuda",
                    help="device real tenants run on ('cuda' or 'cpu')")
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks to start, one a device of the mesh "
                    "(default: the mesh's size on a CUDA machine with "
                    "that many cards, else 1)")
    args = ap.parse_args()
    n = math.prod(args.sharded_mesh or (1,))
    nproc = args.nproc
    if nproc is None:
        nproc = (n if n > 1 and not args.sim and args.device == "cuda"
                 and torch.cuda.device_count() >= n else 1)
    if nproc == 1:
        serve(args)
        return
    if nproc != n:
        ap.error(f"--nproc {nproc} ranks for a mesh of {n} devices: give "
                 "--sharded-mesh with one device a rank")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as root:
        mp.start_processes(_rank, args=(args, nproc, f"file://{root}/rdzv"),
                           nprocs=nproc, start_method="spawn")


def _rank(rank: int, args, world: int, init: str) -> None:
    """One rank of a placed server: NCCL for a card's tensors (gloo for
    the CPU's), the server built on every rank, rank 0 serving."""
    import torch.distributed as dist

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world)
    try:
        serve(args)
    finally:
        dist.destroy_process_group()


def serve(args) -> None:
    """Build the server and, on its one controller, serve the trace."""
    rng = np.random.default_rng(args.seed)
    server = EdgeServer.build(ServingConfig(
        tenants=tuple(TenantSpec(n) for n in args.tenants),
        budget_mb=args.budget_mb,
        policy=args.policy,
        delta_ms=2000.0,
        batching=BatchingSpec(max_batch=4),
        loader=(LoaderSpec(sharded=True,
                           mesh_shape=tuple(args.sharded_mesh))
                if args.sharded_mesh else LoaderSpec()),
        executor="sim" if args.sim else "real"), device=args.device)
    if server.is_worker:  # a placed server's other ranks
        server.run_worker()
        return
    if server.manager.state.devices is not None:
        led = server.manager.state.devices
        print(f"mesh: {led.n_devices} chips x "
              f"{led.budgets_mb[0]:.2f}MB device budget"
              + (f", placed on {nproc} ranks"
                 if (nproc := math.prod(args.sharded_mesh)) > 1
                 and server.physical_mesh is not None else ""))
    cfgs = {}
    for name in args.tenants:
        cfgs[name] = server.tenants[name].cfg
        zoo = server.tenants[name].zoo
        print(f"tenant {name}: zoo " + ", ".join(
            f"{v.bits}b={v.size_mb:.2f}MB" for v in zoo.variants))

    batcher = Batcher(max_batch=4)
    now = 0.0
    for i in range(args.requests):
        name = args.tenants[i % len(args.tenants)]
        cfg = cfgs[name]
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        batcher.submit(Request(app=name, prompt=prompt,
                               max_new=args.max_new, arrival_ms=now))
        now += float(rng.exponential(500.0))
        if batcher.pending() >= 3 or i == args.requests - 1:
            while (b := batcher.next_batch()) is not None:
                server.predict_and_preload(now)
                extra = None
                # Gate on the *batch's* tenant, not the most recently
                # submitted request's.
                if cfgs[b.app].frontend == "vision_stub" and not args.sim:
                    extra = {"patch_embeds": np.zeros(
                        (len(b.requests), cfgs[b.app].num_vision_tokens,
                         cfgs[b.app].d_model), np.float32)}
                r = server.serve(b.app, b.prompts, b.max_new, now_ms=now,
                                 extra=extra)
                print(f"[{now:8.0f}ms] {b.app:16s} batch={len(b.requests)} "
                      f"{'warm' if r.warm else 'COLD'}"
                      f"{' FAIL' if r.failed else ''} bits={r.bits} "
                      f"lat={r.latency_s * 1e3:.0f}ms")
    print("\nstats:", server.stats().to_dict())
    server.close()


if __name__ == "__main__":
    main()
