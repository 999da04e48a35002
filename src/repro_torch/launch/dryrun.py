"""Multi-pod dry-run: prove a cell's step is coherent on the production mesh
without hardware, and price it against one card's roofline.

Port of :mod:`repro.launch.dryrun`.  For every (architecture x input
shape) cell this runs the real step function (``train_step`` for the
train shape, ``prefill`` / the greedy ``decode_step`` for the serving
shapes) of :func:`repro_torch.launch.steps.build_cell` on its ``meta``
stand-ins, on the single-pod 16 x 16 (data, model) mesh (the roofline's
source) or the 2 x 16 x 16 (pod, data, model) mesh.  Nothing touches a
device: a ``meta`` tensor carries shapes and types only, and the kernel
wrappers hand it to their plain versions, as the reference's dry-run
lowers on host CPUs.

Where the reference lowers and compiles the SPMD-partitioned program and
reads XLA's analyses, the port runs a program and counts it.  A train
cell runs one device's own program: its state placed by
:func:`~repro_torch.distributed.sharding.place_state` on a ``DeviceMesh``
of the production shape over a fake process group
(:func:`~repro_torch.launch.mesh.fake_production_mesh`, this process as
rank 0), its batch rank 0's rows, and the step of
:func:`~repro_torch.training.train_step.make_train_step` gathering,
reducing and updating rank 0's blocks: ZeRO over every mesh axis for a
pure data-parallel cell (every mesh axis a data axis,
:func:`~repro_torch.launch.steps.pure_dp`: 7 of the 10 ``train_4k``
cells), and for yi-6b, olmoe-1b-7b and llama4-scout ZeRO over the data
axis with tensor parallelism over the model axis (each layer's
all-reduces and gathers inside the forward, the backward and remat's
recomputation, and each cross-entropy chunk's small all-reduces over the
vocabulary split, at ``pick_grad_accum``'s micro-batching; llama4's 40
query heads over 16 ranks, 3 or 2 a rank, rank 0 the 3; the MoE cells in
every ``moe_impl``, a ``ragged`` rank's slots on ``meta`` the balanced
split, :func:`repro_torch.models.layers._group_sizes`).  Every other
cell (serving, and a train cell whose placed step raises
``NotImplementedError``: a config that needs what the tensor-parallel
path lacks, :func:`repro_torch.models.transformer.tp_train_gaps`;
ROADMAP A13) runs the unpartitioned program, the whole global batch on
one process, and so does a train cell under ``run_cell(placed=False)``:
the program ``build_cell`` gives on a ``LogicalMesh``, which a one-card
run of the cell executes.  Counted:

* FLOPs with ``torch.utils.flop_counter.FlopCounterMode``;
* bytes accessed with a ``TorchDispatchMode`` that sums the operand and
  result bytes of every aten operation that is not a view, as the port's
  eager program moves them on the card: the nearest analogue of XLA's
  "bytes accessed".  A kernel wrapper's plain version (attention, the
  scan, their backwards, the decode attention, the int8 matmul) counts
  as its kernel does, :func:`repro_torch.kernels.ref.as_kernel`: its
  inputs read once and its outputs written once, none of the plain
  version's intermediates (the attention's S x T scores never reach
  memory on the card);
* collectives: each ``c10d`` operation the same mode sees becomes a
  :class:`~repro_torch.launch.roofline.Collective` (kind, dtype, local
  output shape, the size of its process group), priced by
  :func:`~repro_torch.launch.roofline.collective_wire_bytes`, and is
  listed with the mesh axis of its group.  A cell that is not placed
  calls none: its ``collectives`` are null, with the reason.

**Per-device cost**: a placed cell's counts are already a device's.  An
unplaced cell's are divided by the mesh's chips: a partitioned step
divides its work evenly (the reference's per-device cost analysis of a
data-parallel cell is the same division).
:func:`~repro_torch.launch.roofline.roofline_terms` then divides by one
card's peaks, as the reference's does.

**Memory** per device comes from the spec trees, exactly: each argument
and output leaf's bytes divided by the product of the mesh axes its
partition names, the donated arguments aliased to the outputs that take
their buffers (the reference's ``alias_size``).  Of the temporaries a
placed train cell counts the high-water mark of the bf16 blocks its step
gathers at their use sites (:func:`repro_torch.distributed.fsdp.metered`:
each block from its gather until it is freed), its ``temp_bytes``; the
activations and the gradient buffers are not counted (``meta`` tensors
allocate nothing).  An unplaced cell runs the unpartitioned program:
its ``temp_bytes`` is null with the reason.  ``peak_bytes`` (the
arguments, outputs and ``temp_bytes``, less the aliases) and
``hbm_fraction`` (of the H100's ``HBM_BYTES``) are bounds from below, and
so is a placed cell's ``temp_bytes``.

The L2/L4 probe stays: counts at 2 and 4 layers give ``per_layer_flops``
through :func:`~repro_torch.launch.roofline.extrapolate`.  The port's
Python loop over layers counts every layer (no scan body is counted
once), so the full-depth count is itself exact and is what the roofline
reads; the extrapolation equals it wherever every layer is the same kind.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-probe
    PYTHONPATH=src python -m repro_torch.launch.dryrun --rank-step yi-6b:4 olmoe-1b-7b:2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from contextlib import nullcontext
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed.fsdp import metered
from repro_torch.distributed.sharding import (LogicalMesh, _divisor,
                                               logical, spec_map)
from repro_torch.kernels import ref
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (HBM_BYTES, fake_mesh,
                                    fake_production_mesh,
                                    make_production_mesh)
from repro_torch.launch.steps import build_cell, pure_dp
from repro_torch.models.config import SHAPE_SPECS, cell_is_runnable

# Namespaces of torch.distributed's collectives, as the dispatcher sees them.
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
# The c10d operations the port's steps call (``all_reduce``,
# ``all_gather_into_tensor``, ``reduce_scatter_tensor``), by kind; each
# takes its output (or its list of in-place tensors) first.
_COLLECTIVE_KINDS = {"allreduce_": "all-reduce",
                     "_allgather_base_": "all-gather",
                     "_reduce_scatter_base_": "reduce-scatter"}


def pick_grad_accum(cfg, shape_name, mesh) -> int:
    """Choose microbatching so the remat residual stack (~6 bytes/act
    element x L layers) stays under ~5 GB/device.  Powers of two, <= 16."""
    seq, gbatch, kind = SHAPE_SPECS[shape_name]
    if kind != "train":
        return 1
    if pure_dp(cfg, shape_name, mesh):
        return 1  # pure-DP cells: one row per device already
    dp = 1
    for a in mesh.axis_names:
        if a in ("pod", "data"):
            dp *= mesh.shape[a]
    b_loc = max(gbatch // dp, 1)
    per_b = seq * cfg.d_model * 6 * cfg.num_layers  # bytes per batch row
    accum = 1
    while accum < min(b_loc, 16) and b_loc // accum * per_b > 5e9:
        accum *= 2
    return accum


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor operand and result of each aten
    operation that is not a view (a view moves nothing), outside a
    kernel's plain version, and those of each kernel's inputs and outputs
    (:data:`repro_torch.kernels.ref.KERNEL_IO`); makes each collective a
    :class:`~repro_torch.launch.roofline.Collective` record, and names
    its mesh axis in ``axes`` (from ``axis_of``: a process group's name to
    its mesh axis; None where it is not there)."""

    def __init__(self, axis_of: Optional[dict] = None):
        super().__init__()
        self.bytes = 0
        self.collectives, self.axes = [], []
        self.axis_of = axis_of or {}

    def __enter__(self):
        self._kernel_bytes = ref.KERNEL_IO.bytes
        return super().__enter__()

    def __exit__(self, *exc):
        self.bytes += ref.KERNEL_IO.bytes - self._kernel_bytes
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in _COLLECTIVE_NAMESPACES:
            recs, group = _records(func, args)
            self.collectives += recs
            self.axes += [self.axis_of.get(group.group_name)] * len(recs)
        if not func.is_view and not ref.KERNEL_IO.depth:
            tensors = [t for t in tree_leaves((args, kwargs, out))
                       if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in tensors)
        return out


def _records(func, args) -> tuple:
    """(the :class:`~repro_torch.launch.roofline.Collective` records of one
    collective operation (one a tensor of an all-reduce's list), from its
    output's local shape and its process group's size; the group)."""
    import torch.distributed as dist

    name = func._schema.name.split("::")[-1]
    if func.namespace != "c10d" or name not in _COLLECTIVE_KINDS:
        raise NotImplementedError(f"collective {func} has no record")
    group = next(dist.ProcessGroup.unbox(a) for a in args
                 if isinstance(a, torch.ScriptObject) and a._type()
                 .qualified_name().endswith("c10d.ProcessGroup"))
    outs = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
    return [RL.Collective(_COLLECTIVE_KINDS[name], t.dtype, tuple(t.shape),
                          group.size()) for t in outs], group


def axes_of(mesh) -> dict:
    """A ``DeviceMesh``'s process groups by name, each to its dim's name."""
    return {mesh.get_group(i).group_name: n
            for i, n in enumerate(mesh.mesh_dim_names)}


def count(fn, args, records: Optional[list] = None,
          axis_of: Optional[dict] = None) -> tuple:
    """(the outputs, the :class:`~repro_torch.launch.roofline.CellCost`)
    of ``fn(*args)``: the whole program's, or one device's where ``args``
    are placed.  Each collective's (record, mesh axis) is appended to
    ``records`` when it is a list (the axis from ``axis_of``,
    :func:`axes_of`)."""
    with (FlopCounterMode(display=False) as flops,
          ByteCounter(axis_of) as nb):
        out = fn(*args)
    if records is not None:
        records += zip(nb.collectives, nb.axes)
    return out, RL.CellCost(float(flops.get_total_flops()), float(nb.bytes),
                            RL.collective_wire_bytes(nb.collectives))


def _per_device_bytes(tree, spec_tree, mesh) -> float:
    total = [0.0]

    def add(spec, leaf):
        total[0] += _nbytes(leaf) / _divisor(spec, mesh)
        return spec

    spec_map(add, spec_tree, tree)
    return total[0]


def _mem_stats(args, in_specs, out, out_specs, donate, mesh,
               placed, temp: Optional[float] = None) -> dict:
    arg = sum(_per_device_bytes(a, s, mesh) for a, s in zip(args, in_specs))
    alias = sum(_per_device_bytes(args[i], in_specs[i], mesh)
                for i in donate)
    outb = sum(_per_device_bytes(o, s, mesh)
               for o, s in zip(out, out_specs))
    peak = arg + outb - alias + (temp or 0.0)
    return {
        "argument_bytes": arg,
        "output_bytes": outb,
        "alias_bytes": alias,
        "temp_bytes": temp,
        "temp_reason": (
            "the step's high-water mark of the bf16 blocks gathered at "
            "their use sites (repro_torch.distributed.fsdp's Meter), "
            "nothing else: the activations, the gradient buffers and "
            "every other temporary are not counted (meta tensors "
            "allocate nothing)"
            if placed else
            "the partitioned program's temporaries: the port runs this "
            "cell's unpartitioned program (ROADMAP A13)"),
        "peak_bytes": peak,
        "hbm_fraction": peak / HBM_BYTES,
        "exact": ["argument_bytes", "output_bytes", "alias_bytes"],
        "lower_bounds": ["peak_bytes", "hbm_fraction"]
        + (["temp_bytes"] if placed else []),
    }


def _run(cfg, shape_name, mesh, *, moe_impl, grad_accum, qcache, dp_only,
         records=None):
    fn, args, in_sp, out_sp, donate = build_cell(
        cfg, shape_name, mesh, moe_impl=moe_impl, grad_accum=grad_accum,
        qcache=qcache, dp_only=dp_only)
    placed = not isinstance(mesh, LogicalMesh)
    with metered() as meter:
        out, cost = count(fn, args, records,
                          axes_of(mesh) if placed else None)
    return cost, _mem_stats(args, in_sp, out, out_sp, donate,
                            logical(mesh) if placed else mesh, placed,
                            float(meter.peak) if placed else None)


def _cost_dict(cost: RL.CellCost, per: int) -> dict:
    """A device's share of ``cost``: divided by ``per`` (the chips, for a
    count of the whole program; 1 for a device's own)."""
    return {"flops_per_device": cost.flops / per,
            "bytes_per_device": cost.bytes_accessed / per,
            "coll_bytes_per_device": cost.coll_total}


def _collective_rows(records) -> list:
    """The (record, axis) pairs as JSON rows, one for each distinct (kind,
    dtype, shape, group, axis) with its count and wire bytes."""
    rows: dict = {}
    for rec, axis in records:
        row = rows.setdefault((rec, axis), {
            "kind": rec.kind, "dtype": str(rec.dtype).split(".")[-1],
            "shape": list(rec.shape), "group": rec.group, "axis": axis,
            "count": 0, "wire_bytes": 0.0})
        row["count"] += 1
        row["wire_bytes"] += RL.collective_wire_bytes([rec])[rec.kind]
    return list(rows.values())


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             probe: bool = True, moe_impl: str = "dense",
             qcache: bool = False, verbose: bool = True,
             placed: Optional[bool] = None) -> dict:
    """One cell's dry-run record.  A train cell runs placed on
    :func:`~repro_torch.launch.mesh.fake_production_mesh` (which raises if
    a process group is already initialized and destroys its own on the way
    out), unless the step refuses the placed state
    (``NotImplementedError``: its config needs what the tensor-parallel
    path lacks, :func:`repro_torch.models.transformer.tp_train_gaps`;
    the message becomes ``collectives_reason``); ``placed=False`` prices
    it unplaced instead (the whole program on one process, divided by the
    chips: the program that ``build_cell`` gives on a ``LogicalMesh``)."""
    cfg = get_config(arch)
    result: dict = {"arch": arch, "shape": shape_name,
                    "multi_pod": multi_pod, "moe_impl": moe_impl,
                    "qcache": qcache}
    if not cell_is_runnable(arch, shape_name):
        result["status"] = "SKIP(full-attn)"
        return result
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    # dp_only is decided ONCE from the full config so the shallow L2/L4
    # probes run with the same parallelism mapping.
    dp_only = pure_dp(cfg, shape_name, mesh)
    result["dp_only"] = dp_only
    # A train cell runs one device's program; every other cell the whole
    # program, divided by the chips.
    train = SHAPE_SPECS[shape_name][2] == "train"
    placed = train if placed is None else placed and train
    reason = ("its placed program prices them (placed=None)" if train
              else "the serving cells' collectives are ROADMAP A13")
    result["placed"] = placed
    records: list = []

    def measure(placed: bool) -> tuple:
        """(the full-depth cost, its memory, the cost as JSON with the
        probe's extrapolation) of the placed or the unplaced program."""
        per = 1 if placed else chips
        kw = dict(moe_impl=moe_impl, qcache=qcache, dp_only=dp_only)
        t0 = time.time()
        with (fake_production_mesh(multi_pod=multi_pod) if placed
              else nullcontext(mesh)) as run_mesh:
            total, memory = _run(
                cfg, shape_name, run_mesh, records=records,
                grad_accum=pick_grad_accum(cfg, shape_name, mesh), **kw)
            result["run_s"] = time.time() - t0
            cost = _cost_dict(total, per)
            if probe and not multi_pod:
                costs = {}
                for Lp in (2, 4):
                    cfg_p = dataclasses.replace(cfg, num_layers=Lp)
                    costs[Lp], _ = _run(cfg_p, shape_name, run_mesh,
                                        grad_accum=1, **kw)
                ext = RL.extrapolate(costs[2], costs[4], cfg.num_layers)
                cost["per_layer_flops"] = (
                    (costs[4] - costs[2]).scaled(0.5 / per).flops)
                cost["extrapolated"] = _cost_dict(ext, per)
        return total, memory, cost

    try:
        if placed:
            try:
                total, result["memory"], result["cost"] = measure(True)
            except NotImplementedError as e:
                placed, reason = False, f"the placed step refuses it: {e}"
                records.clear()
        if not placed:
            total, result["memory"], result["cost"] = measure(False)
    except Exception as e:
        result["status"] = "FAIL"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            _print_cell(result)
        return result
    result["placed"] = placed
    if placed:
        result["collectives"] = _collective_rows(records)
    else:
        result["collectives"] = None
        result["collectives_reason"] = (
            "not placed: this cell runs the whole program on one process "
            "and calls no collective; " + reason)
    result["status"] = "OK"
    per = 1 if placed else chips
    terms = RL.roofline_terms(total.scaled(1.0 / per), chips)
    mf = RL.model_flops(cfg, shape_name)
    terms["model_flops"] = mf
    terms["useful_ratio"] = (mf / terms["hlo_flops_global"]
                             if terms["hlo_flops_global"] else 0.0)
    result["roofline"] = terms
    if verbose:
        _print_cell(result)
    return result


def rank_step(cfg, mesh_shape: tuple, seq: int) -> tuple:
    """(the :class:`~repro_torch.launch.roofline.CellCost`, the (record,
    mesh axis) pairs of its collectives) of rank 0's training step of
    ``cfg`` on one row of ``seq`` tokens a data rank: the f32 state placed
    on ``meta`` by ``param_specs`` and ZeRO-1 on a (data, model)
    :func:`~repro_torch.launch.mesh.fake_mesh` of ``mesh_shape``, the
    step bf16 compute, remat and z-loss 1e-4 (what a rank of
    ``chip_smoke.py``'s tensor-parallel phase runs)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import (abstract_state,
                                                 make_train_step)

    with fake_mesh(mesh_shape, ("data", "model")) as mesh:
        lm = logical(mesh)
        opt = AdamW(lr=1e-4)
        state = abstract_state(cfg, opt)
        state = SH.place_state(state, mesh, SH.state_specs(
            cfg, state, lm, SH.param_specs(cfg, state.params, lm)),
            device="meta")
        batch = {k: torch.zeros((1, seq), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
        records: list = []
        _, cost = count(make_train_step(cfg, opt, remat=True, z_loss=1e-4),
                        (state, batch), records, axes_of(mesh))
    return cost, records


def _print_rank_step(arch: str, layers: int) -> None:
    """:func:`rank_step` of ``arch`` cut to ``layers`` on the smoke's
    (data 2, model 2) mesh and 1024 tokens a data rank: its FLOPs and each
    (kind, dtype, mesh axis) of collective with its calls and output bytes
    a step."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    cost, records = rank_step(cfg, (2, 2), 1024)
    print(f"{arch}, {layers} layers, a rank of (2, 2): "
          f"{cost.flops / 1e12:.4f} TFLOP")
    rows: dict = {}
    for rec, axis in records:
        key = (rec.kind, str(rec.dtype).split(".")[-1], axis)
        n, b = rows.get(key, (0, 0))
        rows[key] = (n + 1, b + rec.dtype.itemsize * math.prod(rec.shape))
    for (kind, dtype, axis), (n, b) in sorted(rows.items()):
        print(f"  {kind} ({dtype}) on {axis}: {n} calls, {b / 1e9:.4f} GB")


def _print_cell(r: dict) -> None:
    tag = f"{r['arch']} × {r['shape']}" + (" [multi-pod]" if r["multi_pod"]
                                           else "")
    if r["status"] != "OK":
        print(f"{tag}: {r['status']} {r.get('error', '')}")
        return
    mem = r["memory"]
    t = r["roofline"]
    temp = ("" if mem["temp_bytes"] is None
            else f"gathered={mem['temp_bytes'] / 1e9:.3f}GB ")
    print(f"{tag}: OK meta={r['run_s']:.1f}s {temp}"
          f"hbm>={mem['hbm_fraction'] * 100:.1f}% (H100) | "
          f"compute={t['compute_s'] * 1e3:.2f}ms "
          f"memory={t['memory_s'] * 1e3:.2f}ms "
          f"coll={t['collective_s'] * 1e3:.2f}ms "
          f"dominant={t['dominant']} useful={t['useful_ratio']:.2f}",
          flush=True)


def all_cells():
    for arch in ARCH_NAMES:
        for shape_name in SHAPE_SPECS:
            yield arch, shape_name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--moe-impl", default="dense",
                    choices=["dense", "ragged", "local"])
    ap.add_argument("--qcache", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank-step", nargs="+", metavar="ARCH:LAYERS",
                    help="print a rank's training step of chip_smoke.py's "
                    "tensor-parallel phase instead (rank_step)")
    args = ap.parse_args(argv)
    if args.rank_step:
        for spec in args.rank_step:
            arch, layers = spec.split(":")
            _print_rank_step(arch, int(layers))
        return

    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    results = []
    for arch, shape_name in cells:
        meshes = ([False, True] if args.both_meshes
                  else [args.multi_pod])
        for mp in meshes:
            results.append(run_cell(
                arch, shape_name, multi_pod=mp, probe=not args.no_probe,
                moe_impl=args.moe_impl, qcache=args.qcache))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        keyed = {(r["arch"], r["shape"], r["multi_pod"]): r
                 for r in existing}
        for r in results:
            keyed[(r["arch"], r["shape"], r["multi_pod"])] = r
        with open(args.out, "w") as f:
            json.dump(list(keyed.values()), f, indent=1)
    ok = sum(r["status"] == "OK" for r in results)
    skip = sum(r["status"].startswith("SKIP") for r in results)
    fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n=== dry-run: {ok} OK, {skip} skipped, {fail} failed "
          f"of {len(results)} cells")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
