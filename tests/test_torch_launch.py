"""The launch dry-run and roofline on the port, against ``repro.launch``.

On the CPU, with the duck-typed fake meshes of ``test_torch_sharding.py``
(16 x 16 and the multi-pod (2, 16, 16)): ``model_flops`` for every arch
and shape; ``pick_grad_accum`` for every arch's ``train_4k`` on both
meshes; ``build_cell``'s partition trees and donated arguments for every
cell on the 16 x 16 mesh and two archs on the multi-pod one (trailing
Nones dropped on both sides: the port writes one entry a dimension);
``roofline_terms`` against the reference's formula with the H100's
constants in place of the v5e's; ``collective_wire_bytes`` over records
against the reference's parser over HLO lines built from the same
records; ``extrapolate`` of the meta counts at 2 and 4 layers against the
full-depth count (full width); a reduced prefill's FLOP and byte counts
on ``meta`` equal to those on CPU tensors; ``run_cell`` on ``meta``.
The pure data-parallel train cells' collectives (one device's ZeRO step
on a fake process group) against the ring formulas over their spec trees;
the tensor-parallel train cells' (yi-6b, olmoe-1b-7b, depth cut)
model-axis collectives against the counts their layer structure gives,
a rank's step of the smoke's tensor-parallel phase (``rank_step``), and
llama4-scout's cell left unplaced with its reason.  Then training's
launch pieces: ``abstract_state`` against the reference's
``jax.eval_shape``, ``make_train_step(zero_specs=)`` on one process equal
to the step without it, a state the tensor-parallel path cannot train
refused, and remat with and without the saved ``"tp_out"`` products
against the reference's gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget
from repro.distributed import ctx as JCTX
from repro.launch import dryrun as JDR
from repro.launch import roofline as JRL
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro.training import optim as JO
from repro.training import train_step as JS
from repro_torch.configs import get_config
from repro_torch.distributed import ctx as TCTX
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as LM
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TT
from repro_torch.models.config import SHAPE_SPECS
from repro_torch.training import optim as TO
from repro_torch.training import pytree
from repro_torch.training import train_step as TS
from test_torch_sharding import MESH, MESH_MP, MESHES
from test_torch_training import Z, hold, setup, torch_grads

CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPE_SPECS]
# The tensor-parallel train cells' depth in their dry-run test.
TP_CELL_LAYERS = 2


@pytest.fixture(autouse=True)
def _reset_launch_state():
    """``build_cell`` installs a sharding context and the remat policy's
    switch in both packages: put both back after each test."""
    yield
    JCTX.set_ctx(None)
    TCTX.set_ctx(None)
    JT.set_remat_save_tp(True)
    TT.set_remat_save_tp(True)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_reference(arch, shape):
    np.testing.assert_allclose(RL.model_flops(get_config(arch), shape),
                               JRL.model_flops(jget(arch), shape),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_pick_grad_accum_equals_reference(arch, mesh):
    m = MESHES[mesh]
    assert (DR.pick_grad_accum(get_config(arch), "train_4k", m)
            == JDR.pick_grad_accum(jget(arch), "train_4k", m))


def _strip(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _ref_flat(spec_tree):
    return [_strip(s) for s in jax.tree.leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, P))]


def _port_flat(tree):
    """The port's partitions in the reference's leaf order: dict keys
    sorted, tuple fields in order, a plain tuple a partition."""
    if type(tree) is tuple:
        return [_strip(tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_flat(tree[k])]
    return [s for kid in tree for s in _port_flat(kid)]


@pytest.mark.parametrize("arch,shape,mesh",
                         [(a, s, "16x16") for a, s in CELLS]
                         + [(a, s, "pod") for a in ("tinyllama-1.1b",
                                                    "olmoe-1b-7b")
                            for s in SHAPE_SPECS])
def test_build_cell_specs_equal_reference(arch, shape, mesh):
    m = MESHES[mesh]
    _, _, jin, jout, jdonate = JST.build_cell(jget(arch), shape, m)
    _, args, tin, tout, tdonate = ST.build_cell(get_config(arch), shape, m)
    assert tdonate == jdonate
    assert len(tin) == len(jin) and len(tout) == len(jout)
    for got, want in zip(tin + tout, jin + jout):
        assert _port_flat(got) == _ref_flat(want)
    assert all(t.device.type == "meta" for t in pytree.leaves(args))
    assert TT.REMAT_SAVE_TP == JT.REMAT_SAVE_TP


def test_roofline_terms_equal_reference_formula(monkeypatch):
    for name, value in (("PEAK_FLOPS_BF16", LM.PEAK_FLOPS_BF16),
                        ("HBM_BW", LM.HBM_BW), ("ICI_BW", LM.NVLINK_BW)):
        monkeypatch.setattr(JRL, name, value)
    for flops, nbytes, coll in ((4.3e13, 1.8e12, {}),
                                (1e9, 3e12, {"all-reduce": 5e11}),
                                (2e15, 1e10, {"all-gather": 1e9,
                                              "all-to-all": 2e9})):
        coll = {k: coll.get(k, 0.0) for k in RL.KINDS}
        got = RL.roofline_terms(RL.CellCost(flops, nbytes, coll), 256)
        want = JRL.roofline_terms(JRL.CellCost(flops, nbytes, coll), 256)
        assert got == want


_HLO_TYPES = {torch.bfloat16: "bf16", torch.float32: "f32",
              torch.int8: "s8", torch.int32: "s32"}


def _hlo_line(i, rec):
    dims = ",".join(map(str, rec.shape))
    ty = f"{_HLO_TYPES[rec.dtype]}[{dims}]"
    groups = ("" if rec.kind == "collective-permute" else
              ", replica_groups={{" + ",".join(map(str, range(rec.group)))
              + "}}")
    return f"  c.{i} = {ty}{{0}} {rec.kind}({ty} %p.{i}){groups}"


def test_collective_wire_bytes_equal_reference_parser():
    recs = [RL.Collective(kind, dt, shape, n)
            for kind in RL.KINDS
            for dt, shape, n in ((torch.bfloat16, (16, 2048), 16),
                                 (torch.float32, (256,), 2),
                                 (torch.int8, (4, 8, 32), 1),
                                 (torch.int32, (3,), 256))]
    want = JRL.collective_wire_bytes(
        "\n".join(_hlo_line(i, r) for i, r in enumerate(recs)))
    assert RL.collective_wire_bytes(recs) == pytest.approx(want, rel=1e-12)
    for kind in RL.KINDS:  # each kind alone
        one = [r for r in recs if r.kind == kind]
        assert RL.collective_wire_bytes(one)[kind] == pytest.approx(
            JRL.collective_wire_bytes("\n".join(
                _hlo_line(i, r) for i, r in enumerate(one)))[kind],
            rel=1e-12)
        assert RL.collective_wire_bytes(one)[kind] > 0
    assert RL.collective_wire_bytes([]) == {k: 0.0 for k in RL.KINDS}


def test_extrapolate_equals_reference():
    c2 = (3e12, 4e11, {"all-reduce": 2e9})
    c4 = (5e12, 7e11, {"all-reduce": 3e9})
    got = RL.extrapolate(RL.CellCost(*c2), RL.CellCost(*c4), 22)
    want = JRL.extrapolate(JRL.CellCost(*c2), JRL.CellCost(*c4), 22)
    assert (got.flops, got.bytes_accessed, got.coll_bytes) == (
        want.flops, want.bytes_accessed, want.coll_bytes)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_probe_extrapolates_to_the_full_depth_count(arch):
    """At full width every layer of these two is the same kind, so the
    L2/L4 probe's extrapolation is the full-depth count; and the cell's
    pure data parallelism needs no microbatching."""
    r = DR.run_cell(arch, "train_4k", verbose=False)
    assert r["status"] == "OK" and r["dp_only"], r.get("error")
    cost = r["cost"]
    assert cost["extrapolated"]["flops_per_device"] == cost[
        "flops_per_device"]
    assert cost["per_layer_flops"] * get_config(arch).num_layers < cost[
        "flops_per_device"]
    assert DR.pick_grad_accum(get_config(arch), "train_4k",
                              LM.make_production_mesh()) == 1


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m",
                                  "gemma2-2b", "hymba-1.5b"])
def test_meta_counts_equal_cpu_counts(arch):
    """A reduced prefill counted on ``meta`` stand-ins and on CPU tensors
    of the same shapes: the same FLOPs and bytes (the kernel wrappers send
    both to the plain versions)."""
    cfg = get_config(arch, reduced=True)
    B, S = 2, 24

    def fn(params, batch):
        logits, cache = TT.prefill(cfg, params, batch, max_len=S + 8)
        return TT.greedy_token(cfg, logits), cache

    counts = []
    for device in ("meta", "cpu"):
        params = TT.init_params(cfg, 0, torch.bfloat16, device=device)
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                       device=device)}
        out, cost = DR.count(fn, (params, batch))
        assert out[0].device.type == device
        counts.append((cost.flops, cost.bytes_accessed))
    assert counts[0] == counts[1] and counts[0][0] > 0


def _nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_kernel_calls_count_their_inputs_and_outputs(device):
    """The byte count takes a kernel wrapper's plain version as the
    card's kernel: inputs read once, outputs written once, none of the
    plain version's S x T scores; the training forward adds each row's
    log-sum-exp, and the backward reads q, k, v, out, dout and lse and
    writes dq, dk, dv.  The scan likewise."""
    from repro_torch.kernels import ops

    B, S, H, KV, D = 2, 64, 4, 2, 16
    q = torch.zeros((B, S, H, D), device=device)
    k = torch.zeros((B, S, KV, D), device=device)
    lse = 4 * B * H * S
    _, cost = DR.count(lambda q, k: ops.flash_attention(q, k, k), (q, k))
    assert cost.bytes_accessed == _nb(q, k, k, q)

    def train(q, k, v):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*qkv)
        return torch.autograd.grad(out, qkv, torch.ones_like(out))

    # the clones and the output gradient, outside the kernels
    _, base = DR.count(lambda q, k, v: [t.clone() for t in (q, k, v)]
                       + [torch.ones_like(q)], (q, k, k))
    _, cost = DR.count(train, (q, k, k))
    fwd = _nb(q, k, k, q) + lse
    bwd = _nb(q, k, k, q, q) + lse + _nb(q, k, k)
    assert cost.bytes_accessed - base.bytes_accessed == fwd + bwd

    x = torch.zeros((B, S, H, D), device=device)
    dt = torch.zeros((B, S, H), device=device)
    A, Dk = torch.zeros(H, device=device), torch.zeros(H, device=device)
    Bm = torch.zeros((B, S, 1, 8), device=device)
    _, cost = DR.count(lambda *a: ops.ssd_scan(*a, chunk=16),
                       (x, dt, A, Bm, Bm, Dk))
    assert cost.bytes_accessed == _nb(x, dt, A, Bm, Bm, Dk, x)


@pytest.mark.parametrize("arch,shape", [
    ("tinyllama-1.1b", "train_4k"), ("mamba2-780m", "long_500k"),
    ("gemma2-2b", "prefill_32k"), ("olmoe-1b-7b", "decode_32k")])
def test_run_cell_on_meta(arch, shape):
    r = DR.run_cell(arch, shape, probe=False, verbose=False)
    assert r["status"] == "OK", r.get("error")
    t, mem = r["roofline"], r["memory"]
    assert t["compute_s"] > 0 and t["memory_s"] > 0
    if r["placed"]:  # the pure data-parallel train cell: a device's step
        assert r["collectives"] and t["collective_s"] > 0
    else:  # serving: the whole program, no collective called
        assert r["collectives"] is None and "A13" in r[
            "collectives_reason"]
        assert t["collective_s"] == 0.0
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"],
                               t["collective_s"])
    assert mem["argument_bytes"] > 0
    if r["placed"]:  # the step's gathered high-water mark, a lower bound
        assert mem["temp_bytes"] > 0 and "temp_bytes" in mem["lower_bounds"]
        assert "gathered" in mem["temp_reason"]
    else:
        assert mem["temp_bytes"] is None
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 - mem["alias_bytes"]
                                 + (mem["temp_bytes"] or 0))
    np.testing.assert_allclose(t["model_flops"],
                               JRL.model_flops(jget(arch), shape))


def test_run_cell_skips_and_fails_as_the_reference():
    assert (DR.run_cell("tinyllama-1.1b", "long_500k")["status"]
            == "SKIP(full-attn)")
    # The ragged MoE runs on meta (its group sizes an even split there), as
    # the reference's ragged_dot compiles over traced sizes.
    r = DR.run_cell("olmoe-1b-7b", "decode_32k", probe=False,
                    moe_impl="ragged", verbose=False)
    assert r["status"] == "OK", r.get("error")
    # A layer's three expert products count 3 * 2 T K D F FLOPs whatever
    # the split; the router 2 T D E beside them.
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import layers as TL

    cfg = get_config("olmoe-1b-7b")
    lp = TT._layer(TT.abstract_params(cfg)["layers"], 0)
    T, (E, D, F), K = 37, lp["we_g"].shape, cfg.num_experts_per_tok
    x = torch.empty((1, T, D), dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as fc:
        TL.moe_ffn(cfg, lp, x, impl="ragged")
    assert not cfg.num_shared_experts
    assert fc.get_total_flops() == 2 * T * D * E + 3 * 2 * T * K * D * F


def test_train_cell_memory_from_the_spec_trees():
    """The pure data-parallel train cell's state is ZeRO-sharded over all
    256 devices, donated, and aliased to the new state."""
    cfg = get_config("tinyllama-1.1b")
    r = DR.run_cell("tinyllama-1.1b", "train_4k", probe=False,
                    verbose=False)
    mem = r["memory"]
    state_bytes = 3 * 4 * cfg.param_count()  # f32 params, mu, nu
    assert state_bytes / 256 < mem["alias_bytes"] < state_bytes / 200
    assert mem["output_bytes"] == pytest.approx(mem["alias_bytes"], abs=8)
    # one row of 4096 tokens and labels per device
    assert mem["argument_bytes"] - mem["alias_bytes"] == 2 * 4096 * 4


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_state_equals_reference(arch):
    comp = arch == "tinyllama-1.1b"
    want = jax.tree.leaves(JS.abstract_state(jget(arch), JO.AdamW(),
                                             jnp.float32, compression=comp))
    got = pytree.leaves(TS.abstract_state(get_config(arch), TO.AdamW(),
                                          torch.float32, compression=comp))
    assert [(tuple(t.shape), str(t.dtype).split(".")[1], t.device.type)
            for t in got] == [(tuple(w.shape), str(w.dtype), "meta")
                              for w in want]


def test_zero_specs_step_equals_plain_step():
    cfg = get_config("tinyllama-1.1b", reduced=True)
    _, _, _, tparams, _, tb = setup("tinyllama-1.1b")
    opt = TO.AdamW(lr=1e-3)
    specs = SH.param_specs(cfg, tparams, MESH_MP, dp_axes=("pod", "data"))
    plain = TS.make_train_step(cfg, opt)(TS.state_from_params(tparams, opt),
                                         tb)
    zero = TS.make_train_step(cfg, opt, zero_specs=specs)(
        TS.state_from_params(tparams, opt), tb)
    for a, b in zip(pytree.leaves(plain), pytree.leaves(zero)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_zero_specs_refuse_a_state_placed_across_devices():
    """A state split on the model axis that the tensor-parallel path
    cannot train (an SSM model; a leaf split otherwise than
    ``param_specs`` splits it) raises, naming ROADMAP A13, before any
    collective.  Compression on a placed state trains (its numbers are
    ``tests/test_torch_tp_train.py``'s): rank 0's step of a ``meta`` state
    placed over both axes returns its error accumulator placed as its
    params."""
    cfg = get_config("tinyllama-1.1b", reduced=True)
    opt = TO.AdamW()
    state = TS.init_state(cfg, 0, opt, device="cpu")
    ssm = get_config("mamba2-780m", reduced=True)
    ssm_state = TS.init_state(ssm, 0, opt, device="cpu")
    with LM.fake_mesh((2, 2), ("data", "model")) as mesh:
        lm = SH.logical(mesh)
        tp = SH.state_specs(ssm, ssm_state, lm, SH.param_specs(
            ssm, ssm_state.params, lm))
        assert any("model" in str(sp) for sp in _port_flat(tp.params))
        step = TS.make_train_step(ssm, opt, zero_specs=tp.params)
        with pytest.raises(NotImplementedError,
                           match="SSM blocks.*ROADMAP A13"):
            step(SH.place_state(ssm_state, mesh, tp), {})
        pspecs = SH.param_specs(cfg, state.params, lm)
        assert pspecs["layers"]["wq"] == (None, None, "model")
        pspecs["layers"]["wq"] = (None, "model", None)  # its rows instead
        odd = SH.state_specs(cfg, state, lm, pspecs)
        with pytest.raises(NotImplementedError,
                           match="param_specs' layout.*ROADMAP A13"):
            TS.make_train_step(cfg, opt)(SH.place_state(state, mesh, odd),
                                         {})
        comp = TS.abstract_state(cfg, opt, compression=True)
        dp = SH.state_specs(cfg, comp, lm, pytree.tree_map(
            lambda p: (None,) * p.dim(), comp.params),
            dp_axes=("data", "model"))
        step = TS.make_train_step(cfg, opt, compression=True,
                                  dp_axes=("data", "model"))
        new, _ = step(SH.place_state(comp, mesh, dp, device="meta"), {
            k: torch.zeros((1, 8), dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")})
        for p, e in zip(pytree.leaves(new.params),
                        pytree.leaves(new.comp.error)):
            assert e.placements == p.placements and e.shape == p.shape
        assert any(e.placements[0].is_shard()
                   for e in pytree.leaves(new.comp.error))
    assert not dist.is_initialized()


def _gathers(path, spec, cfg) -> int:
    """How often a step gathers a leaf split over the data axes, a
    micro-batch: a layer's block twice (the forward and remat's
    recomputation), a stacked leaf split on its layer dim once (gathered
    whole before the layers), a tied embedding twice (the lookup and the
    head), any other leaf once."""
    if path[0] == "layers":
        return 1 if spec[0] is not None else 2
    return 2 if path[0] == "embed" and cfg.tie_embeddings else 1


def _zero_wire_bytes(arch):
    """The pure data-parallel train cell's wire bytes a device by kind,
    from its spec trees on the 16 x 16 mesh and the ring formulas: each
    f32 matrix's bf16 copy gathered over the devices that split it at each
    use (:func:`_gathers`) and its f32 gradient reduce-scattered over them
    as often, each block all-reduced over every mesh axis that does not
    split it; then the loss's metrics and the gradient norm's sum of
    squares, all-reduced over each axis."""
    cfg = get_config(arch)
    _, args, in_specs, _, _ = ST.build_cell(cfg, "train_4k", MESH)
    out = {k: 0.0 for k in RL.KINDS}
    state, specs = args[0].params, in_specs[0].params
    for spec, (path, leaf) in zip(
            pytree.flatten(specs, is_leaf=lambda x: type(x) is tuple)[0],
            pytree.flatten_with_path(state)[0]):
        n = SH._divisor(spec, MESH)
        used = {a for e in spec if e for a in (e if isinstance(e, tuple)
                                               else (e,))}
        cast = leaf.dtype == torch.float32 and leaf.dim() >= 2
        uses = _gathers(path, spec, cfg) if n > 1 else 1
        reduced = 1 if path[0] == "layers" else uses
        out["all-gather"] += (uses * (n - 1) / n * (2 if cast else 4)
                              * leaf.numel())
        out["reduce-scatter"] += reduced * (n - 1) / n * 4 * leaf.numel()
        for a in MESH.axis_names:
            if a not in used:
                m = MESH.shape[a]
                out["all-reduce"] += (reduced * 2 * (m - 1) / m * 4
                                      * leaf.numel() / n)
    small = get_config(arch, reduced=True)
    batch = {k: torch.zeros((1, 8), dtype=torch.int32)
             for k in ("tokens", "labels")}
    metrics = TT.loss_fn(small, TT.init_params(small, 0, device="cpu"),
                         batch)[1]
    for a in MESH.axis_names:
        m = MESH.shape[a]
        out["all-reduce"] += 2 * (m - 1) / m * 4 * (len(metrics) + 1)
    return out


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_pure_dp_cell_prices_its_collectives(arch):
    """The pure data-parallel train cell runs one device's ZeRO step on
    the fake 16 x 16 mesh, each weight gathered at its use: wire bytes by
    kind equal the spec trees' formula (about 255/256 of 6 bytes a
    parameter, 2 more a layer parameter, remat's regather, and 6 more a
    parameter of a tied embedding, its second use),
    ``collective_s`` is them over NVLink's rate, FLOPs a device equal the
    whole program's over 256, and a device reads whole weights for its one
    row, so its bytes exceed the whole program's over 256.  Its
    ``temp_bytes``, the gathered high-water mark, is at least a layer's
    bf16 blocks and less than the whole bf16 copy.  No process group is
    left."""
    r = DR.run_cell(arch, "train_4k", probe=False, verbose=False)
    assert not dist.is_initialized()
    assert r["status"] == "OK" and r["placed"], r.get("error")
    got = {k: 0.0 for k in RL.KINDS}
    for row in r["collectives"]:
        got[row["kind"]] += row["wire_bytes"]
    want = _zero_wire_bytes(arch)
    for kind in RL.KINDS:
        assert got[kind] == pytest.approx(want[kind], rel=1e-9, abs=0), kind
    total = sum(want.values())
    cfg = get_config(arch)
    params = cfg.param_count()
    abstract = TT.abstract_params(cfg)
    layer = sum(p.numel() for p in pytree.leaves(abstract["layers"]))
    tied = abstract["embed"].numel() if cfg.tie_embeddings else 0
    assert total == pytest.approx(
        255 / 256 * (6 * params + 2 * layer + 6 * tied), rel=2e-3)
    temp = r["memory"]["temp_bytes"]
    assert 2 * layer / cfg.num_layers <= temp < 2 * params
    assert r["cost"]["coll_bytes_per_device"] == pytest.approx(total,
                                                                rel=1e-9)
    assert r["roofline"]["collective_s"] == pytest.approx(
        total / LM.NVLINK_BW, rel=1e-9)
    fn, args, *_ = ST.build_cell(get_config(arch), "train_4k",
                                 LM.make_production_mesh())
    _, whole = DR.count(fn, args)
    assert r["cost"]["flops_per_device"] == whole.flops / 256
    assert r["cost"]["bytes_per_device"] > whole.bytes_accessed / 256


def test_pure_dp_cell_unplaced_prices_the_one_process_program():
    """``placed=False`` prices the program a one-card run of the cell
    executes (``build_cell`` on the LogicalMesh): the whole program's
    counts over 256, no collective, and the reason why."""
    r = DR.run_cell("tinyllama-1.1b", "train_4k", probe=False,
                    verbose=False, placed=False)
    assert not dist.is_initialized()
    assert r["status"] == "OK" and r["dp_only"] and not r["placed"]
    assert r["collectives"] is None and "placed" in r["collectives_reason"]
    fn, args, *_ = ST.build_cell(get_config("tinyllama-1.1b"), "train_4k",
                                 LM.make_production_mesh())
    _, whole = DR.count(fn, args)
    assert r["cost"]["flops_per_device"] == whole.flops / 256
    assert r["cost"]["bytes_per_device"] == whole.bytes_accessed / 256
    assert r["roofline"]["collective_s"] == 0


def _tp_collective_counts(cfg):
    """Model-axis collectives of ``cfg``'s tensor-parallel ``train_4k``
    cell, from its layer structure: (all-reduces, all-gathers).  Each
    micro-batch of ``pick_grad_accum``'s A runs the embedding's all-reduce
    (forward), the LM head input's (backward), and each CE chunk's seven
    (the vocabulary-parallel statistics: the shift's max, the exponentials'
    sum, the label's logit and the argmax's max and min in the forward,
    the first two again in its recomputation; no logits gathered); each
    of the L layers an all-reduce after its attention and its FFN
    (forward; remat's recomputation takes the kept products and runs
    neither, but where ``build_cell`` turns the kept products off, at 5e10
    parameters and more, llama4-scout at full depth, it reruns the
    attention's), one for its q/k/v input (backward), one each for the q and
    k norm weights where the config norms q and k (backward; k's not
    where k is gathered whole); where k and v are gathered whole (more
    ranks than KV heads, yi-6b: 4 of 16; or query heads the axis does not
    divide) each is gathered (forward and recomputation) and all-reduced
    (backward); where the axis does not divide the query heads (llama4's
    40 over 16) q and the attention output are gathered (forward and
    recomputation) and all-reduced (backward); an MoE FFN gathers the
    router's logits (forward and recomputation) and all-reduces the
    tokens' and the gates' gradients (backward), a dense MLP its
    input's.  The gradient norm adds one all-reduce over each mesh axis.

    At full depth, yi-6b: A = 16, L = 32, 8 chunks: 16 (32 x 6 + 2 + 56)
    + 1 = 4001 all-reduces and 16 (32 x 4) = 2048 all-gathers.
    olmoe-1b-7b: A = 4, L = 16: 4 (16 x 7 + 58) + 1 = 681 and 4 (16 x 2)
    = 128.  llama4-scout: A = 16, L = 48, no kept products: 16 (48 x 11 +
    58) + 1 = 9377 and 16 (48 x 10) = 7680."""
    A = DR.pick_grad_accum(cfg, "train_4k", LM.make_production_mesh())
    seq = SHAPE_SPECS["train_4k"][0]
    m = 16
    uneven = cfg.num_heads % m != 0
    whole_kv = cfg.num_kv_heads % m != 0 or uneven
    per_layer_ar, per_layer_ag = 2 + 1, 0
    if cfg.param_count() >= 5e10:  # ST.build_cell: no kept products
        per_layer_ar += 1
    if cfg.qk_norm:
        per_layer_ar += 1 if whole_kv else 2
    if whole_kv:
        per_layer_ar += 2
        per_layer_ag += 4
    if uneven:
        per_layer_ar += 2
        per_layer_ag += 4
    if cfg.is_moe:
        per_layer_ar += 2
        per_layer_ag += 2
    else:
        per_layer_ar += 1
    chunks = seq // TT.CE_CHUNK
    return (A * (cfg.num_layers * per_layer_ar + 2 + 7 * chunks) + 1,
            A * cfg.num_layers * per_layer_ag)


def _data_axis_counts(cfg, pspecs, A) -> tuple:
    """(all-gathers, reduce-scatters) on the data axis of a placed
    tensor-parallel step of ``A`` micro-batches, from the spec tree of its
    params: each use of a leaf split over "data" (:func:`_gathers`) one
    all-gather a micro-batch, each layer's block one reduce-scatter, and
    every other leaf one for each use."""
    ag = rs = 0
    for spec, (path, leaf) in zip(
            pytree.flatten(pspecs, is_leaf=lambda x: type(x) is tuple)[0],
            pytree.flatten_with_path(TT.abstract_params(cfg))[0]):
        if not any(e == "data" or isinstance(e, tuple) and "data" in e
                   for e in spec):
            continue
        uses = _gathers(path, spec, cfg)
        pieces = (cfg.num_layers if path[0] == "layers" and spec[0] is None
                  else 1)
        ag += A * pieces * uses
        rs += A * pieces * (1 if path[0] == "layers" else uses)
    return ag, rs


def _hold_tp_cell(arch, moe_impl, monkeypatch):
    """Rank 0's placed step of ``arch``'s ``train_4k`` cell at
    ``TP_CELL_LAYERS`` (the full cell's mapping and micro-batching) with
    ``moe_impl``, held as :func:`test_tp_train_cell_prices_its_collectives`
    says; returns the record."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=TP_CELL_LAYERS)
    monkeypatch.setattr(DR, "get_config", lambda a: cfg)
    # The mapping and the micro-batching are the full cell's, as run_cell's
    # probes keep the mapping.
    monkeypatch.setattr(DR, "pure_dp", lambda c, *a: ST.pure_dp(full, *a))
    pick = DR.pick_grad_accum
    monkeypatch.setattr(DR, "pick_grad_accum", lambda c, *a: pick(full, *a))
    r = DR.run_cell(arch, "train_4k", probe=False, verbose=False,
                    moe_impl=moe_impl)
    assert not dist.is_initialized()
    assert r["status"] == "OK" and r["placed"], r.get("error")
    assert not r["dp_only"]
    n = {}
    for row in r["collectives"]:
        assert row["group"] == 16
        key = (row["kind"], row["axis"])
        n[key] = n.get(key, 0) + row["count"]
    assert (n[("all-reduce", "model")],
            n[("all-gather", "model")]) == _tp_collective_counts(cfg)
    assert ("reduce-scatter", "model") not in n
    local_vocab = cfg.padded_vocab // 16
    assert not [row for row in r["collectives"] if row["axis"] == "model"
                and row["kind"] == "all-gather"
                and local_vocab in row["shape"]]
    A = DR.pick_grad_accum(full, "train_4k", LM.make_production_mesh())
    assert (n[("all-gather", "data")], n[("reduce-scatter", "data")]) == (
        _data_axis_counts(cfg, ST.build_cell(
            cfg, "train_4k", MESH, moe_impl=moe_impl, dp_only=False)[2][0]
            .params, A))
    assert all(row["dtype"] == ("bfloat16" if row["kind"] == "all-gather"
                                else "float32")
               for row in r["collectives"] if row["axis"] == "data"
               and row["kind"] != "all-reduce")
    total = sum(row["wire_bytes"] for row in r["collectives"])
    assert r["cost"]["coll_bytes_per_device"] == pytest.approx(total,
                                                                rel=1e-9)
    assert r["roofline"]["collective_s"] == pytest.approx(
        total / LM.NVLINK_BW, rel=1e-9)
    return r


@pytest.mark.parametrize("arch,counts", [
    ("yi-6b", (4001, 2048)), ("olmoe-1b-7b", (681, 128)),
    ("llama4-scout-17b-a16e", (9377, 7680))])
def test_tp_train_cell_prices_its_collectives(arch, counts, monkeypatch):
    """yi-6b's, olmoe-1b-7b's and llama4-scout's ``train_4k`` cells (40
    query heads over 16 ranks: 3 or 2 a rank), at full width cut to
    ``TP_CELL_LAYERS`` at the full cell's micro-batching (each count is
    linear in the depth; the full-depth counts are
    :func:`_tp_collective_counts`' formula), run rank 0's
    tensor-parallel step on the fake 16 x 16 group, placed: all-reduces
    and all-gathers on the model axis (a group of 16) in the numbers the
    layer structure gives, none of them a gather of logits (the cross
    entropy reduces each rank's vocabulary columns), the data axis's
    all-gathers of the bf16 shards at each use and reduce-scatters of the
    f32 gradients, in every micro-batch (:func:`_data_axis_counts`), and
    ``collective_s`` their wire bytes over NVLink's rate.  No process
    group is left."""
    assert _tp_collective_counts(get_config(arch)) == counts
    _hold_tp_cell(arch, "dense", monkeypatch)


@pytest.mark.parametrize("impl", ["ragged", "local"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e"])
def test_tp_moe_train_cell_prices_its_collectives(arch, impl, monkeypatch):
    """The routed MoE forms place the MoE cells too: rank 0's step with
    ``moe_impl`` ``ragged`` or ``local`` is ``OK`` and placed, its
    collectives held as the ``dense`` form's (the same counts, from the
    layer structure), and the gates' backward all-reduce moves each
    micro-batch's (T, K) top-K weights, not the (T, E) gates the ``dense``
    form takes in: one a layer and micro-batch."""
    r = _hold_tp_cell(arch, impl, monkeypatch)
    full = get_config(arch)
    A = DR.pick_grad_accum(full, "train_4k", LM.make_production_mesh())
    seq, gbatch, _ = SHAPE_SPECS["train_4k"]
    T = gbatch // 16 // A * seq
    f32 = [row for row in r["collectives"] if row["axis"] == "model"
           and row["kind"] == "all-reduce" and row["dtype"] == "float32"]
    gates = [row["count"] for row in f32
             if row["shape"] == [T, full.num_experts_per_tok]]
    assert gates == [A * TP_CELL_LAYERS]
    assert not [row for row in f32 if row["shape"] == [T, full.num_experts]]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e"])
def test_placed_ragged_layer_counts_its_routed_flops(arch):
    """On ``meta``, a ``ragged`` MoE layer at full width on rank 0 of a
    model axis of 16 (a fake group; its weights the rank's shapes) counts
    its router's columns, 2 T D E / m, its three expert products over
    its share of the slots, 3 · 2 · (T K / m) · D · F (the balanced split
    ``_group_sizes`` gives ``meta``), and the shared expert's columns and
    rows where the config has one, 3 · 2 · T · D · F_shared / m."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import layers as TL

    cfg = get_config(arch)
    m, T = 16, 4096
    D, E, K, F = (cfg.d_model, cfg.num_experts, cfg.num_experts_per_tok,
                  cfg.moe_d_ff)

    def w(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    lp = {"router": w(D, E // m), "we_g": w(E // m, D, F),
          "we_u": w(E // m, D, F), "we_d": w(E // m, F, D)}
    want = 2 * T * D * E // m + 3 * 2 * (T * K // m) * D * F
    if cfg.num_shared_experts:
        Fs = cfg.d_ff // m
        lp.update(ws_g=w(D, Fs), ws_u=w(D, Fs), ws_d=w(Fs, D))
        want += 3 * 2 * T * D * Fs
    with (LM.fake_mesh((m,), ("model",)) as mesh,
          TCTX.tensor_parallel(mesh.get_group(0), 0, m),
          FlopCounterMode(display=False) as flops):
        y = TL.moe_ffn(cfg, lp, w(1, T, D), impl="ragged")
    assert not dist.is_initialized()
    assert y.shape == (1, T, D)
    assert flops.get_total_flops() == want


def test_rank_step_counts_a_ranks_collectives():
    """``rank_step`` (the dry-run of one rank of the smoke's
    tensor-parallel phase) on a (data 2, model 2) fake mesh, reduced
    yi-6b on one row: the model axis's all-reduces as
    :func:`_tp_collective_counts` derives them at A = 1 and one CE chunk
    (2 KV heads split evenly: no k/v gather; the chunk's statistics in
    float32, its argmax index in int64; no gather at all on the model
    axis), and each data-split leaf gathered in bf16 at each use and its
    gradient reduce-scattered in f32 (:func:`_data_axis_counts`).  No
    process group is left."""
    cfg = get_config("yi-6b", reduced=True)
    seq = 16
    cost, records = DR.rank_step(cfg, (2, 2), seq)
    assert not dist.is_initialized() and cost.flops > 0
    n = {}
    for rec, axis in records:
        assert rec.group == 2
        key = (rec.kind, str(rec.dtype).split(".")[-1], axis)
        n[key] = n.get(key, 0) + 1
    assert cfg.num_kv_heads % 2 == 0 and not cfg.qk_norm and not cfg.is_moe
    assert n.pop(("all-reduce", "bfloat16", "model")) == (
        4 * cfg.num_layers + 2)
    assert ("all-gather", "bfloat16", "model") not in n
    with LM.fake_mesh((2, 2), ("data", "model")) as mesh:
        lm = SH.logical(mesh)
        state = TS.abstract_state(cfg, TO.AdamW())
        pspecs = SH.state_specs(cfg, state, lm, SH.param_specs(
            cfg, state.params, lm)).params
    assert (n.pop(("all-gather", "bfloat16", "data")),
            n.pop(("reduce-scatter", "float32", "data"))) == (
        _data_axis_counts(cfg, pspecs, 1))
    # the CE chunk's six; the gradient norm's squares over each axis; the
    # loss and metrics
    assert n.pop(("all-reduce", "float32", "model")) == 6 + 1
    assert n.pop(("all-reduce", "int64", "model")) == 1
    assert set(n) == {("all-reduce", "float32", "data")}


def test_tp_train_cell_unplaced_and_uneven_heads(monkeypatch):
    """``placed=False`` keeps a tensor-parallel cell's unplaced program
    (olmoe-1b-7b: ``build_cell`` on the LogicalMesh, no collective, the
    reason).  A cell whose placed step refuses the state
    (``NotImplementedError``, run here: a gap put into ``tp_train_gaps``
    for llama4-scout, whose uneven query heads now train placed,
    ``test_tp_train_cell_prices_its_collectives``) is priced unplaced,
    its reason the step's, naming the gap.  The unplaced count itself is
    ``test_pure_dp_cell_unplaced_prices_the_one_process_program``'s; only
    the decision and its reason are held here."""
    seen = []
    real = DR._run

    def run(cfg, shape_name, mesh, **kw):
        seen.append(mesh)
        if not isinstance(mesh, SH.LogicalMesh):
            return real(cfg, shape_name, mesh, **kw)
        return RL.CellCost(1.0, 1.0, RL.collective_wire_bytes([])), {
            "hbm_fraction": 0.0}

    monkeypatch.setattr(DR, "_run", run)
    r = DR.run_cell("olmoe-1b-7b", "train_4k", probe=False, verbose=False,
                    placed=False)
    assert r["status"] == "OK" and not r["placed"] and not r["dp_only"]
    assert r["collectives"] is None and "placed=None" in r[
        "collectives_reason"]
    assert r["roofline"]["collective_s"] == 0
    gaps = TT.tp_train_gaps
    monkeypatch.setattr(TT, "tp_train_gaps", lambda cfg, m=None: gaps(
        cfg, m) + (["a gap put here"] if cfg.name.startswith("llama4")
                   else []))
    r = DR.run_cell("llama4-scout-17b-a16e", "train_4k", probe=False,
                    verbose=False)
    assert not dist.is_initialized()
    assert r["status"] == "OK" and not r["placed"] and not r["dp_only"]
    assert [isinstance(m, SH.LogicalMesh) for m in seen] == [True, False,
                                                             True]
    assert r["collectives"] is None
    assert r["roofline"]["collective_s"] == 0
    assert "a gap put here" in r["collectives_reason"]
    assert "ROADMAP A13" in r["collectives_reason"]


@pytest.mark.parametrize("save", [True, False])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_remat_save_tp_grads_match_reference(arch, save):
    """Remat with and without the saved "tp_out" products, in both
    packages: the loss and every gradient leaf at f32."""
    JT.set_remat_save_tp(save)
    TT.set_remat_save_tp(save)
    jcfg, tcfg, jparams, tparams, jb, tb = setup(arch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb, remat=True, z_loss=Z),
        has_aux=True)(jparams)
    tl, _ = TT.loss_fn(tcfg, tparams, tb, remat=True, z_loss=Z)
    np.testing.assert_allclose(float(tl), float(jl), rtol=3e-5, atol=3e-5)
    hold(torch_grads(tcfg, tparams, tb, remat=True), jg,
         what=f"{arch} remat save_tp={save}")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m",
                                  "hymba-1.5b", "olmoe-1b-7b"])
def test_kept_products_give_plain_remat_gradients(arch):
    """The kept "tp_out" products change what is recomputed, not what is
    computed: loss and every gradient leaf bit-equal to plain remat's,
    with every tagged kind (attention, SSM, hybrid, MoE output)."""
    _, tcfg, _, tparams, _, tb = setup(arch)
    got = {}
    for save in (True, False):
        TT.set_remat_save_tp(save)
        got[save] = pytree.flatten(torch_grads(tcfg, tparams, tb,
                                               remat=True))[0]
    assert all(torch.equal(a, b) for a, b in zip(got[True], got[False]))


def test_remat_saves_the_attention_output_projection():
    """Counted on ``meta``: saving the tagged products spares the
    recomputation exactly the attention output projection's forward, the
    one tagged product whose output the backward needs (the MLP's down
    projection only feeds the block's output, so the recomputation stops
    before it either way, as the reference's drops it as dead code)."""
    cfg = get_config("tinyllama-1.1b", reduced=True)
    state = TS.abstract_state(cfg, TO.AdamW())
    B, S = 2, 64
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step = TS.make_train_step(cfg, TO.AdamW())
    flops = {}
    for save in (True, False):
        TT.set_remat_save_tp(save)
        flops[save] = DR.count(step, (state, batch))[1].flops
    hd = cfg.resolved_head_dim
    wo = 2 * B * S * cfg.num_heads * hd * cfg.d_model * cfg.num_layers
    assert flops[False] - flops[True] == wo
