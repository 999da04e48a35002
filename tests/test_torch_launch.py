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
Then training's launch pieces: ``abstract_state`` against the
reference's ``jax.eval_shape``, ``make_train_step(zero_specs=)`` on one
process equal to the step without it, and remat with and without the
saved ``"tp_out"`` products against the reference's gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
    assert t["collective_s"] == 0.0 and r["collectives"] == []
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"])
    assert mem["temp_bytes"] is None and mem["argument_bytes"] > 0
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 - mem["alias_bytes"])
    np.testing.assert_allclose(t["model_flops"],
                               JRL.model_flops(jget(arch), shape))


def test_run_cell_skips_and_fails_as_the_reference():
    assert (DR.run_cell("tinyllama-1.1b", "long_500k")["status"]
            == "SKIP(full-attn)")
    # The ragged MoE reads its group sizes on the host: no value on meta.
    r = DR.run_cell("olmoe-1b-7b", "decode_32k", probe=False,
                    moe_impl="ragged", verbose=False)
    assert r["status"] == "FAIL" and r["error"]


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
    class Placed(torch.Tensor):
        device_mesh = type("Mesh", (), {"size": lambda self: 4})()

    cfg = get_config("tinyllama-1.1b", reduced=True)
    opt = TO.AdamW()
    state = TS.init_state(cfg, 0, opt, device="cpu")
    params = dict(state.params, final_norm=state.params[
        "final_norm"].as_subclass(Placed))
    step = TS.make_train_step(cfg, opt, zero_specs=SH.param_specs(
        cfg, state.params, MESH))
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        step(state._replace(params=params), {})


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
