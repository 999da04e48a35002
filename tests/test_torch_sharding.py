"""The training sharding rules on the port, against the reference's.

``repro.distributed.sharding``'s spec functions and the port's, on the
same full-width configurations: every arch of ``ARCH_NAMES``, on the
reference's fake 16 x 16 mesh and on the multi-pod (2, 16, 16) mesh
(data axes ``("pod", "data")``).  Each reference ``PartitionSpec``
(trailing Nones written out) must equal the port's tuple exactly:
``param_specs`` with and without ``fsdp``, ``batch_specs`` and
``cache_specs`` over every ``SHAPE_SPECS`` shape (the port's meta
templates from ``repro_torch.launch.specs`` against the reference's
``ShapeDtypeStruct``s), and ``zero1_specs`` / ``state_specs`` over the
f32 training state, with compression.  ``leaf_spec`` equals
``param_specs(fsdp=False)`` leaf for leaf.  Then the five cases of
``tests/test_sharding.py`` on the port, the launch specs' shapes and
types against the reference's, the meshes' constants and axes, and
``ctx.hint`` returning its input.  No devices: the rules read
``mesh.shape`` only.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget
from repro.distributed import sharding as JSH
from repro.launch import specs as JLS
from repro.models import transformer as JT
from repro.training import optim as JO
from repro.training import train_step as JS
from repro_torch.configs import get_config
from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as LM
from repro_torch.launch import specs as LS
from repro_torch.models import transformer as TT
from repro_torch.models.config import SHAPE_SPECS, cell_is_runnable
from repro_torch.training import pytree
from repro_torch.training.optim import AdamW
from repro_torch.training.train_step import state_from_params


class FakeMesh:
    """Duck-typed mesh: shape mapping + axis names (specs are pure)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    @property
    def size(self):
        n = 1
        for v in self.shape.values():
            n *= v
        return n


MESH = FakeMesh({"data": 16, "model": 16})
MESH_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "pod": MESH_MP}


def _paths(tree):
    """(path joined with ``/``, leaf) of every leaf, in the reference's
    leaf order."""
    return [("/".join(map(str, p)), leaf)
            for p, leaf in pytree.flatten_with_path(tree)[0]]


def _dp(mesh):
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _ref_specs(spec_tree, tree):
    """The reference's specs in ``jax.tree``'s leaf order, each written
    out to its leaf's rank."""
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    leaves = jax.tree.leaves(tree)
    assert len(specs) == len(leaves)
    return [tuple(s) + (None,) * (len(l.shape) - len(s))
            for s, l in zip(specs, leaves)]


def _port_specs(tree):
    """The port's specs in the same order: dict keys sorted, tuple fields
    in order, a plain tuple a partition."""
    if type(tree) is tuple:
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_specs(tree[k])]
    return [s for kid in tree for s in _port_specs(kid)]


@functools.lru_cache(maxsize=None)
def _abstract(arch, dtype):
    return (JT.abstract_params(jget(arch), getattr(jnp, dtype)),
            TT.abstract_params(get_config(arch), getattr(torch, dtype)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_reference(arch, fsdp, mesh):
    m = MESHES[mesh]
    jpa, tpa = _abstract(arch, "bfloat16")
    want = _ref_specs(JSH.param_specs(jget(arch), jpa, m, dp_axes=_dp(m),
                                      fsdp=fsdp), jpa)
    got = _port_specs(SH.param_specs(get_config(arch), tpa, m,
                                     dp_axes=_dp(m), fsdp=fsdp))
    assert got == want
    if not fsdp:  # the serving rule is the same rule
        paths = [p for p, _ in _paths(tpa)]
        leaves = [leaf for _, leaf in _paths(tpa)]
        assert [SH.leaf_spec(p, tuple(leaf.shape), m)
                for p, leaf in zip(paths, leaves)] == got


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_equal_reference(arch, mesh):
    m = MESHES[mesh]
    jcfg, tcfg = jget(arch), get_config(arch)
    for shape_name, (_, _, kind) in SHAPE_SPECS.items():
        if not cell_is_runnable(arch, shape_name):
            continue
        if kind == "decode":
            _, jc = JLS.decode_specs_for(jcfg, shape_name)
            _, tc = LS.decode_specs_for(tcfg, shape_name)
            want = _ref_specs(JSH.cache_specs(jcfg, jc, m, dp_axes=_dp(m)),
                              jc)
            got = _port_specs(SH.cache_specs(tcfg, tc, m, dp_axes=_dp(m)))
        else:
            jb = JLS.batch_specs_for(jcfg, shape_name,
                                     with_labels=kind == "train")
            tb = LS.batch_specs_for(tcfg, shape_name,
                                    with_labels=kind == "train")
            want = _ref_specs(JSH.batch_specs(jcfg, jb, m, dp_axes=_dp(m)),
                              jb)
            got = _port_specs(SH.batch_specs(tcfg, tb, m, dp_axes=_dp(m)))
        assert got == want, shape_name


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_state_specs_equal_reference(arch, mesh):
    """ZeRO-1 over the f32 master, both moments and the compression error
    (``state_specs``, which runs ``zero1_specs``), and without ZeRO-1."""
    m = MESHES[mesh]
    jcfg, tcfg = jget(arch), get_config(arch)
    jsa = JS.abstract_state(jcfg, JO.AdamW(lr=1e-4), dtype=jnp.float32,
                            compression=True)
    tsa = state_from_params(TT.abstract_params(tcfg, torch.float32),
                            AdamW(lr=1e-4), compression=True)
    jps = JSH.param_specs(jcfg, jsa.params, m, dp_axes=_dp(m))
    tps = SH.param_specs(tcfg, tsa.params, m, dp_axes=_dp(m))
    for zero1 in (True, False):
        want = _ref_specs(JSH.state_specs(jcfg, jsa, m, jps, zero1=zero1,
                                          dp_axes=_dp(m)), jsa)
        got = _port_specs(SH.state_specs(tcfg, tsa, m, tps, zero1=zero1,
                                         dp_axes=_dp(m)))
        assert got == want, zero1


def _axes_of(spec):
    out = []
    for e in spec:
        if e is not None:
            out.extend(e if isinstance(e, tuple) else (e,))
    return out


def _divides(shape, spec, mesh):
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        n = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= mesh.shape[a]
        if dim % n:
            return False
    return True


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_divisible(arch):
    """Every sharded dim divides exactly, and no mesh axis appears twice
    in one spec (``tests/test_sharding.py`` on the port)."""
    tpa = TT.abstract_params(get_config(arch), torch.bfloat16)
    specs = SH.param_specs(get_config(arch), tpa, MESH)
    for (_, leaf), spec in zip(_paths(tpa), _port_specs(specs)):
        axes = _axes_of(spec)
        assert len(axes) == len(set(axes)), spec
        assert _divides(leaf.shape, spec, MESH), (arch, leaf.shape, spec)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("shape_name", list(SHAPE_SPECS))
def test_cache_and_batch_specs_divisible(arch, shape_name):
    if not cell_is_runnable(arch, shape_name):
        pytest.skip("long-context cell skipped for full-attention arch")
    cfg = get_config(arch)
    kind = SHAPE_SPECS[shape_name][2]
    if kind == "decode":
        _, tree = LS.decode_specs_for(cfg, shape_name)
        specs = SH.cache_specs(cfg, tree, MESH)
    else:
        tree = LS.batch_specs_for(cfg, shape_name,
                                  with_labels=kind == "train")
        specs = SH.batch_specs(cfg, tree, MESH)
    for (_, leaf), spec in zip(_paths(tree), _port_specs(specs)):
        assert _divides(leaf.shape, spec, MESH), (shape_name, spec)


def test_zero1_augments_master_only_free_dims():
    cfg = get_config("yi-6b")
    sa = state_from_params(TT.abstract_params(cfg, torch.float32),
                           AdamW(lr=1e-4))
    ps = SH.param_specs(cfg, sa.params, MESH)
    ss = SH.state_specs(cfg, sa, MESH, ps, zero1=True)
    wq = ss.params["layers"]["wq"]
    axes = _axes_of(wq)
    assert "data" in axes and "model" in axes
    assert len(axes) == len(set(axes))
    assert ss.opt.mu["layers"]["wq"] == wq  # moments mirror the master
    assert ss.opt.step == ()


def test_expert_weights_sharded_on_expert_dim():
    for arch in ("llama4-scout-17b-a16e", "olmoe-1b-7b"):
        cfg = get_config(arch)
        specs = SH.param_specs(cfg, TT.abstract_params(cfg), MESH)
        assert specs["layers"]["we_g"][1] == "model", arch


def test_long_context_cache_seq_sharded():
    """long_500k (batch 1) shards the KV sequence dim, over the data axes
    and ``model`` together."""
    cfg = get_config("gemma2-2b")
    _, cache = LS.decode_specs_for(cfg, "long_500k")
    k = SH.cache_specs(cfg, cache, MESH)["k"]
    assert k[2] is not None
    assert SH.cache_specs(cfg, cache, MESH_MP,
                          dp_axes=("pod", "data"))["k"][2] == (
        "pod", "data", "model")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launch_specs_equal_reference(arch):
    """Every shape name's step inputs: the port's meta tensors have the
    reference's shapes and types (the decode cache's too, int8 KV
    included), and allocate nothing."""
    jcfg, tcfg = jget(arch), get_config(arch)
    for shape_name in SHAPE_SPECS:
        for quantized in (False, True):
            jk, jspecs = JLS.input_specs(jcfg, shape_name, quantized)
            tk, tspecs = LS.input_specs(tcfg, shape_name, quantized)
            assert jk == tk
            jl = jax.tree_util.tree_leaves_with_path(jspecs)
            tl = list(_paths(tspecs))
            assert [JSH._path_str(p) for p, _ in jl] == [p for p, _ in tl]
            for (_, j), (path, t) in zip(jl, tl):
                assert tuple(j.shape) == tuple(t.shape), (shape_name, path)
                assert str(j.dtype) == str(t.dtype).split(".")[1], path
                assert t.device.type == "meta"
    tok = LS.token_spec(tcfg, 3, 7)
    assert tok.dtype == torch.int32 and tok.shape[:2] == (3, 7)


def test_abstract_params_and_cache_match_the_initialisers():
    cfg = get_config("hymba-1.5b", reduced=True)
    real = TT.init_params(cfg, 0, torch.float32, device="cpu")
    meta = TT.abstract_params(cfg, torch.float32)
    assert [(p, tuple(a.shape), a.dtype) for p, a in _paths(real)] == [
        (p, tuple(a.shape), a.dtype) for p, a in _paths(meta)]
    assert all(a.device.type == "meta" for _, a in _paths(meta))
    cache = TT.abstract_cache(cfg, 2, 16)
    want = TT.init_cache(cfg, 2, 16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in want.items()}


def test_meshes_and_constants():
    """The production meshes are logical (the spec rules read their
    shape); the constants are the H100's, not the TPU's."""
    assert LM.make_production_mesh().shape == {"data": 16, "model": 16}
    mp = LM.make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert LM.data_axes(mp) == ("pod", "data")
    assert LM.data_axes(MESH) == ("data",)
    assert (LM.PEAK_FLOPS_BF16, LM.PEAK_FLOPS_F32, LM.HBM_BW,
            LM.NVLINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    assert LM.HBM_BYTES == 80e9


def test_named_placements():
    """A spec's DTensor placements on a named mesh: Shard(d) on each mesh
    dim the spec puts on tensor dim d, in the entry's order; a spec whose
    axes run against the mesh's order raises."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:  # what ``placements`` reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")

    assert SH.placements(Mesh, ("data", None, "model")) == (
        Replicate(), Shard(0), Shard(2))
    assert SH.placements(Mesh, (None, ("pod", "data"))) == (
        Shard(1), Shard(1), Replicate())
    assert SH.placements(Mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        SH.placements(Mesh, (("model", "data"),))
    tree = SH.named(Mesh, {"a": ("data",), "b": {"c": (None, "model")}})
    assert tree["b"]["c"] == SH.NamedSharding(Mesh, (None, "model"))
    assert tree["a"].placements == (Replicate(), Shard(0), Replicate())


def test_hint_returns_its_input():
    x = torch.randn(2, 3)
    assert CTX.hint(x, "dp", "model") is x
    CTX.set_ctx(CTX.ShardCtx(dp_axes=("pod", "data"), model_size=16,
                             dp_size=32, enabled=True))
    try:
        assert CTX.get_ctx().enabled
        assert CTX.get_ctx().dp_spec == ("pod", "data")
        assert CTX.hint(x, "dp", "model") is x
    finally:
        CTX.set_ctx(None)
    assert not CTX.get_ctx().enabled and CTX.get_ctx().dp_spec == "data"


def test_tree_walk_is_jax_tree_with_is_leaf_and_paths():
    """The port's one tree walk against ``jax.tree_util`` on a spec-like
    tree (plain tuples as leaves through ``is_leaf``, NamedTuples and
    None as nodes): the same leaves in the same order, the same key
    paths; a tree mapped beside it needs it only as a prefix, and one of
    another structure raises."""
    from typing import NamedTuple

    class Pair(NamedTuple):
        a: object
        b: object

    tree = {"z": ("data", None), "a": Pair(a=(), b={"y": ("model",),
                                                   "x": None}),
            "m": [("data",), None]}
    pairs, structure = pytree.flatten_with_path(tree, is_leaf=SH._is_spec)
    jpairs, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=SH._is_spec)
    assert [leaf for _, leaf in pairs] == [leaf for _, leaf in jpairs]

    def key(k):
        return getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))

    assert [p for p, _ in pairs] == [
        tuple(key(k) for k in jp) for jp, _ in jpairs]
    assert [p for p, _ in pairs] == [("a", "a"), ("a", "b", "y"),
                                     ("m", 0), ("z",)]
    assert pytree.unflatten(structure, [x for _, x in pairs]) == tree
    other = {"z": Pair(1, 2), "a": Pair(a=3, b={"y": 4, "x": None}),
             "m": [5, None]}
    got = SH.spec_map(lambda s, o: (s, o), tree, other)
    assert got["z"] == (("data", None), Pair(1, 2))
    assert got["a"].b["y"] == (("model",), 4)
    with pytest.raises(ValueError, match="different structure"):
        SH.spec_map(lambda s, o: s, tree, {"z": 1, "a": 2})
