"""Sharding rules: every parameter, batch, cache and optimizer leaf mapped
to a partition on the production mesh, and logical meshes for serving.

Port of :mod:`repro.distributed.sharding`.  A partition (:data:`Spec`) is
a tuple with one entry a tensor dimension: None (replicated), a mesh axis
name, or a tuple of axis names (the dimension split over their product,
the first axis major), exactly as the reference's ``PartitionSpec``.  The
spec functions walk the port's templates on the ``meta`` device
(:func:`repro_torch.models.transformer.abstract_params`,
:func:`~repro_torch.models.transformer.abstract_cache`,
:func:`repro_torch.launch.specs.batch_specs_for`), so no weight is ever
allocated (llama4-scout at full width is 107.8 B parameters), and return
trees of the same structure.  :func:`named` turns a spec tree into
``DTensor`` placements on a ``DeviceMesh``.  The rules only read
``mesh.shape[name]``, so a :class:`LogicalMesh` serves them without
devices.  :func:`place_tree` places a serving tree on a ``DeviceMesh``
with each rank copying only its own slice to its device, and
:func:`rank_nbytes` reports the bytes each rank then holds.  A placed
tensor changes its layout through :func:`redistribute` (:func:`whole`,
:func:`summed`), which runs the process group's own collectives.  A
training state is placed by :func:`place_state`; the ZeRO step moves a
block to its whole at each use and the use's gradient to the block with
:func:`gather_block` and :func:`scatter_sum`, plain tensors in and out
(:mod:`repro_torch.distributed.fsdp`).

Scheme (Megatron-style tensor parallelism on the ``model`` axis):
column-parallel in-projections, row-parallel out-projections, experts
sharded on their expert dimension, data parallelism over ``data`` (and
``pod``), sequence sharding for long-context caches; every rule checks
divisibility and replicates a leaf that does not divide.  With ``fsdp``
(training) a 1-D shard still above ``_FSDP_THRESHOLD`` bytes also splits
over the data axes.  :func:`leaf_spec`, the serving layout of one leaf,
is that same rule with ``fsdp=False``.  The serving side's
:func:`weight_shard_fraction` sums bytes in the reference's leaf order
(dict keys sorted), so a fraction equals the reference's bit for bit: a
last-bit difference would move a per-device budget, and with it a sim
trail.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.training import pytree

PyTree = Any
# Weights whose *input* (K) dim is sharded: the row-parallel halves of each
# Megatron pair.  Everything else 2-D prefers column (output/N) sharding.
_ROW_PARALLEL = ("wo", "wd", "ws_d", "ssm_out")

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# 1-D (TP-only) shards above this per-device size get a second axis
# (fully-sharded compute weights): without it the 103B-param MoE tenant's
# bf16 compute copy alone is 12.9 GB a device.
_FSDP_THRESHOLD = 64 * 1024 * 1024


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def _dp(mesh, dp_axes: Tuple[str, ...]) -> Tuple[int, Entry]:
    """(size, entry) of the data axes: one axis by its name, several as
    their tuple."""
    size = 1
    for a in dp_axes:
        size *= mesh.shape[a]
    return size, (dp_axes if len(dp_axes) > 1 else dp_axes[0])


def _is_spec(x) -> bool:
    """A partition, as opposed to a tree node (NamedTuples are nodes)."""
    return type(x) is tuple


def spec_map(fn, spec_tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the partitions of ``spec_tree`` and the matching
    subtrees of each tree in ``rest``: ``jax.tree.map`` with
    ``PartitionSpec`` a leaf."""
    return pytree.tree_map(fn, spec_tree, *rest, is_leaf=_is_spec)


def _with_paths(fn, tree: PyTree) -> PyTree:
    """``fn(path, leaf)`` over ``tree``, keeping its structure; ``path``
    joins the keys with ``/``."""
    return pytree.tree_map_with_path(
        lambda path, leaf: fn("/".join(map(str, path)), leaf), tree)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _param_rule(path: str, shape: Tuple[int, ...], mesh, model_axis: str,
                dp_axes: Tuple[str, ...], fsdp: bool) -> Spec:
    """The partition of one parameter leaf (``path`` joins dict keys with
    ``/``): the reference's ``param_specs`` rule.  A quantized leaf's ``q``
    takes its weight's rule; its scales ``s`` (..., G, N) shard N like
    ``q`` and never the group axis."""
    m = mesh.shape[model_axis]
    parts = path.split("/")
    in_layers = parts[0] == "layers"
    shape = tuple(shape)

    def maybe_2d(base: list) -> list:
        """The data axes on the largest free divisible dim, when the 1-D
        shard is still huge (MoE expert stacks; f32 bytes).  Train-only:
        at serve time 2-D weights force per-layer gathers."""
        if not fsdp:
            return base
        n = 4
        for d in shape:
            n *= d
        if n // m < _FSDP_THRESHOLD:
            return base
        dp_size, dp_spec = _dp(mesh, dp_axes)
        cands = [i for i in range(len(shape))
                 if base[i] is None and _div(shape[i], dp_size)]
        if cands:
            base[max(cands, key=lambda i: shape[i])] = dp_spec
        return base

    def spec_for(name: str) -> list:
        nd = len(shape)
        lead = 1 if in_layers else 0  # stacked L dim
        base: list = [None] * nd
        if in_layers and nd - lead <= 1:
            return base  # per-layer vectors: replicate
        if name == "embed":  # (Kcb, Vp, D)
            if _div(shape[1], m):
                base[1] = model_axis
            return maybe_2d(base)
        if name == "head":  # (Kcb, D, Vp)
            if _div(shape[2], m):
                base[2] = model_axis
            return maybe_2d(base)
        if name in ("meta", "final_norm"):
            return base
        if name.startswith("we_"):  # (L, E, D, F): shard experts
            if _div(shape[1], m):
                base[1] = model_axis
            elif _div(shape[-1], m):
                base[-1] = model_axis
            return maybe_2d(base)
        if nd - lead == 2:  # (L, K, N) linear weights
            k_dim, n_dim = nd - 2, nd - 1
            row_first = any(name.startswith(r) for r in _ROW_PARALLEL)
            for d in ((k_dim, n_dim) if row_first else (n_dim, k_dim)):
                if _div(shape[d], m):
                    base[d] = model_axis
                    break
            return maybe_2d(base)
        return base

    if parts[-1] in ("q", "s"):
        sp = spec_for(parts[-2])
        if parts[-1] == "s":
            sp[len(shape) - 2] = None  # row-parallel q: scales replicate
        return tuple(sp)
    return tuple(spec_for(parts[1] if in_layers else parts[0]))


def param_specs(cfg: ModelConfig, abstract_params: PyTree, mesh, *,
                model_axis: str = "model",
                dp_axes: Tuple[str, ...] = ("data",),
                fsdp: bool = True) -> PyTree:
    """The partition of every leaf of ``abstract_params`` (plain or
    quantized, any device, ``meta`` included), as a tree of its
    structure."""
    return _with_paths(
        lambda path, leaf: _param_rule(path, tuple(leaf.shape), mesh,
                                       model_axis, dp_axes, fsdp),
        abstract_params)


def leaf_spec(path: str, shape: Tuple[int, ...], mesh, *,
              model_axis: str = "model") -> Spec:
    """The serving partition of one parameter leaf: :func:`param_specs`'s
    rule with ``fsdp=False`` (so no data axis is read)."""
    return _param_rule(path, shape, mesh, model_axis, ("data",), False)


# ---------------------------------------------------------------------------
# Batches, caches, optimizer state
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, batch_abstract: PyTree, mesh, *,
                dp_axes: Tuple[str, ...] = ("data",)) -> PyTree:
    """Every batch leaf split on its leading (batch) dim over the data
    axes, where it divides."""
    dp_size, dp_spec = _dp(mesh, dp_axes)

    def visit(path, leaf):
        base: list = [None] * leaf.dim()
        if leaf.dim() >= 1 and _div(leaf.shape[0], dp_size):
            base[0] = dp_spec
        return tuple(base)

    return _with_paths(visit, batch_abstract)


def cache_specs(cfg: ModelConfig, cache_abstract: PyTree, mesh, *,
                dp_axes: Tuple[str, ...] = ("data",),
                model_axis: str = "model") -> PyTree:
    """The decode cache: batch over the data axes, KV heads (else the
    sequence) over ``model``; a batch that does not divide (long context,
    one sequence) shards the sequence over the data axes and ``model``
    together."""
    m = mesh.shape[model_axis]
    dp_size, dp_spec = _dp(mesh, dp_axes)

    def kv(shape, nd):  # (L, B, T, KV[, hd])
        sp: list = [None] * nd
        B, T, KV = shape[1], shape[2], shape[3]
        b_sharded = _div(B, dp_size)
        if b_sharded:
            sp[1] = dp_spec
        if _div(KV, m):
            sp[3] = model_axis
        elif not b_sharded and _div(T, dp_size * m):
            sp[2] = tuple(dp_axes) + (model_axis,)  # long-context seq
        elif _div(T, m):
            sp[2] = model_axis
        return tuple(sp)

    def visit(path, leaf):
        name = path.split("/")[0]
        shape = tuple(leaf.shape)
        if name == "lengths":  # (B,)
            return (dp_spec if _div(shape[0], dp_size) else None,)
        if name in ("k", "v", "k_scale", "v_scale"):
            return kv(shape, len(shape))
        if name == "state":  # (L, B, nh, hd, N)
            sp: list = [None] * 5
            if _div(shape[1], dp_size):
                sp[1] = dp_spec
            if _div(shape[2], m):
                sp[2] = model_axis
            return tuple(sp)
        if name == "conv":  # (L, B, W-1, convd)
            sp = [None] * 4
            if _div(shape[1], dp_size):
                sp[1] = dp_spec
            if _div(shape[3], m):
                sp[3] = model_axis
            return tuple(sp)
        return (None,) * len(shape)

    return _with_paths(visit, cache_abstract)


def zero1_specs(abstract_tree: PyTree, spec_tree: PyTree, mesh, *,
                dp_axes: Tuple[str, ...] = ("data",)) -> PyTree:
    """ZeRO-1: also shard the f32 master and optimizer leaves over the
    data axes on their largest free divisible dim (the combined data axes
    first, then each free one alone), so that the big MoE tenants'
    master copy and moments drop by the data-parallel degree."""
    dp_size, dp_spec = _dp(mesh, dp_axes)

    def augment(spec, leaf):
        shape = tuple(leaf.shape)
        if len(shape) < 2:
            return spec
        dims = list(spec)
        used = {a for d in dims if d is not None
                for a in (d if isinstance(d, tuple) else (d,))}
        if used & set(dp_axes):
            return spec  # already fully sharded (FSDP 2-D weights)
        attempts = [(dp_spec, dp_size)] + [(a, mesh.shape[a])
                                           for a in dp_axes if a not in used]
        for ax_spec, ax_size in attempts:
            cands = [i for i in range(len(shape))
                     if dims[i] is None and _div(shape[i], ax_size)]
            if cands:
                dims[max(cands, key=lambda i: shape[i])] = ax_spec
                return tuple(dims)
        return spec

    return spec_map(augment, spec_tree, abstract_tree)


def state_specs(cfg: ModelConfig, abstract_state, mesh,
                param_spec_tree: PyTree, *, zero1: bool = True,
                dp_axes: Tuple[str, ...] = ("data",)):
    """A ``TrainState`` of partitions: the optimizer state mirrors the
    parameter sharding (with ZeRO-1 over the data axes for the f32 master
    copy and both AdamW moments); the step is replicated."""
    from repro_torch.training.train_step import TrainState

    master = (zero1_specs(abstract_state.params, param_spec_tree, mesh,
                          dp_axes=dp_axes) if zero1 else param_spec_tree)
    return TrainState(
        params=master,
        opt=type(abstract_state.opt)(step=(), mu=master, nu=master),
        comp=None if abstract_state.comp is None else CompState_spec(master))


def CompState_spec(param_spec_tree: PyTree):
    """The error-feedback accumulator sharded as the parameters."""
    from repro_torch.distributed.compression import CompressionState

    return CompressionState(error=param_spec_tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------
class NamedSharding(NamedTuple):
    """A partition on a ``torch.distributed`` ``DeviceMesh`` (with
    ``mesh_dim_names``): what :func:`named` gives a leaf, and what
    :func:`repro_torch.distributed.checkpoint.restore` and
    :func:`repro_torch.distributed.elastic.reshard` place with."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a ``DTensor`` on this mesh with these placements: a
        ``DTensor`` of this mesh is redistributed (:func:`redistribute`),
        one of another mesh gathered whole first (:func:`whole`), a plain
        tensor split (every rank of the mesh calls it, with the same
        value)."""
        from torch.distributed.tensor import distribute_tensor

        if is_placed(t):
            if t.device_mesh == self.mesh:
                return redistribute(t, self.placements)
            t = whole(t)
        return distribute_tensor(t.to(self.mesh.device_type), self.mesh,
                                 list(self.placements))


def is_placed(t) -> bool:
    """Whether ``t`` is a ``DTensor`` (a leaf or an activation placed
    across ranks)."""
    return isinstance(t, DTensor)


def local_block(t) -> torch.Tensor:
    """A placed tensor's own block; a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def like_placed(ref, local: torch.Tensor):
    """``local`` as this rank's block of a tensor placed as ``ref`` is (its
    mesh, placements, shape and stride); plain where ``ref`` is plain."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def as_dtensor(t, mesh):
    """``t``, a plain tensor taken as replicated on ``mesh``; a
    ``DTensor`` or None as it is."""
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def redistribute(x, target) -> torch.Tensor:
    """``x`` (a ``DTensor``) redistributed to the placements ``target``
    with the process group's own collectives: a partial sum reduced
    (``all_reduce``), a split gathered (:func:`gather_block`), then any
    split of a whole taken locally.  ``DTensor.redistribute`` gathers
    through the functional all-gather, which crashes on gloo with CUDA
    tensors (torch 2.11; two ranks sharing one card, where NCCL refuses
    to run), so every gather of a placed tensor comes here.  The
    functional all-reduce works, and ``DTensor`` still uses it where an
    operation reduces a partial sum on its own."""
    import torch.distributed as dist

    mesh = x.device_mesh
    cur = list(x.placements)
    local = x.to_local()
    for i, (p, q) in enumerate(zip(cur, target)):
        if p.is_partial() and p != q:
            local = local.clone()
            dist.all_reduce(local, group=mesh.get_group(i))
            cur[i] = Replicate()
    gather = [i for i, (p, q) in enumerate(zip(cur, target))
              if p.is_shard() and p != q]
    local = gather_block(local, mesh, cur, gather)
    for i in gather:
        cur[i] = Replicate()
    x = DTensor.from_local(local.contiguous(), mesh, cur, run_check=False,
                           shape=x.shape, stride=x.stride())
    if tuple(cur) != tuple(target):  # splits of a whole: local slices
        x = x.redistribute(mesh, tuple(target))
    return x


def gather_block(local: torch.Tensor, mesh, placements_,
                 dims=None) -> torch.Tensor:
    """A placed leaf's ``local`` block gathered over the mesh dims
    ``dims`` (every split one by default), as a plain tensor: one
    ``all_gather_into_tensor`` a split mesh dim, the last first, so that a
    tensor dim split over several mesh dims (the first the major one, as
    ``DTensor`` splits it) comes back in order.  A leaf split over one
    mesh axis of two (``zero1_specs``' fallback) gathers over that one."""
    import torch.distributed as dist

    if dims is None:
        dims = [i for i, p in enumerate(placements_) if p.is_shard()]
    for i in sorted(dims, reverse=True):
        d, n = placements_[i].dim, mesh.size(i)
        moved = local.movedim(d, 0).contiguous()
        out = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
        dist.all_gather_into_tensor(out, moved, group=mesh.get_group(i))
        local = out.movedim(0, d)
    return local.contiguous()


def scatter_sum(whole: torch.Tensor, mesh, placements_, dims,
                dtype=None) -> torch.Tensor:
    """The conjugate of :func:`gather_block`: ``whole`` (each rank's term
    of a sum, at the leaf's full shape) summed over the ranks of the mesh
    dims ``dims`` into this rank's block of ``placements_``, as a plain
    tensor: a ``reduce_scatter_tensor`` over each split mesh dim of
    ``dims`` (the first first), then an ``all_reduce`` of the block over
    each replicated one.  Mesh dims outside ``dims`` are left alone.  The
    sum runs in ``dtype`` (``whole``'s where None): ``whole`` is widened
    in the contiguous copy the first reduction makes anyway, not in a
    copy of its own."""
    import torch.distributed as dist

    x = whole
    for i in dims:
        if placements_[i].is_shard():
            d, n = placements_[i].dim, mesh.size(i)
            moved = x.movedim(d, 0).to(dtype or x.dtype,
                                       memory_format=torch.contiguous_format)
            out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
            dist.reduce_scatter_tensor(out, moved, group=mesh.get_group(i))
            x = out.movedim(0, d)
    x = x.to(dtype or x.dtype, memory_format=torch.contiguous_format)
    rest = [i for i in dims if not placements_[i].is_shard()]
    if rest and x is whole:
        x = x.clone()
    all_reduce_dims(x, mesh, rest)
    return x


def all_reduce_dims(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``t`` summed in place over the ranks of each mesh dim in ``dims``
    (one ``all_reduce`` each): over all of them together."""
    import torch.distributed as dist

    for i in dims:
        dist.all_reduce(t, group=mesh.get_group(i))
    return t


def whole(x) -> torch.Tensor:
    """A placed tensor gathered whole on every rank, as a plain tensor."""
    return redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()


def summed(y, dtype) -> torch.Tensor:
    """A row-parallel product's float32 partial sums (``Partial()``)
    added over the ranks (an all-reduce), then rounded once to ``dtype``:
    each rank's partial rounded to bf16 before the sum would round twice
    where one card's product rounds once."""
    pl = [Replicate() if p.is_partial() else p for p in y.placements]
    return redistribute(y, pl).to(dtype)


def placements(mesh, spec: Spec) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim whose axis the spec puts on tensor dim ``d``, ``Replicate()``
    elsewhere.  An entry of several axes must name them in the mesh's
    order (the first the major one, as in the reference), the order in
    which ``DTensor`` splits a dim over several mesh dims.  An axis the
    mesh does not have splits nothing (a serving mesh of one data shard
    has no data axis, :func:`logical`)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical(mesh) -> "LogicalMesh":
    """The :class:`LogicalMesh` of a ``DeviceMesh`` (its dims by name),
    which the spec rules read; a mesh without a data axis (a serving mesh
    of one data shard) has a data axis of 1 there."""
    return LogicalMesh({"data": 1,
                        **dict(zip(mesh.mesh_dim_names, mesh.shape))})


def _local_box(shape: Tuple[int, ...], mesh, placements_: tuple):
    """(offsets, sizes) of this rank's block of a leaf of ``shape`` split
    evenly by ``placements_``: each mesh dim in order splits what the ones
    before it left, as ``DTensor`` does."""
    off, size = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if p.is_shard():
            d = p.dim
            if size[d] % mesh.size(i):
                raise ValueError(f"dim {d} of {shape} does not split "
                                 f"evenly over mesh dim {i}")
            size[d] //= mesh.size(i)
            off[d] += coord[i] * size[d]
    return off, size


def place(t: torch.Tensor, mesh, spec: Spec, device=None,
          non_blocking: bool = False) -> torch.Tensor:
    """``t`` (on the host) as a ``DTensor`` on ``mesh`` with partition
    ``spec``, made from this rank's slice alone: only that slice is copied
    to ``device`` (the mesh's device type by default), and no collective
    runs.  :meth:`NamedSharding.place` moves the whole leaf to the device
    and scatters it from rank 0 instead.  The block never shares ``t``'s
    storage (a slice of a leaf already on ``device`` is copied), so
    dropping ``t`` frees it."""
    pl = placements(mesh, spec)
    off, size = _local_box(tuple(t.shape), mesh, pl)
    local = t
    for d, (o, n) in enumerate(zip(off, size)):
        if n != t.shape[d]:
            local = local.narrow(d, o, n)
    local = local.to(device or mesh.device_type, non_blocking=non_blocking)
    local = (local.clone(memory_format=torch.contiguous_format)
             if local.device == t.device else local.contiguous())
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def place_tree(tree: PyTree, mesh, spec_tree: PyTree, device=None,
               non_blocking: bool = False) -> PyTree:
    """Every leaf of ``tree`` placed by :func:`place` with the partition of
    ``spec_tree`` at the same place."""
    return spec_map(lambda spec, t: place(t, mesh, spec, device,
                                          non_blocking), spec_tree, tree)


def zeros_placed(shape: Tuple[int, ...], dtype, mesh, spec: Spec,
                 device=None) -> torch.Tensor:
    """A zeroed ``DTensor`` of ``shape`` with partition ``spec``: each
    rank allocates its own block only."""
    pl = placements(mesh, spec)
    _, size = _local_box(tuple(shape), mesh, pl)
    local = torch.zeros(size, dtype=dtype,
                        device=device or mesh.device_type)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def place_state(state, mesh, sspecs, device=None):
    """A ``TrainState`` placed on ``mesh`` by :func:`state_specs`' tree
    ``sspecs``: params, both AdamW moments (and an error accumulator) by
    :func:`place`, each rank copying only its own slice to ``device``;
    the step replicated.  A ``meta`` state placed with ``device="meta"``
    gives the dry-run a device's own blocks."""
    from repro_torch.training.train_step import TrainState

    opt = state.opt
    return TrainState(
        params=place_tree(state.params, mesh, sspecs.params, device),
        opt=type(opt)(
            step=place(opt.step, mesh, sspecs.opt.step, device),
            mu=place_tree(opt.mu, mesh, sspecs.opt.mu, device),
            nu=place_tree(opt.nu, mesh, sspecs.opt.nu, device)),
        comp=None if state.comp is None else type(state.comp)(
            error=place_tree(state.comp.error, mesh,
                             sspecs.comp.error, device)))


def local_nbytes(tree: PyTree) -> int:
    """Bytes this rank holds of ``tree``: a ``DTensor`` leaf's local
    block, a plain leaf whole."""
    total = 0
    for leaf in pytree.leaves(tree):
        local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        total += local.numel() * local.element_size()
    return total


def rank_nbytes(tree: PyTree, group=None) -> list:
    """:func:`local_nbytes` of every rank of ``group`` (the default
    process group), in rank order; every rank calls it."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, local_nbytes(tree), group=group)
    return out


def named(mesh, spec_tree: PyTree) -> PyTree:
    """Each partition of ``spec_tree`` as a :class:`NamedSharding` on
    ``mesh`` (a ``DeviceMesh``)."""
    return spec_map(lambda s: NamedSharding(mesh, s), spec_tree)


def _divisor(spec: Spec, mesh) -> int:
    """How many ways a leaf with partition ``spec`` is split on ``mesh``."""
    div = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            div *= mesh.shape[ax]
    return div


# ---------------------------------------------------------------------------
# Logical meshes and per-device weight footprints (serving-side accounting)
# ---------------------------------------------------------------------------
class LogicalMesh:
    """A shape mapping + axis names, nothing more.

    The spec rules above only read ``mesh.shape[name]``, so serving-side
    accounting (per-device memory ledgers, shard-size math) runs them
    without any device: a sharded sim run, or a sharded mesh served from
    one card, needs no second card."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axes must be >= 1: {self.shape}")

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape})"


def serving_mesh(mesh_shape: Tuple[int, ...]) -> LogicalMesh:
    """The serving stack's mesh convention: a 1-D shape is pure tensor
    parallelism (``("model",)``); a 2-D shape is ``("data", "model")``."""
    if len(mesh_shape) == 1:
        return LogicalMesh({"model": mesh_shape[0]})
    if len(mesh_shape) == 2:
        return LogicalMesh({"data": mesh_shape[0], "model": mesh_shape[1]})
    raise ValueError(
        f"serving mesh_shape must be 1-D or 2-D, got {mesh_shape}")


def weight_shard_fraction(cfg: ModelConfig, mesh, *,
                          model_axis: str = "model",
                          dtype=None) -> float:
    """Fraction of a tenant's weight bytes resident on ONE device of the
    mesh: sharded leaves contribute ``1/m`` of their bytes per
    model-slice, replicated leaves (norms, odd-width projections that
    don't divide the axis) a full copy.  Always ``>= 1/mesh.size`` — the
    excess is the replication overhead a per-device memory ledger must
    budget for.  Model slices are symmetric, so one fraction describes
    every device.  ``dtype`` (bf16 by default) is the weights'; the
    initializer keeps some vectors in f32, as the reference's does."""
    from repro_torch.models import transformer as T

    abstract = T.abstract_params(cfg, dtype or torch.bfloat16)
    total = 0
    per_device = 0.0
    for path, leaf in pytree.flatten_with_path(abstract)[0]:
        path = "/".join(map(str, path))
        nbytes = leaf.numel() * leaf.element_size()
        spec = leaf_spec(path, tuple(leaf.shape), mesh,
                         model_axis=model_axis)
        total += nbytes
        per_device += nbytes / _divisor(spec, mesh)
    return per_device / total if total else 1.0


def variant_shard_mb(size_mb: float, n_devices: int,
                     fraction: Optional[float] = None) -> Tuple[float, ...]:
    """Per-device resident MB for one zoo variant staged across
    ``n_devices``: each device holds ``fraction`` of the variant
    (``1/n`` for an ideal even split; :func:`weight_shard_fraction` for
    the real spec-derived figure including replication).  The serving
    loader stages one such shard per device stream."""
    f = (1.0 / n_devices) if fraction is None else fraction
    return tuple(size_mb * f for _ in range(n_devices))
