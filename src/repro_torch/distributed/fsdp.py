"""Per-use gathers of a placed training state: the reference's ZeRO-2/FSDP
layout, where each weight is gathered where a layer uses it and each
gradient is reduce-scattered as it is made.

Port-only.  The reference constrains the bf16 compute copy and the
gradients to the data-sharded layout (``repro.training.train_step``'s
``zero_specs``) and XLA places the collectives.  Here the placed step of
:func:`repro_torch.training.train_step.make_train_step` hands the model
each rank's f32 blocks and installs a :class:`Plan` (:func:`installed`);
the model reaches every weight through :func:`use` (or :func:`use_tree`
for a layer's blocks) at its use site, which runs :class:`UseSite`:

* forward: the f32 block cast to the compute dtype, then gathered over
  the data mesh dims that split it
  (:func:`~repro_torch.distributed.sharding.gather_block`); a split on the
  model axis stays local;
* backward: the gathered gradient summed in f32 over the data mesh dims
  into the rank's block
  (:func:`~repro_torch.distributed.sharding.scatter_sum`, widening it in
  the copy the reduce-scatter takes), returned as the gradient of the
  f32 block, so the sum is never rounded to bf16.

A layer's blocks are gathered inside the function that remat
checkpoints, so its recomputation gathers them again.  A stacked
``(L, ...)`` leaf is handed over as L separate leaves (its local block
unbound), and each layer's reduced gradient is added into the rank's
``(L, ...)`` f32 buffer by a hook as the backward makes it
(:class:`Plan`).  Without a plan installed :func:`use` returns its
input: serving, unplaced training and every other call are unchanged.

The autograd engine runs a backward's nodes in reverse order of their
creation, so every rank reduce-scatters the same leaves in the same order
(the last layer's before the recomputation of the one below it) whatever
a rank-dependent branch does between them.

:func:`metered` counts the gathered bytes alive at once (each gathered
block until it is freed): the dry-run's ``temp_bytes`` of a placed train
cell, and the high-water mark the tests and ``chip_smoke.py`` hold.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import Shard

from repro_torch.distributed import sharding as SH


class Site(NamedTuple):
    """How one f32 block reaches its use: its leaf's ``name`` (a layer's
    ``layers/<i>/<leaf>``), the ``group`` gathered together with it (a
    layer's ``layers/<i>``, or the leaf's own name), the mesh and the
    block's placements on it, the mesh dims to gather over (``gather``)
    and to sum the gradient over (``reduce``; none for a leaf whole over
    the data axes, whose gradient the step all-reduces once), the compute
    dtype it is cast to (None: kept), and ``kept``: gathered once for the
    whole step (a stacked leaf split on its layer dim)."""
    name: str
    group: str
    mesh: Any
    placements: tuple
    gather: tuple
    reduce: tuple
    dtype: Optional[torch.dtype]
    kept: bool = False


class UseSite(torch.autograd.Function):
    """A block at its use site: cast and gathered forward, its gradient
    reduce-scattered in f32 backward (the module docstring)."""

    @staticmethod
    def forward(ctx, local, site):
        ctx.site = site
        x = local if site.dtype is None else local.to(site.dtype)
        out = SH.gather_block(x, site.mesh, site.placements, site.gather)
        if _METER is not None and site.gather:
            _METER.gathered(site, out)
        return out

    @staticmethod
    def backward(ctx, g):
        s = ctx.site
        return SH.scatter_sum(g, s.mesh, s.placements, s.reduce,
                              torch.float32), None


_PLAN: Optional["Plan"] = None


def use(x):
    """``x`` at its use site: through :class:`UseSite` where the installed
    plan names it, as it is otherwise (no plan, a tensor the plan does not
    hold, a dict of quantized blocks)."""
    plan = _PLAN
    if plan is None or not isinstance(x, torch.Tensor):
        return x
    got = plan.sites.get(id(x))
    if got is None or got[0] is not x:
        return x
    return UseSite.apply(x, got[1])


def use_tree(tree: dict) -> dict:
    """:func:`use` on every tensor of a (nested) dict: one layer's
    blocks, gathered together."""
    return {k: use_tree(v) if isinstance(v, dict) else use(v)
            for k, v in tree.items()}


@contextmanager
def installed(plan: "Plan"):
    """``plan`` installed for the block, the previous one after it.  A
    module global, not a thread's: the backward (and remat's
    recomputation in it) may run on another thread than the forward."""
    global _PLAN
    prev, _PLAN = _PLAN, plan
    try:
        yield plan
    finally:
        _PLAN = prev


def _shift(placements: tuple) -> tuple:
    """A stacked leaf's placements as one layer's block has them: each
    split dim one lower (the layer dim gone)."""
    return tuple(Shard(q.dim - 1) if q.is_shard() else q
                 for q in placements)


class Plan:
    """The per-use form of one placed state for one step.

    ``flat``: the state's params (``DTensor`` leaves) in ``pytree`` order,
    ``paths`` their names; ``dims``: the mesh dims of the data axes;
    ``dtypes``: each leaf's compute dtype (None: kept as it is).  Each
    leaf's local block becomes the autograd leaves the model reads (L of
    them for a stacked ``layers/`` leaf split on a dim past its first),
    each with a :class:`Site` where it must be cast or gathered, and a
    hook that adds its gradient into its part of the leaf's f32 buffer
    of the rank's block (``grads``, zeros until the backward adds) and
    drops it."""

    def __init__(self, flat, paths, mesh, dims, dtypes):
        self.sites: dict = {}
        self.stacks: list = []  # (index, leaf, site) gathered whole once
        self.pieces: list = []
        self.grads = [torch.zeros(p.to_local().shape, dtype=torch.float32,
                                  device=p.to_local().device) for p in flat]
        for i, (p, path, dtype, buf) in enumerate(
                zip(flat, paths, dtypes, self.grads)):
            split = tuple(d for d in dims if p.placements[d].is_shard())
            local = p.to_local().detach()
            if path.startswith("layers/") and split and any(
                    p.placements[d].dim == 0 for d in split):
                # Split on the layer dim: no layer has a block of its own.
                site = Site(path, path, mesh, tuple(p.placements), split,
                            tuple(dims), dtype, kept=True)
                self.stacks.append((i, self._leaf(local, buf), site))
                self.pieces.append(None)
                continue
            reduce = tuple(dims) if split else ()
            if path.startswith("layers/"):
                name = path.split("/", 1)[1]
                pieces = tuple(
                    self._leaf(x, b, Site(f"layers/{j}/{name}",
                                          f"layers/{j}", mesh,
                                          _shift(p.placements), split,
                                          reduce, dtype))
                    for j, (x, b) in enumerate(zip(local.unbind(0),
                                                   buf.unbind(0))))
            else:
                pieces = self._leaf(local, buf, Site(
                    path, path, mesh, tuple(p.placements), split, reduce,
                    dtype))
            self.pieces.append(pieces)

    def _leaf(self, x, buf, site: Optional[Site] = None):
        leaf = x.requires_grad_()

        def add(t, buf=buf):
            buf.add_(t.grad)
            t.grad = None

        leaf.register_post_accumulate_grad_hook(add)
        if site is not None and (site.gather or site.dtype is not None):
            self.sites[id(leaf)] = (leaf, site)
        return leaf

    def tree(self) -> list:
        """The leaves the model reads, in ``pytree`` order (a stacked leaf
        a tuple of its layers).  A stacked leaf split on its layer dim is
        gathered whole here, for the whole forward and backward: called
        under grad mode, once a micro-batch."""
        leaves = list(self.pieces)
        for i, leaf, site in self.stacks:
            leaves[i] = UseSite.apply(leaf, site).unbind(0)
        return leaves


class Meter:
    """The gathered bytes alive at once: ``live`` now, ``peak`` the most
    so far; ``groups``: the bytes of each group gathered together (a
    layer's blocks, the embedding, the head), each leaf counted once;
    ``kept``: the groups gathered once for the whole step."""

    def __init__(self):
        self.live = self.peak = 0
        self.leaves: dict = {}
        self.kept: set = set()

    def gathered(self, site: Site, out: torch.Tensor) -> None:
        n = out.numel() * out.element_size()
        self.live += n
        self.peak = max(self.peak, self.live)
        self.leaves.setdefault(site.group, {})[site.name] = n
        if site.kept:
            self.kept.add(site.group)
        weakref.finalize(out, self._freed, n)

    def _freed(self, n: int) -> None:
        self.live -= n

    @property
    def groups(self) -> dict:
        return {g: sum(v.values()) for g, v in self.leaves.items()}

    def bound(self) -> int:
        """The high-water mark the per-use form allows: the two largest
        groups gathered at a use site, and every group kept for the
        step."""
        sizes = self.groups
        use = sorted((n for g, n in sizes.items() if g not in self.kept),
                     reverse=True)
        return sum(use[:2]) + sum(sizes[g] for g in self.kept)


_METER: Optional[Meter] = None


@contextmanager
def metered():
    """A :class:`Meter` counting every :class:`UseSite` gather in the
    block."""
    global _METER
    prev, _METER = _METER, Meter()
    try:
        yield _METER
    finally:
        _METER = prev
