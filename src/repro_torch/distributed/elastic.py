"""Elastic scaling: reshard a running state onto a different mesh.

Port of :mod:`repro.distributed.elastic`.  A pod drops out, or capacity
frees up: the job goes on over the new topology.  Two paths:

* :func:`reshard`: live state onto a new ``DeviceMesh``, each leaf by the
  partitions of a spec tree (:func:`repro_torch.distributed.sharding.
  redistribute`, the process group's own collectives, for a leaf already
  on that mesh, a gather by the same and ``distribute_tensor`` for one on
  another mesh, ``distribute_tensor`` for a plain tensor);
* ``checkpoint.restore(..., shardings=)``: the cold path after a full
  restart.

Both work because all state (params, optimizer, compression error) is
plain trees with mesh-agnostic logical shapes; only the partitions
change.  The data pipeline re-derives rank assignments from the new world
size, and the global batch is kept (the per-rank batch rescales).  Every
rank of the new mesh calls :func:`reshard`.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.distributed import sharding as SH

PyTree = Any


def reshard(tree: PyTree, spec_tree: PyTree, new_mesh) -> PyTree:
    """Every leaf of ``tree`` (a ``DTensor`` or a plain tensor) as a
    ``DTensor`` on ``new_mesh`` with the partition of ``spec_tree`` at the
    same place."""
    return SH.spec_map(
        lambda spec, leaf: None if leaf is None
        else SH.NamedSharding(new_mesh, spec).place(leaf), spec_tree, tree)


def _shape(mesh) -> dict:
    """{axis: size} of a ``DeviceMesh`` (by its dim names) or of a mesh
    that maps names to sizes (a :class:`~repro_torch.distributed.sharding.LogicalMesh`)."""
    if isinstance(mesh.shape, dict):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def validate_elastic_plan(old_mesh, new_mesh, global_batch: int) -> dict:
    """Check that a proposed mesh change keeps the job well-posed: the
    reference's report, key for key."""
    old, new = _shape(old_mesh), _shape(new_mesh)
    old_dp = old.get("data", 1) * old.get("pod", 1)
    new_dp = new.get("data", 1) * new.get("pod", 1)
    return {
        "old_devices": math.prod(old.values()),
        "new_devices": math.prod(new.values()),
        "old_per_rank_batch": global_batch // old_dp,
        "new_per_rank_batch": global_batch // new_dp,
        "ok": global_batch % new_dp == 0,
    }
