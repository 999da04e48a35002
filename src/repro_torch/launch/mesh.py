"""Mesh construction over ``torch.distributed``, and the card's constants.

Port of :mod:`repro.launch.mesh`.  :func:`make_mesh` is the counterpart
of ``make_mesh_compat``: a ``DeviceMesh`` with named dims over the
current process group (which the caller has initialised with its own
address, world size and rank).  :func:`make_production_mesh` returns a
:class:`~repro_torch.distributed.sharding.LogicalMesh` of the production
shape (the spec rules only read ``mesh.shape``), and
:func:`fake_production_mesh` a ``DeviceMesh`` of that shape over a fake
process group in this one process, on which the launch dry-run places a
cell's state and runs one device's step.  Nothing touches a device when
the module is imported.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Sequence

from repro_torch.distributed.sharding import LogicalMesh

# One NVIDIA H100 SXM (the card's data sheet; roofline denominators, also
# of chip_smoke.py's bounds).
PEAK_FLOPS_BF16 = 989e12  # the card's dense bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12  # the card's f32 FLOP/s on the CUDA cores
HBM_BW = 3.35e12  # the card's HBM3 bytes/s
NVLINK_BW = 450e9  # the card's NVLink bytes/s each way, to all others
HBM_BYTES = 80 * 10 ** 9  # the card's device memory


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    ranks of the current process group (``device_type`` "cpu" for gloo
    ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    if multi_pod:
        return LogicalMesh({"pod": 2, "data": 16, "model": 16})
    return LogicalMesh({"data": 16, "model": 16})


@contextmanager
def fake_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A CPU ``DeviceMesh`` of ``shape`` with dims named ``axes`` over a
    fake process group of its devices, this process being rank 0:
    collectives on it move nothing, and ``meta`` tensors on it carry rank
    0's shapes.  The group is destroyed on the way out; raises if one is
    already initialized."""
    import math

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the "
                           "fake mesh needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_mesh(shape, axes, "cpu")
    finally:
        dist.destroy_process_group()


def fake_production_mesh(*, multi_pod: bool = False):
    """The production mesh (16 x 16, or 2 x 16 x 16) as a
    :func:`fake_mesh` of its 256 (512) devices."""
    logical = make_production_mesh(multi_pod=multi_pod)
    return fake_mesh(tuple(logical.shape.values()), logical.axis_names)


def data_axes(mesh) -> tuple:
    names = (getattr(mesh, "axis_names", None)
             or tuple(mesh.mesh_dim_names))
    return tuple(a for a in names if a in ("pod", "data"))
