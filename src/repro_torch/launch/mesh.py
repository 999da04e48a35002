"""Mesh construction over ``torch.distributed``, and the card's constants.

Port of :mod:`repro.launch.mesh`.  :func:`make_mesh` is the counterpart
of ``make_mesh_compat``: a ``DeviceMesh`` with named dims over the
current process group (which the caller has initialised with its own
address, world size and rank).  :func:`make_production_mesh` returns a
:class:`~repro_torch.distributed.sharding.LogicalMesh` of the production
shape: the spec rules only read ``mesh.shape``, and the port places no
shards across cards.  Nothing touches a device when the module is
imported.
"""
from __future__ import annotations

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


def data_axes(mesh) -> tuple:
    names = (getattr(mesh, "axis_names", None)
             or tuple(mesh.mesh_dim_names))
    return tuple(a for a in names if a in ("pod", "data"))
