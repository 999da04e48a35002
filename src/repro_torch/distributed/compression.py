"""Gradient compression and wire compression for weight staging.

Port of :mod:`repro.distributed.compression`:

* :func:`compress_grads` — int8 symmetric quantization (one absmax scale
  a tensor) with error feedback, applied inside the train step; the
  error accumulator (``CompressionState``, carried in ``TrainState``)
  keeps the long-run bias at zero (EF-SGD); gradients and an accumulator
  placed across ranks compressed on each rank's blocks with the whole
  leaf's scale (:func:`compress_block`).
* :func:`compressed_psum` — an all-reduce over a ``torch.distributed``
  group that moves int8 on the wire (the reference's ``shard_map``
  collective); :func:`compressed_allreduce_demo` runs it over the first
  dim of a ``DeviceMesh``.
* :func:`wire_compression_ratio` — the contract for
  ``LoaderSpec(compress="int8")``: host→device streams ship the int8
  payload plus per-group scales instead of full-width leaves, so a load's
  virtual transfer time shrinks by exactly this ratio while the resident
  footprint is unchanged.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.training import pytree

PyTree = Any
_QMAX = 127.0


class CompressionState(NamedTuple):
    error: PyTree  # error-feedback accumulator, same structure as grads

    @classmethod
    def init(cls, params: PyTree) -> "CompressionState":
        return cls(error=pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))


def compress_grads(grads: PyTree, state: CompressionState
                   ) -> Tuple[PyTree, CompressionState]:
    """EF-compression: g' = Q(g + e);  e' = (g + e) − g'.  Tensors of
    fewer than 2 dims pass through uncompressed, their error zeroed.  A
    leaf placed across ranks (a ``DTensor``, its accumulator placed as it
    is) is compressed on each rank's blocks with the whole leaf's scale,
    its max all-reduced over the mesh dims that split the leaf
    (:func:`compress_block`): only ``all_reduce`` runs, and the outputs
    keep the placements."""
    from repro_torch.distributed.sharding import (is_placed, like_placed,
                                                   local_block)

    def one(g, e):
        if not is_placed(g):
            return compress_block(g, e, g.ndim)
        mesh = g.device_mesh
        groups = [mesh.get_group(i) for i, q in enumerate(g.placements)
                  if q.is_shard()]
        out, err = compress_block(local_block(g), local_block(e), g.ndim,
                                  groups)
        return like_placed(g, out), like_placed(e, err)

    flat_g, structure = pytree.flatten(grads)
    outs = [one(g, e) for g, e in zip(flat_g, pytree.leaves(state.error))]
    return (pytree.unflatten(structure, [o[0] for o in outs]),
            CompressionState(error=pytree.unflatten(
                structure, [o[1] for o in outs])))


def compress_block(g: torch.Tensor, e: torch.Tensor, ndim: int,
                   groups=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compress_grads` of one leaf, or of a rank's blocks of it:
    ``g`` of the gradient, ``e`` of the error accumulator (plain tensors),
    quantized to int8 and back with the whole leaf's absmax scale: the
    block's ``max|g + e|`` all-reduced with ``MAX`` over ``groups`` (the
    process groups of the mesh dims that split the leaf; every rank of
    them calls this), exact whatever the split, so each element comes out
    as the whole leaf's compression gives it, bit for bit.  ``ndim`` is
    the whole leaf's: fewer than 2 pass through, the error zeroed.
    Returns (the compressed block, the new error block)."""
    import torch.distributed as dist

    corrected = g.float() + e
    if ndim < 2:
        return corrected, torch.zeros_like(e)
    amax = (corrected.abs().max() if corrected.numel()
            else corrected.new_zeros(())).reshape(1)
    for group in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax[0], 1e-12) / _QMAX
    out = torch.clamp(torch.round(corrected / scale), -_QMAX - 1,
                      _QMAX) * scale
    return out, corrected - out


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (every rank calls it),
    with int8 on the wire: each rank quantizes with its own scale
    ``max(max|x|, 1e-12) / 127``, ``q = clamp(round(x / s), -128, 127)``,
    and all-gathers its int8 payload and its one float32 scale (the
    reference's arithmetic; its ``psum`` of the dequantized values sums
    in an order of XLA's).  Every rank then sums ``q_r * s_r`` in float32
    in rank order, so all hold the same bits.  Returns float32."""
    import torch.distributed as dist

    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / _QMAX
    q = torch.clamp(torch.round(xf / scale), -_QMAX - 1, _QMAX).to(
        torch.int8)
    world = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(world)]
    scales = [torch.empty((1,), dtype=torch.float32, device=x.device)
              for _ in range(world)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(scales, scale.reshape(1), group=group)
    out = torch.zeros_like(xf)
    for qr, sr in zip(qs, scales):
        out += qr.float() * sr
    return out


def compressed_allreduce_demo(values: torch.Tensor, mesh) -> torch.Tensor:
    """``values`` (n k, ...), the same on every rank, split in n blocks
    over the first dim of ``mesh`` (a ``DeviceMesh``); each rank's block
    summed over that dim by :func:`compressed_psum`: (k, ...)."""
    n = mesh.shape[0]
    block = values.chunk(n, dim=0)[mesh.get_local_rank(0)]
    return compressed_psum(block, mesh.get_group(0))


def wire_compression_ratio(bits: int, *, scheme: str = "int8",
                           group: int = 32) -> float:
    """Bytes-on-the-wire ratio for staging a ``bits``-wide variant with
    ``scheme`` compression, as a fraction of the uncompressed transfer.

    The int8 scheme ships 1 byte per element plus one f32 scale per
    group of ``group`` elements along the reduction axis — the exact
    payload layout :func:`repro_torch.quant.quantize.quantize_params`
    produces (per-(K-group, N-column) symmetric scales, ``group=32``)
    and :func:`repro_torch.kernels.quant_matmul.quant_matmul` dequantizes in
    registers on the other end.  A variant already at or below 8 bits gains
    nothing (the payload *is* its resident width), so the ratio clamps
    at 1.0 — compression never makes a transfer slower.

    >>> wire_compression_ratio(16)   # bf16 → int8 payload + scales
    0.5625
    >>> wire_compression_ratio(8)    # already int8-resident: no win
    1.0
    """
    if scheme != "int8":
        raise ValueError(f"unknown wire-compression scheme {scheme!r}")
    wire_bytes = 1.0 + 4.0 / group          # int8 payload + f32 scales
    resident_bytes = bits / 8.0
    return min(1.0, wire_bytes / resident_bytes)
