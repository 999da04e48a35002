"""Gradient compression and wire compression for weight staging.

Port of :mod:`repro.distributed.compression`:

* :func:`compress_grads` — int8 symmetric quantization (one absmax scale
  a tensor) with error feedback, applied inside the train step; the
  error accumulator (``CompressionState``, carried in ``TrainState``)
  keeps the long-run bias at zero (EF-SGD).
* :func:`wire_compression_ratio` — the contract for
  ``LoaderSpec(compress="int8")``: host→device streams ship the int8
  payload plus per-group scales instead of full-width leaves, so a load's
  virtual transfer time shrinks by exactly this ratio while the resident
  footprint is unchanged.

The reference's ``compressed_psum`` (an int8 all-reduce across devices)
is ROADMAP A10.
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


def _q_dq(x: torch.Tensor) -> torch.Tensor:
    """Quantize to int8 and back (per-tensor absmax scale)."""
    scale = torch.clamp_min(x.abs().max(), 1e-12) / _QMAX
    return torch.clamp(torch.round(x / scale), -_QMAX - 1, _QMAX) * scale


def compress_grads(grads: PyTree, state: CompressionState
                   ) -> Tuple[PyTree, CompressionState]:
    """EF-compression: g' = Q(g + e);  e' = (g + e) − g'.  Tensors of
    fewer than 2 dims pass through uncompressed, their error zeroed."""
    def one(g, e):
        corrected = g.float() + e
        if g.ndim < 2:  # tiny tensors: not worth compressing
            return corrected, torch.zeros_like(e)
        out = _q_dq(corrected)
        return out, corrected - out

    flat_g, structure = pytree.flatten(grads)
    outs = [one(g, e) for g, e in zip(flat_g, pytree.leaves(state.error))]
    return (pytree.unflatten(structure, [o[0] for o in outs]),
            CompressionState(error=pytree.unflatten(
                structure, [o[1] for o in outs])))


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
