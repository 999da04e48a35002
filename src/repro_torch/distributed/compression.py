"""Wire compression for weight staging.

Port of the part of :mod:`repro.distributed.compression` the serving
loaders use: :func:`wire_compression_ratio`, the contract for
``LoaderSpec(compress="int8")`` — host→device streams ship the int8
payload plus per-group scales instead of full-width leaves, so a load's
virtual transfer time shrinks by exactly this ratio while the resident
footprint is unchanged.  Gradient compression is not ported yet.
"""
from __future__ import annotations


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
