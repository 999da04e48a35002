"""Model zoos — the paper's per-application repository of NN model variants
at different precision levels (§III-A "Application Tier").

Two constructors:
  * :func:`repro_torch.configs.paper_edge.paper_zoos` — the paper's Table II zoos
    (simulation entities with published sizes/accuracies).
  * :func:`zoo_from_config` — real zoos for the 10 assigned LM architectures,
    with sizes from exact parameter math (``ModelConfig.bytes_for_precision``)
    and accuracy stand-ins from measured quantization fidelity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.models.config import ModelConfig

# Host→HBM staging bandwidth used for TPU cold-start load times (PCIe-class).
HOST_TO_HBM_GBPS = 8.0


@dataclass(frozen=True, order=True)
class ModelVariant:
    """One precision level of one application's model."""
    name: str
    bits: int
    size_mb: float
    accuracy: float  # task accuracy %, or fidelity proxy for LM archs
    load_ms: float

    @property
    def size_bytes(self) -> int:
        return int(self.size_mb * 1024 * 1024)


@dataclass(frozen=True)
class ModelZoo:
    """All variants of one application, largest (highest precision) first."""
    app_name: str
    variants: Tuple[ModelVariant, ...]

    def __post_init__(self):
        ordered = tuple(
            sorted(self.variants, key=lambda v: -v.size_mb))
        object.__setattr__(self, "variants", ordered)
        if not ordered:
            raise ValueError(f"empty zoo for {self.app_name}")

    @property
    def largest(self) -> ModelVariant:
        return self.variants[0]

    @property
    def smallest(self) -> ModelVariant:
        return self.variants[-1]

    def next_smaller(self, v: ModelVariant) -> Optional[ModelVariant]:
        idx = self.variants.index(v)
        return self.variants[idx + 1] if idx + 1 < len(self.variants) else None

    def by_bits(self, bits: int) -> ModelVariant:
        for v in self.variants:
            if v.bits == bits:
                return v
        raise KeyError(f"{self.app_name}: no {bits}-bit variant")


def zoo_from_config(
    cfg: ModelConfig,
    *,
    precisions: Tuple[int, ...] = (16, 8, 4),
    fidelity: Optional[dict] = None,
    chips: int = 1,
) -> ModelZoo:
    """Build a real zoo for an LM architecture.

    ``fidelity`` maps bits -> accuracy-proxy in [0, 100] (top-1 agreement vs
    the bf16 reference, measured by benchmarks/quant_fidelity).  Defaults are
    placeholders refined by that benchmark.  ``chips`` divides the load time
    (per-chip shards stream in parallel from their hosts).
    """
    fidelity = fidelity or {16: 100.0, 8: 99.0, 4: 95.0}
    variants = []
    for bits in precisions:
        size_bytes = cfg.bytes_for_precision(bits)
        size_mb = size_bytes / (1024 * 1024)
        load_ms = size_bytes / (HOST_TO_HBM_GBPS * 1e9) / max(chips, 1) * 1e3
        variants.append(
            ModelVariant(
                name=f"{cfg.name}-{bits}bit",
                bits=bits,
                size_mb=size_mb,
                accuracy=fidelity.get(bits, 90.0),
                load_ms=load_ms,
            ))
    return ModelZoo(app_name=cfg.name, variants=tuple(variants))
