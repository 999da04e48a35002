"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the full published configuration;
``get_config(name, reduced=True)`` returns the same family scaled down for
CPU smoke tests (few layers, narrow widths, tiny vocab).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.models.config import ModelConfig

from . import (
    gemma2_2b,
    granite_3_2b,
    hymba_1_5b,
    internvl2_1b,
    llama4_scout_17b_16e,
    mamba2_780m,
    musicgen_large,
    olmoe_1b_7b,
    paper_edge,
    tinyllama_1_1b,
    yi_6b,
)

_MODULES = {
    "mamba2-780m": mamba2_780m,
    "hymba-1.5b": hymba_1_5b,
    "gemma2-2b": gemma2_2b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "yi-6b": yi_6b,
    "granite-3-2b": granite_3_2b,
    "musicgen-large": musicgen_large,
    "llama4-scout-17b-a16e": llama4_scout_17b_16e,
    "olmoe-1b-7b": olmoe_1b_7b,
    "internvl2-1b": internvl2_1b,
}

ARCH_NAMES: List[str] = list(_MODULES)


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.reduced_config() if reduced else mod.config()


def all_configs(*, reduced: bool = False) -> Dict[str, ModelConfig]:
    return {n: get_config(n, reduced=reduced) for n in ARCH_NAMES}
