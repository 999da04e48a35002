"""Stand-ins for every model input: shapes and integer types on the
``meta`` device, nothing allocated.

Port of :mod:`repro.launch.specs`.  Where the reference returns
``jax.ShapeDtypeStruct``s, these are ``meta`` tensors of the same shapes
and types; the spec functions of :mod:`repro_torch.distributed.sharding`
read them.  ``input_specs(cfg, shape_name)`` returns (step kind, specs)
for the train, prefill or decode step of one of ``SHAPE_SPECS``'s shapes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPE_SPECS, ModelConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_spec(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.num_codebooks == 1:
        return _meta((batch, seq), torch.int32)
    return _meta((batch, seq, cfg.num_codebooks), torch.int32)


def batch_specs_for(cfg: ModelConfig, shape_name: str, *,
                    with_labels: bool) -> Dict[str, torch.Tensor]:
    seq, gbatch, _ = SHAPE_SPECS[shape_name]
    text_seq = seq
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision_stub":
        # vision tokens count toward the total sequence budget.
        text_seq = seq - cfg.num_vision_tokens
        out["patch_embeds"] = _meta(
            (gbatch, cfg.num_vision_tokens, cfg.d_model), torch.bfloat16)
    out["tokens"] = token_spec(cfg, gbatch, text_seq)
    if with_labels:
        out["labels"] = token_spec(cfg, gbatch, text_seq)
    return out


def decode_specs_for(cfg: ModelConfig, shape_name: str,
                     cache_dtype=torch.bfloat16,
                     quantized_cache: bool = False
                     ) -> Tuple[torch.Tensor, Any]:
    """(token spec, abstract cache at full context length)."""
    seq, gbatch, _ = SHAPE_SPECS[shape_name]
    tok = (_meta((gbatch,), torch.int32) if cfg.num_codebooks == 1
           else _meta((gbatch, cfg.num_codebooks), torch.int32))
    return tok, T.abstract_cache(cfg, gbatch, seq, cache_dtype,
                                 quantized_cache)


def input_specs(cfg: ModelConfig, shape_name: str,
                quantized_cache: bool = False):
    """(kind, specs dict) of the step of this cell."""
    kind = SHAPE_SPECS[shape_name][2]
    if kind == "train":
        return kind, {"batch": batch_specs_for(cfg, shape_name,
                                               with_labels=True)}
    if kind == "prefill":
        return kind, {"batch": batch_specs_for(cfg, shape_name,
                                               with_labels=False)}
    tok, cache = decode_specs_for(cfg, shape_name,
                                  quantized_cache=quantized_cache)
    return kind, {"tokens": tok, "cache": cache}
