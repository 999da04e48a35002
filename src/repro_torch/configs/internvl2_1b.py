"""internvl2-1b — InternViT-300M frontend + Qwen2-0.5B LM backbone.
[arXiv:2404.16821; hf]  Backbone: 24L d_model=896 14H (kv=2) d_ff=4864
vocab=151655.

STUB per assignment: the InternViT vision tower is not implemented —
``input_specs()`` supplies precomputed patch embeddings (B, 256, d_model)
which the backbone consumes via early concatenation with text embeddings.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151655,
        rope_theta=1_000_000.0,
        frontend="vision_stub",
        num_vision_tokens=256,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-reduced",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        frontend="vision_stub",
        num_vision_tokens=8,
        tie_embeddings=True,
        vocab_pad_multiple=16,
    )
