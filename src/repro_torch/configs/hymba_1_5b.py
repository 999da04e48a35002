"""hymba-1.5b — parallel attention + mamba heads per layer, meta tokens,
sliding-window attention with 3 full-attention layers (first/middle/last).
[arXiv:2411.13676; hf]  32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001.
"""
from repro_torch.models.config import ModelConfig

_PATTERN = tuple(
    "hybrid_full" if i in (0, 15, 31) else "hybrid" for i in range(32)
)


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        sliding_window=1024,
        layer_pattern=_PATTERN,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=1,  # hybrid branch works at d_model width
        ssm_chunk=256,
        ssm_conv_width=4,
        ssm_ngroups=1,
        num_meta_tokens=128,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-reduced",
        family="hybrid",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=97,
        sliding_window=8,
        layer_pattern=("hybrid_full", "hybrid", "hybrid"),
        ssm_state=8,
        ssm_head_dim=16,
        ssm_expand=1,
        ssm_chunk=8,
        ssm_conv_width=4,
        ssm_ngroups=1,
        num_meta_tokens=4,
        vocab_pad_multiple=16,
    )
