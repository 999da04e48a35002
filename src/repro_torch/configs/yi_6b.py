"""yi-6b — llama-architecture GQA.  [arXiv:2403.04652; hf]
32L d_model=4096 32H (kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-reduced",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=160,
        rope_theta=5_000_000.0,
        vocab_pad_multiple=16,
    )
