"""tinyllama-1.1b — llama2-architecture small model with GQA.
[arXiv:2401.02385; hf]  22L d_model=2048 32H (kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab_size=32000,
        rope_theta=10000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        vocab_pad_multiple=16,
    )
