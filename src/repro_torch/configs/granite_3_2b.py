"""granite-3-2b — GQA dense.  [hf:ibm-granite/granite-3.0-2b-base; hf]
40L d_model=2048 32H (kv=8) d_ff=8192 vocab=49155 (padded to 49408 for TP).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49155,
        rope_theta=10000.0,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=131,  # deliberately non-multiple: exercises vocab padding
        tie_embeddings=True,
        vocab_pad_multiple=16,
    )
