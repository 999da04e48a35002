"""olmoe-1b-7b — 64 experts, top-8 routing, QK-norm.
[arXiv:2409.02060; hf]  16L d_model=2048 16H (kv=16) d_ff=1024/expert
vocab=50304.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=0,  # no dense/shared FFN — all-MoE
        vocab_size=50304,
        num_experts=64,
        num_experts_per_tok=8,
        moe_d_ff=1024,
        qk_norm=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=0,
        vocab_size=128,
        num_experts=8,
        num_experts_per_tok=2,
        moe_d_ff=64,
        qk_norm=True,
        vocab_pad_multiple=16,
    )
