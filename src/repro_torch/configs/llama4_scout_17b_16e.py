"""llama4-scout-17b-a16e — MoE 16 routed experts top-1 + 1 shared expert,
QK-norm, early fusion (text path only here).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,  # shared-expert width
        vocab_size=202048,
        rope_theta=500_000.0,
        num_experts=16,
        num_experts_per_tok=1,
        moe_d_ff=8192,
        num_shared_experts=1,
        qk_norm=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        num_experts=4,
        num_experts_per_tok=1,
        moe_d_ff=128,
        num_shared_experts=1,
        qk_norm=True,
        vocab_pad_multiple=16,
    )
