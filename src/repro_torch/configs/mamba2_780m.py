"""mamba2-780m — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  48L d_model=1536 d_ff=0 vocab=50280 state=128.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        ssm_conv_width=4,
        ssm_ngroups=1,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=128,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        ssm_chunk=16,
        ssm_conv_width=4,
        ssm_ngroups=1,
        tie_embeddings=True,
        vocab_pad_multiple=16,
    )
