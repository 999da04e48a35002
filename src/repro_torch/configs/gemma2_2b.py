"""gemma2-2b — local/global alternating attention, logit softcaps, GeGLU,
pre+post norms, tied embeddings.  [arXiv:2408.00118; hf]
26L d_model=2304 8H (kv=4, head_dim=256) d_ff=9216 vocab=256000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        sliding_window=4096,
        layer_pattern=("local", "global"),
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        act="gelu",
        emb_scale=True,
        post_norm=True,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-reduced",
        family="dense",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        sliding_window=8,
        layer_pattern=("local", "global"),
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        act="gelu",
        emb_scale=True,
        post_norm=True,
        tie_embeddings=True,
        vocab_pad_multiple=16,
    )
