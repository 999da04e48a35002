"""musicgen-large — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284; hf]  48L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=2048 per codebook, 4 codebooks (delay pattern).

STUB per assignment: the EnCodec audio frontend is not implemented —
``input_specs()`` supplies the 4-codebook token grid directly.  Adaptations
recorded in DESIGN.md: RoPE replaces learned positional embeddings; the
text-conditioning cross-attention stack is omitted (unconditional decoding).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        num_codebooks=4,
        frontend="audio_stub",
        vocab_pad_multiple=128,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-reduced",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        num_codebooks=4,
        frontend="audio_stub",
        vocab_pad_multiple=16,
    )
