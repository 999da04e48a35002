"""Unified model configuration for the 10 assigned LM-family architectures.

One dataclass covers dense / MoE / SSM / hybrid / audio / vlm families; the
per-arch files in ``repro_torch.configs`` instantiate it with published numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int  # query heads; 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int  # logical vocabulary
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention extras -------------------------------------------------
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full attention everywhere
    # Cycled per-layer kinds. Entries: "global" | "local" | "ssm" | "hybrid".
    layer_pattern: Tuple[str, ...] = ()
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0  # per-expert hidden width (d_ff used for dense/shared)
    num_shared_experts: int = 0

    # --- SSM (mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (hymba) ------------------------------------------------------
    num_meta_tokens: int = 0

    # --- modality frontends (stubs per assignment) ---------------------------
    num_codebooks: int = 1  # musicgen: 4 EnCodec codebooks
    frontend: str = "none"  # none | vision_stub | audio_stub
    num_vision_tokens: int = 0

    # --- misc -----------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"  # silu | gelu
    emb_scale: bool = False  # gemma2 scales embeddings by sqrt(d_model)
    post_norm: bool = False  # gemma2 applies post-block norms
    qk_norm: bool = False
    vocab_pad_multiple: int = 256
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        if not self.ssm_state:
            return 0
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def ssm_conv_dim(self) -> int:
        # conv runs over concat(x, B, C) as in Mamba-2.
        return self.ssm_d_inner + 2 * self.ssm_ngroups * self.ssm_state

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind tuple of length num_layers (pattern cycled)."""
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.num_layers))
        if self.family == "hybrid":
            base = list(self.layer_pattern) or ["hybrid"]
            kinds = [base[i % len(base)] for i in range(self.num_layers)]
            return tuple(kinds)
        if not self.layer_pattern:
            return tuple("global" for _ in range(self.num_layers))
        return tuple(
            self.layer_pattern[i % len(self.layer_pattern)]
            for i in range(self.num_layers)
        )

    def window_for_kind(self, kind: str) -> int:
        """KV window length for a layer kind. 0 = unbounded (full)."""
        if kind in ("local", "hybrid") and self.sliding_window:
            return self.sliding_window
        return 0  # "global", "hybrid_full", "ssm"

    @property
    def cache_extra_tokens(self) -> int:
        """Cache slots beyond the text sequence (meta + vision-stub tokens)."""
        return self.num_meta_tokens + self.num_vision_tokens

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def uses_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def uses_ssm(self) -> bool:
        return self.ssm_state > 0

    # ------------------------------------------------------------------
    # Parameter / capacity accounting (used by core.capacity and the
    # model-zoo size math — must agree with init_params shapes).
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        n = 0
        # embeddings (+ per-codebook for audio)
        n += self.num_codebooks * V * D
        if not self.tie_embeddings:
            n += self.num_codebooks * V * D
        n += D  # final norm
        n += self.num_meta_tokens * D
        # Mirrors models.transformer._layer_param_template exactly
        # (validated by tests/test_models.py::test_param_count_matches_init).
        pl = 0
        hybrid = self.family == "hybrid"
        if self.uses_attention:
            pl += D  # ln1
            pl += D * H * hd + 2 * D * KV * hd + H * hd * D  # qkvo
            if self.post_norm:
                pl += D  # post_ln1
            if self.qk_norm:
                pl += 2 * hd
        if self.uses_ssm:
            di = D if hybrid else self.ssm_d_inner
            nst, nh = self.ssm_state, max(1, di // self.ssm_head_dim)
            convd = di + 2 * self.ssm_ngroups * nst
            if not self.uses_attention:
                pl += D  # ln1
            pl += D * (2 * di + 2 * self.ssm_ngroups * nst + nh)  # ssm_in
            pl += self.ssm_conv_width * convd + convd  # conv w+b
            pl += 3 * nh  # A_log, D_skip, dt_bias
            pl += di  # gated norm
            if not hybrid:
                pl += di * D  # ssm_out
        if hybrid:
            pl += 2 * D  # fuse_na, fuse_ns
        if self.is_moe:
            E, Fe = self.num_experts, self.moe_d_ff
            pl += D  # ln2
            pl += D * E  # router
            pl += E * (2 * D * Fe + Fe * D)
            if self.num_shared_experts:
                pl += self.num_shared_experts * (2 * D * F + F * D)
        elif F:
            pl += D  # ln2
            pl += 2 * D * F + F * D
            if self.post_norm:
                pl += D  # post_ln2
        n += self.num_layers * pl
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        D, Fe = self.d_model, self.moe_d_ff
        E, K = self.num_experts, self.num_experts_per_tok
        inactive_per_layer = (E - K) * (3 * D * Fe)
        return self.param_count() - self.num_layers * inactive_per_layer

    def bytes_for_precision(self, bits: int) -> int:
        """Weight-only footprint of one zoo variant (scales included for int)."""
        n = self.param_count()
        base = n * bits // 8
        if bits < 16:
            # per-channel fp16 scales: ~1 scale per 128 weights, 2B each.
            base += (n // 128) * 2
        return base


SHAPE_SPECS = {
    # name: (seq_len, global_batch, step kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic attention path).
LONG_CONTEXT_ARCHS = ("mamba2-780m", "hymba-1.5b", "gemma2-2b")


def cell_is_runnable(arch_name: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS
    return True
