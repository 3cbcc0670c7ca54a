"""Model configuration schema: a copy of ``repro.models.config``.

One :class:`ModelConfig` describes any of the assigned families: dense
decoder (GQA/RoPE/SwiGLU, optional qk-norm/QKV-bias/sliding-window), MoE,
Mamba2 SSD, hybrid, encoder-decoder (audio) and VLM. The port keeps its own
copy so that it never imports the JAX package; ``tests/test_torch_configs.py``
holds every field equal to the reference.

Layer stacking uses a repeating *pattern*: ``layout_pattern`` lists the
block kinds of one period; the model is ``num_layers / len(pattern)``
repetitions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# block kinds
ATTN = "attn"            # self-attention + dense FFN
ATTN_MOE = "attn_moe"    # self-attention + MoE FFN
SSM = "ssm"              # Mamba2 mixer (no separate FFN)
SSM_MOE = "ssm_moe"      # Mamba2 mixer + MoE FFN (Jamba style)
SSM_MLP = "ssm_mlp"      # Mamba2 mixer + dense FFN (Jamba style)
CROSS = "cross"          # self-attn is replaced by gated cross-attention + FFN

VALID_KINDS = (ATTN, ATTN_MOE, SSM, SSM_MOE, SSM_MLP, CROSS)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    layout_pattern: Tuple[str, ...] = (ATTN,)
    head_dim: Optional[int] = None
    # attention options -----------------------------------------------------
    rope_theta: float = 10_000.0
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen2.5
    sliding_window: Optional[int] = None  # enables sub-quadratic long context
    # MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # per-expert hidden size
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD) ------------------------------------------------------
    ssm_state: int = 0                # N
    ssm_head_dim: int = 64            # P
    ssm_expand: int = 2
    ssm_chunk: int = 128              # SSD chunk length Q
    ssm_conv_width: int = 4
    ssm_groups: int = 1               # G (B/C groups)
    # encoder-decoder (audio) ---------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500       # whisper: 30 s of audio at 50 Hz
    # VLM -----------------------------------------------------------------
    num_image_tokens: int = 0         # cross-attn KV length (stub embeddings)
    # misc -------------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # citation of the public source for this config
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:        # attention-free (pure SSM)
            return 0
        return self.d_model // self.num_heads

    @property
    def pattern_repeats(self) -> int:
        if self.num_layers % len(self.layout_pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.layout_pattern)}"
            )
        return self.num_layers // len(self.layout_pattern)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def uses_ssm(self) -> bool:
        return any(k.startswith("ssm") for k in self.layout_pattern)

    @property
    def uses_moe(self) -> bool:
        return any(k.endswith("moe") for k in self.layout_pattern)

    @property
    def uses_attention(self) -> bool:
        return any(k in (ATTN, ATTN_MOE, CROSS) for k in self.layout_pattern)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid natively; dense via sliding window."""
        if not self.uses_attention:
            return True
        return self.sliding_window is not None or self.uses_ssm

    def validate(self) -> "ModelConfig":
        for k in self.layout_pattern:
            if k not in VALID_KINDS:
                raise ValueError(f"unknown block kind {k}")
        _ = self.pattern_repeats
        if self.uses_attention and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.uses_moe and not (0 < self.experts_per_token <= self.num_experts):
            raise ValueError("bad MoE top-k")
        if self.uses_ssm and self.d_inner % self.ssm_head_dim:
            raise ValueError("d_inner must be divisible by ssm_head_dim")
        return self

    # -- parameter counting (for roofline MODEL_FLOPS) -----------------------
    def param_count(self) -> int:
        D, V = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n = 0
        n += V * D                                   # embed
        if not self.tie_embeddings:
            n += D * V                               # head
        per_kind = {}
        for kind in set(self.layout_pattern):
            p = 2 * D           # two norms
            if kind in (ATTN, ATTN_MOE, CROSS):
                q = D * self.num_heads * hd
                kv = 2 * D * self.num_kv_heads * hd
                o = self.num_heads * hd * D
                p += q + kv + o
                if kind == CROSS:
                    p += D  # attention gate
            if kind in (SSM, SSM_MOE, SSM_MLP):
                di, N, G, H = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_heads
                in_proj = D * (2 * di + 2 * G * N + H)
                conv = (di + 2 * G * N) * self.ssm_conv_width
                out = di * D
                p += in_proj + conv + out + 2 * H + di
            if kind in (ATTN, SSM_MLP) and self.d_ff:
                p += 3 * D * self.d_ff               # SwiGLU
            if kind.endswith("moe"):
                p += D * self.num_experts            # router
                p += self.num_experts * 3 * D * self.moe_d_ff
            per_kind[kind] = p
        for kind in self.layout_pattern:
            n += per_kind[kind] * self.pattern_repeats
        if self.is_encoder_decoder:
            # encoder: attn + dense FFN per layer + cross-attn params in decoder
            enc = self.encoder_layers * (
                2 * D + 2 * D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd
                + 3 * D * self.d_ff
            )
            dec_cross = self.num_layers * (
                D + D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd
                + self.num_heads * hd * D
            )
            n += enc + dec_cross
        return int(n)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.uses_moe:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for k in self.layout_pattern if k.endswith("moe"))
        moe_layers *= self.pattern_repeats
        all_experts = moe_layers * self.num_experts * 3 * self.d_model * self.moe_d_ff
        active = moe_layers * self.experts_per_token * 3 * self.d_model * self.moe_d_ff
        return int(full - all_experts + active)


def uniform_layout(kind: str) -> Tuple[str, ...]:
    return (kind,)
