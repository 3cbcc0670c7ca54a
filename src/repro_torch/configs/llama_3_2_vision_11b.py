"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. Every 5th layer is
a gated cross-attention layer consuming image patch embeddings (8 cross
layers total). The vision encoder is a STUB: ``input_specs`` provides
precomputed patch embeddings of shape (B, 6404, d_model) — the allowed
modality-frontend carve-out.

`long_500k` uses the sliding-window attention variant (window 8192) to
meet the sub-quadratic requirement; the launcher enables it for decode
at 500k only.
"""
from ..models.config import ATTN, CROSS, ModelConfig

NUM_IMAGE_TOKENS = 6404  # 4 tiles x 1601 patches

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    layout_pattern=(ATTN, ATTN, ATTN, ATTN, CROSS),
    rope_theta=500_000.0,
    num_image_tokens=NUM_IMAGE_TOKENS,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke",
        arch_type="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        layout_pattern=(ATTN, CROSS),
        num_image_tokens=16,
        dtype="float32",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    ).validate()
