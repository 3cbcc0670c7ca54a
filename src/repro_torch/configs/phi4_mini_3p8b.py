"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
Dense full-attention: `long_500k` runs only via the sliding-window variant
(window 8192), which the launcher enables for that shape.
"""
from ..models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    layout_pattern=(ATTN,),
    rope_theta=10_000.0,
    source="arXiv:2412.08905",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=192,
        num_heads=6,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        layout_pattern=(ATTN,),
        dtype="float32",
        source="arXiv:2412.08905",
    ).validate()
