"""qwen2.5-32b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from ..models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    layout_pattern=(ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=160,
        num_heads=5,
        num_kv_heads=1,
        d_ff=384,
        vocab_size=512,
        layout_pattern=(ATTN,),
        qkv_bias=True,
        dtype="float32",
        source="hf:Qwen/Qwen2.5-0.5B",
    ).validate()
