"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from ..models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    layout_pattern=(ATTN,),
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=160,
        num_heads=5,
        num_kv_heads=1,
        d_ff=384,
        vocab_size=512,
        layout_pattern=(ATTN,),
        qk_norm=True,
        dtype="float32",
        source="hf:Qwen/Qwen3-8B",
    ).validate()
