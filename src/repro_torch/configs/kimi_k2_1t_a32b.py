"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert) vocab=163840,
MoE 384e top-8. ~1.03T parameters; training state requires Adafactor +
full FSDP sharding (see train/optimizer.py and DESIGN.md §6).
"""
from ..models.config import ATTN_MOE, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=163840,
    layout_pattern=(ATTN_MOE,),
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        layout_pattern=(ATTN_MOE,),
        num_experts=4,
        experts_per_token=2,
        moe_d_ff=128,
        dtype="float32",
        source="arXiv:2501.kimi2",
    ).validate()
