"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert) vocab=50304,
MoE 64e top-8. Every FFN is MoE; expert-parallel sharding is where the
Puzzle dtype/backend configuration choice matters most.
"""
from ..models.config import ATTN_MOE, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50304,
    layout_pattern=(ATTN_MOE,),
    num_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
    qk_norm=True,
    source="arXiv:2409.02060",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        layout_pattern=(ATTN_MOE,),
        num_experts=4,
        experts_per_token=2,
        moe_d_ff=64,
        qk_norm=True,
        dtype="float32",
        source="arXiv:2409.02060",
    ).validate()
