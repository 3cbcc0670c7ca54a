"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 (dense FFN; MoE experts reuse
the same hidden size) vocab=65536, MoE 16e top-2 on every other layer.
Pattern period 8 = one attention layer + seven Mamba layers, with MoE FFN
on alternating positions (lcm of the 1:7 attention cycle and the 1:1 MoE
cycle).
"""
from ..models.config import ATTN_MOE, SSM_MLP, SSM_MOE, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    # position 0: attention + MoE; then mamba layers alternating dense/MoE FFN
    layout_pattern=(ATTN_MOE, SSM_MLP, SSM_MOE, SSM_MLP, SSM_MOE, SSM_MLP,
                    SSM_MOE, SSM_MLP),
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    source="arXiv:2403.19887",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        arch_type="hybrid",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        layout_pattern=(ATTN_MOE, SSM_MLP),
        num_experts=4,
        experts_per_token=2,
        moe_d_ff=128,
        ssm_state=32,
        ssm_head_dim=32,
        ssm_expand=2,
        ssm_chunk=16,
        dtype="float32",
        source="arXiv:2403.19887",
    ).validate()
