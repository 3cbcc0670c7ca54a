"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, attention-free, d_ff=0, vocab=50280, ssm_state=128.
Sub-quadratic by construction: `long_500k` runs natively (O(1) decode
state). The Puzzle technique applies unchanged — subgraph cut points fall
between SSD blocks and the recurrent state crosses lane boundaries.
"""
from ..models.config import SSM, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    layout_pattern=(SSM,),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    tie_embeddings=True,
    source="arXiv:2405.21060",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        arch_type="ssm",
        num_layers=2,
        d_model=256,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        layout_pattern=(SSM,),
        ssm_state=32,
        ssm_head_dim=32,
        ssm_expand=2,
        ssm_groups=1,
        ssm_chunk=16,
        tie_embeddings=True,
        dtype="float32",
        source="arXiv:2405.21060",
    ).validate()
