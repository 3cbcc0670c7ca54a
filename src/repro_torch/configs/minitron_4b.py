"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from ..models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    layout_pattern=(ATTN,),
    source="arXiv:2407.14679",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=192,
        num_heads=6,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=1024,
        layout_pattern=(ATTN,),
        dtype="float32",
        source="arXiv:2407.14679",
    ).validate()
