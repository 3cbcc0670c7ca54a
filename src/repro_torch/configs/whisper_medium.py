"""whisper-medium [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

24L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865. 24 encoder layers
(bidirectional self-attention over stub frame embeddings, 1500 frames =
30 s at 50 Hz) + 24 decoder layers (causal self-attention + cross-attention
to the encoder output). The mel-spectrogram + conv feature extractor is the
allowed STUB — ``input_specs`` supplies frame embeddings directly.
"""
from ..models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    layout_pattern=(ATTN,),
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_seq_len=1500,
    source="arXiv:2212.04356",
).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        arch_type="audio",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        layout_pattern=(ATTN,),
        is_encoder_decoder=True,
        encoder_layers=2,
        encoder_seq_len=32,
        dtype="float32",
        source="arXiv:2212.04356",
    ).validate()
