"""PyTorch model stack: decoders of ``attn`` and ``ssm`` (Mamba2) blocks."""
from .attention import blockwise_attention, decode_attention, project_qkv
from .config import ATTN, ATTN_MOE, CROSS, SSM, SSM_MLP, SSM_MOE, ModelConfig
from .convert import params_from_jax, zoo_weights_from_jax
from .layers import apply_rope, rms_norm, swiglu
from .ssm import causal_conv1d, mamba2_decode_step, mamba2_mixer, ssd_chunked
from .transformer import (
    Transformer,
    forward_decode,
    forward_prefill,
    init_cache,
    init_params,
)

__all__ = [k for k in dir() if not k.startswith("_")]
