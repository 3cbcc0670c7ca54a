"""PyTorch model stack: every block kind of the reference (dense, MoE,
Mamba2, hybrid, cross-attention) and the encoder-decoder stack."""
from .attention import blockwise_attention, cross_attention, decode_attention, project_qkv
from .config import ATTN, ATTN_MOE, CROSS, SSM, SSM_MLP, SSM_MOE, ModelConfig
from .convert import params_from_jax, zoo_weights_from_jax
from .layers import apply_rope, gelu_mlp, rms_norm, swiglu
from .moe import load_balance_loss, moe_ffn, moe_ffn_dense, router_topk
from .ssm import causal_conv1d, mamba2_decode_step, mamba2_mixer, ssd_chunked
from .transformer import (
    Transformer,
    check_supported,
    encode,
    forward_decode,
    forward_prefill,
    init_cache,
    init_params,
)

__all__ = [k for k in dir() if not k.startswith("_")]
