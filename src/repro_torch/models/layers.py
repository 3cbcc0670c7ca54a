"""Basic building blocks: norms, RoPE, SwiGLU, GELU MLP, parameter initialization.

Port of ``repro.models.layers``. Parameters keep the reference's layouts
(e.g. ``wq`` is (D, H, hd)), so reference weights load unchanged. The
initializers draw from an explicit ``torch.Generator`` with the reference's
distributions and scales (not its bits: ``jax.random`` and torch differ).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.rope import rope_frequencies  # noqa: F401  (the reference's name here)
from ..sharding.context import matmul

Params = Dict[str, torch.Tensor]
Spec = Dict[str, Tuple[Optional[str], ...]]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics, cast to x's dtype, *then* multiply by ``scale``: B4
    (:func:`repro_torch.kernels.ops.rms_norm`) on the card, its plain
    version on the CPU, the eager chain on meta tensors; a ``DTensor`` on its
    shards."""
    return ops.rms_norm(x, scale, eps)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """The gate ``silu(g) · u`` between the products is B8
    (:func:`repro_torch.kernels.ops.silu_mul`) on the card, its plain
    version on the CPU, the eager chain on meta tensors; a ``DTensor`` on
    its shards."""
    g = matmul(x, w_gate)
    u = matmul(x, w_up)
    return matmul(ops.silu_mul(g, u), w_down)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` defaults to the tanh approximation, so this uses it too."""
    h = F.gelu(matmul(x, w_up) + b_up, approximate="tanh")
    return matmul(h, w_down) + b_down


# -- RoPE -----------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE. x: (B, S, H, hd); positions: broadcastable to (B, S).
    B7 (:func:`repro_torch.kernels.ops.rope_qk`) on the card, its plain
    version on the CPU, the eager chain on meta tensors; a ``DTensor`` on
    its shards. The frequencies are ``rope_frequencies``, kept a (head_dim,
    theta, device) on the card."""
    return ops.rope_qk(x, None, positions, theta)[0]


# -- initializers -------------------------------------------------------------

_DRAW_VALUES = 1 << 28                   # f32 values drawn at once: 1 GiB


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, 1) · scale (default ``fan_in ** -0.5``, fan_in = shape[0]).

    Drawn in f32 and cast, in slices along the first axis of at most
    ``_DRAW_VALUES`` values, so the f32 temporary stays small (kimi-k2's
    expert tensors hold 5.6 G values each). For an expert tensor (E, D, F)
    fan_in is E, as in the reference.
    """
    s = scale if scale is not None else shape[0] ** -0.5
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, _DRAW_VALUES // math.prod(shape[1:]))
    for r0 in range(0, shape[0], rows):
        part = out[r0:r0 + rows]
        part.copy_(torch.randn(part.shape, generator=gen, device=gen.device).mul_(s))
    return out


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32) -> Params:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }


def mlp_spec() -> Spec:
    """Logical axes of :func:`init_mlp`'s tensors (``repro.sharding.rules``'s names)."""
    return {
        "w_gate": ("embed", "ffn"),
        "w_up": ("embed", "ffn"),
        "w_down": ("ffn", "embed"),
    }


def init_attention(gen: torch.Generator, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, qkv_bias: bool = False, qk_norm: bool = False,
                   gated: bool = False, dtype: torch.dtype = torch.float32) -> Params:
    dev = gen.device
    p: Params = {
        "wq": dense_init(gen, (d_model, num_heads, head_dim), dtype=dtype),
        "wk": dense_init(gen, (d_model, num_kv_heads, head_dim), dtype=dtype),
        "wv": dense_init(gen, (d_model, num_kv_heads, head_dim), dtype=dtype),
        "wo": dense_init(gen, (num_heads, head_dim, d_model), dtype=dtype),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((num_heads, head_dim), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((num_kv_heads, head_dim), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((num_kv_heads, head_dim), dtype=dtype, device=dev)
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=dev)
    if gated:                            # llama-3.2-vision's cross-attention gate
        p["attn_gate"] = torch.zeros((1,), dtype=dtype, device=dev)
    return p


def attention_spec(qkv_bias: bool = False, qk_norm: bool = False,
                   gated: bool = False) -> Spec:
    """Logical axes of :func:`init_attention`'s tensors."""
    p: Spec = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if qkv_bias:
        p["bq"] = ("heads", "head_dim")
        p["bk"] = ("kv_heads", "head_dim")
        p["bv"] = ("kv_heads", "head_dim")
    if qk_norm:
        p["q_norm"] = ("head_dim",)
        p["k_norm"] = ("head_dim",)
    if gated:
        p["attn_gate"] = (None,)
    return p
