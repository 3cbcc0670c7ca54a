"""Basic building blocks: norms, RoPE, SwiGLU, parameter initialization.

Port of ``repro.models.layers``. Parameters keep the reference's layouts
(e.g. ``wq`` is (D, H, hd)), so reference weights load unchanged. The
initializers draw from an explicit ``torch.Generator`` with the reference's
distributions and scales (not its bits: ``jax.random`` and torch differ).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics, cast to x's dtype, *then* multiply by ``scale``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


# -- RoPE -----------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)             # f32, as theta ** f32 array in jnp


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE. x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- initializers -------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Tuple[int, ...], scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, 1) · scale (default ``fan_in ** -0.5``, fan_in = shape[0])."""
    s = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(s).to(dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32) -> Params:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }


def init_attention(gen: torch.Generator, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, qkv_bias: bool = False, qk_norm: bool = False,
                   dtype: torch.dtype = torch.float32) -> Params:
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
    return p
