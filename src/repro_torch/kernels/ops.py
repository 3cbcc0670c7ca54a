"""Model-layer entry points around the kernels.

They adapt model layouts to the kernels' layouts, e.g. (B, S, H, hd) GQA
attention → the flattened (B·H, S, hd) layout of
:func:`repro_torch.kernels.flash_attention.flash_attention`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def flash_attention_bshd(
    q: torch.Tensor,                     # (B, Sq, H, hd)
    k: torch.Tensor,                     # (B, Sk, Kv, hd)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA flash attention on (B, S, H, hd); returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qf = q.transpose(1, 2).reshape(b * h, sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * kv, k.shape[1], hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * kv, v.shape[1], hd).contiguous()
    out = flash_attention(qf, kf, vf, q_heads_per_kv=g, causal=causal,
                          window=window, q_offset=q_offset)
    return out.reshape(b, h, sq, hd).transpose(1, 2)
