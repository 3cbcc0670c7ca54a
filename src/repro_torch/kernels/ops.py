"""Model-layer entry points around the kernels.

They adapt model layouts to the kernels' layouts, e.g. (B, S, H, hd) GQA
attention → the flattened (B·H, S, hd) layout of
:func:`repro_torch.kernels.flash_attention.flash_attention`. Each kernel is
called as an attribute of this module, so a caller can swap in its plain
version; callers in turn call these entry points as attributes of this
module (the runtime's Worker calls :func:`quantize_rows`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention
from .int8_quant import quantize_int8
from .ssd_scan import ssd_scan


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


def ssd_bshp(
    x: torch.Tensor,                     # (B, S, H, P)
    dt: torch.Tensor,                    # (B, S, H) f32
    A: torch.Tensor,                     # (H,) f32
    Bm: torch.Tensor,                    # (B, S, G, N)
    Cm: torch.Tensor,                    # (B, S, G, N)
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD on (B, S, H, P) + groups; returns (y (B, S, H, P),
    final state (B, H, P, N) f32). The groups are not broadcast to heads:
    the kernel reads group row ``bh // (H // G)``."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    xf = x.transpose(1, 2).reshape(b * h, s, p).contiguous()
    dtf = dt.transpose(1, 2).reshape(b * h, s).contiguous()
    Bf = Bm.transpose(1, 2).reshape(b * g, s, n).contiguous()
    Cf = Cm.transpose(1, 2).reshape(b * g, s, n).contiguous()
    Af = A.repeat(b)
    init = None
    if initial_state is not None:
        init = initial_state.transpose(2, 3).reshape(b * h, n, p).contiguous()
    y, state = ssd_scan(xf, dtf, Af, Bf, Cf, chunk=chunk, heads_per_group=h // g,
                        initial_state=init)
    y = y.reshape(b, h, s, p).transpose(1, 2)
    state = state.reshape(b, h, n, p).transpose(2, 3)
    return y, state


def quantize_rows(x: torch.Tensor, out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise int8 quantization of x (R, C): (q int8, scale f32 (R,)); with
    ``out`` (bf16 or f32, shaped like x) the same launch also writes
    ``q * scale[:, None]`` into it."""
    return quantize_int8(x, out)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q * scale[:, None]`` in f32, rounded once into ``out``'s dtype when given."""
    return torch.mul(q, scale[:, None], out=out)
