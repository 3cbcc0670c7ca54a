"""Dense oracle for the attention kernel (port of ``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,                     # (BH, Sq, hd)
    k: torch.Tensor,                     # (BKv, Sk, hd)
    v: torch.Tensor,
    *,
    q_heads_per_kv: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    kk = torch.repeat_interleave(k, q_heads_per_kv, dim=0)
    vv = torch.repeat_interleave(v, q_heads_per_kv, dim=0)
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), kk.float()) * hd ** -0.5
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(kk.shape[1], device=q.device)[None, :]
    mask = torch.ones_like(s[0], dtype=torch.bool)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vv.float()).to(q.dtype)
