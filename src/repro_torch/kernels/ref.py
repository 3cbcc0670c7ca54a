"""Oracles for the kernels (port of ``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Optional, Tuple

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


def ssd_ref(
    x: torch.Tensor,                     # (BH, S, P)
    dt: torch.Tensor,                    # (BH, S)
    A: torch.Tensor,                     # (BH,)
    Bm: torch.Tensor,                    # (BH, S, N)
    Cm: torch.Tensor,                    # (BH, S, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token linear recurrence — the SSD ground truth.

    state (BH, N, P); y_t = C_t · h_t, h_t = exp(dt_t A) h_{t-1} + dt_t B_t xᵀ_t.
    """
    bh, s, p = x.shape
    n = Bm.shape[-1]
    state = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    xf, bf, cf = x.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)[:, None, None]
        outer = torch.einsum("bn,bp,b->bnp", bf[:, t], xf[:, t], dt[:, t])
        state = decay * state + outer
        ys.append(torch.einsum("bn,bnp->bp", cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state
