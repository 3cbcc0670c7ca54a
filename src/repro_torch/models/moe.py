"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro.models.moe``. Dispatch is *sort-based*, as in the
reference: argsort the (token, slot) assignments by expert id, gather the
tokens into an (E, C, D) buffer, run the experts as batched SwiGLU
products (:func:`expert_swiglu`, ``torch.bmm``; the reference leaves them
to XLA too), then combine. :func:`moe_ffn_dense` is the small-scale oracle.

What the port keeps of the reference's behaviour, on purpose:

* the capacity is ``int(max(1, round(t·k/E·cf)))`` with Python's
  ``round``; at decode with few tokens it is 1, so decode drops tokens;
* which assignments overflow follows the *stable* argsort by expert id and
  each expert's first position in the sorted order;
* the dispatch buffer is (E, C+1, D) in the *weight* dtype and every
  overflowing assignment writes the waste slot C, which is sliced away
  (with duplicate indices the writes to C are unordered on CUDA);
* the router runs in f32 on x cast to f32.

The combine is deterministic: each token's k contributions are gathered
through the inverse permutation and added in the order the reference's
scatter-add applies them (by expert id), in the activation dtype, with no
atomics, so two runs on the card give the same bits.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, d_model: int, num_experts: int, moe_d_ff: int,
             dtype: torch.dtype = torch.float32) -> Params:
    """The router stays f32; the expert tensors (E, ·, ·) take fan_in = E
    from ``dense_init``, so their std is E^-0.5, as in the reference."""
    return {
        "router": dense_init(gen, (d_model, num_experts), dtype=torch.float32),
        "w_gate": dense_init(gen, (num_experts, d_model, moe_d_ff), dtype=dtype),
        "w_up": dense_init(gen, (num_experts, d_model, moe_d_ff), dtype=dtype),
        "w_down": dense_init(gen, (num_experts, moe_d_ff, d_model), dtype=dtype),
    }


def moe_spec() -> Dict[str, Tuple]:
    """Logical axes of :func:`init_moe`'s tensors."""
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "ffn"),
        "w_up": ("experts", "embed", "ffn"),
        "w_down": ("experts", "ffn", "embed"),
    }


def router_topk(x2d: torch.Tensor, router_w: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (T, k) normalised, expert_idx (T, k), full probs (T, E))."""
    logits = x2d.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e."""
    counts = torch.bincount(idx.reshape(-1), minlength=num_experts).float()
    f = counts / max(idx.numel(), 1)
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def capacity(tokens: int, k: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert, with Python's ``round`` (half to even), as the reference."""
    return int(max(1, round(tokens * k / num_experts * capacity_factor)))


def expert_swiglu(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """The experts as batched products: (E, C, D) → (E, C, D)."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def moe_ffn(params: Params, x: torch.Tensor, num_experts: int, k: int,
            capacity_factor: float = 1.25, return_aux: bool = False):
    """Sort-based capacity-limited top-k MoE on x (B, S, D)."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, idx, probs = router_topk(x2d, params["router"], k)
    cap = capacity(t, k, num_experts, capacity_factor)

    # (token, slot) assignments grouped by expert, stable within an expert
    flat_expert = idx.reshape(-1)                                   # (t·k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = order // k
    sorted_gate = gates.reshape(-1)[order]
    # rank within the expert's group: position less the group's first position
    positions = torch.arange(t * k, device=x.device)
    experts = torch.arange(num_experts, device=x.device, dtype=sorted_expert.dtype)
    seg_start = torch.searchsorted(sorted_expert, experts)
    rank = positions - seg_start[sorted_expert]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap))      # overflow → slot C

    wdt = params["w_gate"].dtype
    buf = torch.zeros((num_experts, cap + 1, d), dtype=wdt, device=x.device)
    buf[sorted_expert, slot] = x2d.to(wdt)[sorted_token]
    y = expert_swiglu(buf[:, :cap], params["w_gate"], params["w_up"], params["w_down"])

    ypad = torch.cat([y, torch.zeros((num_experts, 1, d), dtype=y.dtype, device=y.device)],
                     dim=1)
    contrib = ypad[sorted_expert, slot] * sorted_gate[:, None].to(y.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros((), dtype=y.dtype,
                                                              device=y.device))
    # each token's k sorted positions, ascending = by expert id: the order in
    # which the reference's scatter-add applies them
    inverse = torch.empty_like(order)
    inverse[order] = positions
    per_token = contrib[inverse.view(t, k).sort(dim=1).values]     # (t, k, D)
    out2d = per_token[:, 0]
    for j in range(1, k):
        out2d = out2d + per_token[:, j]
    out = out2d.reshape(b, s, d).to(x.dtype)
    if return_aux:
        return out, load_balance_loss(probs, idx, num_experts)
    return out


def moe_ffn_dense(params: Params, x: torch.Tensor, num_experts: int, k: int) -> torch.Tensor:
    """Oracle: every expert for every token, masked by the routing (no drops)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, idx, _ = router_topk(x2d, params["router"], k)
    g = torch.einsum("td,edf->tef", x2d, params["w_gate"])
    u = torch.einsum("td,edf->tef", x2d, params["w_up"])
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, params["w_down"])   # (T, E, D)
    weight = torch.zeros((b * s, num_experts), dtype=y.dtype, device=y.device)
    weight.scatter_(1, idx, gates.to(y.dtype))
    out = torch.einsum("ted,te->td", y, weight)
    return out.reshape(b, s, d)
