"""Optimizers: AdamW and Adafactor, the reference's arithmetic in PyTorch.

Port of ``repro.train.optimizer``. Both expose ``init(params) -> state`` and
``update(grads, state, params) -> (params, state)``. ``params`` is a list of
:class:`~repro_torch.models.convert.Leaf` in the reference's flatten order
(``param_leaves(model)``, or ``tree_leaves`` of a dict of tensors); a leaf
the reference stacks over pattern repetitions is the per-layer tensors.
``grads`` is aligned with it: one list of gradient tensors per leaf.

Step for step as the reference: the bias corrections from ``b ** t`` with t
in f32, weight decay inside AdamW's ``delta``, every update in f32 and cast
back to the parameter's dtype; Adafactor's factored dims, RMS clipping and
bf16 first moment over the reference's (stacked) leaf, so a stacked leaf is
stacked for its update. Never ``torch.optim.AdamW``, which decays and
corrects otherwise.

Unlike the reference's pure functions, ``update`` writes the new values
into the parameters and the state in place (under ``torch.no_grad()``) and
returns them, so a step holds no second copy of either; AdamW works through
a large tensor in slices of ``CHUNK`` elements, which bounds its f32
temporaries and changes no value (the update is elementwise). The state
lives on the parameters' device, in the reference's leaf order:
``OptState(step, inner)`` flattens as ``step``, then ``inner``'s sorted
keys, as the reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.convert import Leaf

Grads = Sequence[Sequence[torch.Tensor]]

#: elements per slice of AdamW's update: 64 Mi f32 temporaries are 256 MiB
CHUNK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8           # t^-decay second-moment schedule
    eps: float = 1e-30
    clip_threshold: float = 1.0
    momentum: Optional[float] = 0.9   # bf16 first moment; None disables
    weight_decay: float = 0.0


class OptState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    inner: Any


def _step_tensor(params: List[Leaf]) -> torch.Tensor:
    device = params[0].tensors[0].device if params else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def _slices(n: int):
    for i in range(0, n, CHUNK):
        yield slice(i, min(i + CHUNK, n))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(cfg: AdamWConfig = AdamWConfig()):
    def init(params: List[Leaf]) -> OptState:
        def zeros():
            return [Leaf([torch.zeros_like(t, dtype=torch.float32) for t in leaf.tensors],
                         leaf.stacked) for leaf in params]
        return OptState(step=_step_tensor(params), inner={"m": zeros(), "v": zeros()})

    def upd(p, g, m, v, bc1, bc2):
        """One slice of a tensor, in place: the reference's ``upd``."""
        g32 = g.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        del g32
        mh = m / bc1
        den = (v / bc2).sqrt_().add_(cfg.eps)
        delta = mh.div_(den).add_(cfg.weight_decay * p.float())
        del den
        p.copy_(p.float() - cfg.lr * delta)

    @torch.no_grad()
    def update(grads: Grads, state: OptState, params: List[Leaf]
               ) -> Tuple[List[Leaf], OptState]:
        step = state.step + 1
        t = step.float()
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t
        for leaf, gs, m_leaf, v_leaf in zip(params, grads, state.inner["m"], state.inner["v"]):
            for p, g, m, v in zip(leaf.tensors, gs, m_leaf.tensors, v_leaf.tensors):
                pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
                for sl in _slices(pf.numel()):
                    upd(pf[sl], gf[sl], mf[sl], vf[sl], bc1, bc2)
        return params, OptState(step=step, inner=state.inner)

    return init, update


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

def _factored_dims(shape: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    """Last two non-trivial dims to factor over, or None for <2D."""
    dims = [i for i, d in enumerate(shape) if d > 1]
    if len(dims) < 2:
        return None
    return dims[-2], dims[-1]


def adafactor(cfg: AdafactorConfig = AdafactorConfig()):
    def init_leaf(leaf: Leaf) -> Dict[str, torch.Tensor]:
        shape = leaf.shape
        dev = leaf.tensors[0].device
        f = _factored_dims(shape)
        st: Dict[str, torch.Tensor] = {}
        if f is None:
            st["v"] = torch.zeros(shape, dtype=torch.float32, device=dev)
        else:
            r, c = f
            st["vr"] = torch.zeros([d for i, d in enumerate(shape) if i != c],
                                   dtype=torch.float32, device=dev)
            st["vc"] = torch.zeros([d for i, d in enumerate(shape) if i != r],
                                   dtype=torch.float32, device=dev)
        if cfg.momentum is not None:
            st["m"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        return st

    def init(params: List[Leaf]) -> OptState:
        return OptState(step=_step_tensor(params), inner=[init_leaf(leaf) for leaf in params])

    def upd(p, g, st, beta2):
        g32 = g.float()
        g2 = g32 * g32 + cfg.eps
        f = _factored_dims(tuple(p.shape))
        if f is None:
            v = beta2 * st["v"] + (1 - beta2) * g2
            st["v"].copy_(v)
            precond = torch.rsqrt(v + cfg.eps)
        else:
            r, c = f
            vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(dim=c)
            vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(dim=r)
            st["vr"].copy_(vr)
            st["vc"].copy_(vc)
            # v ≈ (vr / mean(vr)) ⊗ vc  (rank-1 reconstruction)
            vr_norm = vr / torch.clamp(vr.mean(), min=cfg.eps)
            v = vr_norm.unsqueeze(c) * vc.unsqueeze(r)
            precond = torch.rsqrt(v + cfg.eps)
        u = g32 * precond
        # update clipping by RMS
        rms_u = torch.sqrt(torch.mean(u * u) + cfg.eps)
        u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        if cfg.momentum is not None:
            m = cfg.momentum * st["m"].float() + (1 - cfg.momentum) * u
            st["m"].copy_(m.to(torch.bfloat16))
            u = m
        delta = cfg.lr * u + cfg.lr * cfg.weight_decay * p.float()
        return (p.float() - delta).to(p.dtype)

    @torch.no_grad()
    def update(grads: Grads, state: OptState, params: List[Leaf]
               ) -> Tuple[List[Leaf], OptState]:
        step = state.step + 1
        t = step.float()
        beta2 = 1.0 - t ** -cfg.decay
        for leaf, gs, st in zip(params, grads, state.inner):
            g = torch.stack(list(gs)) if leaf.stacked else gs[0]
            leaf.assign(upd(leaf.value(), g, st, beta2))
        return params, OptState(step=step, inner=state.inner)

    return init, update


def make_optimizer(name: str, lr: Optional[float] = None):
    """'adamw' | 'adafactor' factory used by configs and the launcher."""
    if name == "adamw":
        cfg = AdamWConfig(lr=lr) if lr else AdamWConfig()
        return adamw(cfg)
    if name == "adafactor":
        cfg = AdafactorConfig(lr=lr) if lr else AdafactorConfig()
        return adafactor(cfg)
    raise ValueError(f"unknown optimizer {name}")


def optimizer_for_config(model_cfg) -> str:
    """1T/400B-class models need factored state to fit device memory."""
    return "adafactor" if model_cfg.param_count() > 100e9 else "adamw"
