"""Mamba2 mixer via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060].

Port of ``repro.models.ssm``. The sequence is split into chunks of length
Q; within a chunk the SSD computes an attention-like quadratic form, and a
(B, H, P, N) state carries across chunks. :func:`mamba2_mixer`'s chunked
scan is the SSD kernel (:func:`repro_torch.kernels.ops.ssd_bshp`);
:func:`ssd_chunked`, the reference's pure-jnp scan, stays here as that
kernel's model-level oracle. The causal convolution is B5 and the gated
norm B4's gated form (:mod:`repro_torch.kernels.ops`); the rest of
:func:`mamba2_decode_step` is plain PyTorch, as the reference leaves it to
XLA.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..sharding.context import matmul
from .layers import dense_init

Params = Dict[str, torch.Tensor]


def init_mamba2(
    gen: torch.Generator,
    d_model: int,
    d_inner: int,
    ssm_state: int,
    ssm_heads: int,
    ssm_groups: int = 1,
    conv_width: int = 4,
    dtype: torch.dtype = torch.float32,
) -> Params:
    dev = gen.device
    gn = ssm_groups * ssm_state
    # in_proj packs [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)]
    proj_out = 2 * d_inner + 2 * gn + ssm_heads
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, (d_model, proj_out), dtype=dtype),
        "conv_w": dense_init(gen, (conv_width, d_inner + 2 * gn), scale=0.5, dtype=dtype),
        "conv_b": torch.zeros((d_inner + 2 * gn,), dtype=dtype, device=dev),
        # A_log, dt_bias and D stay f32 whatever the model's dtype
        "A_log": torch.log(torch.linspace(1.0, 16.0, ssm_heads, **f32)),
        "dt_bias": torch.zeros((ssm_heads,), **f32),
        "D": torch.ones((ssm_heads,), **f32),
        "norm": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (d_inner, d_model), dtype=dtype),
    }


def mamba2_spec() -> Dict[str, Tuple]:
    """Logical axes of :func:`init_mamba2`'s tensors."""
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "D": ("ssm_heads",),
        "norm": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def _split_proj(proj: torch.Tensor, d_inner: int, gn: int, heads: int):
    z = proj[..., :d_inner]
    x = proj[..., d_inner:2 * d_inner]
    b = proj[..., 2 * d_inner:2 * d_inner + gn]
    c = proj[..., 2 * d_inner + gn:2 * d_inner + 2 * gn]
    dt = proj[..., 2 * d_inner + 2 * gn:]
    return z, x, b, c, dt


def _cut_proj(proj: torch.Tensor, d_inner: int, gn: int, heads: int):
    """(z, x|B|C, dt) of the input projection. On a plain tensor one
    ``torch.split``, whose gradient is one ``cat`` of the three (the
    reference splits ``proj`` and concatenates x|B|C, and XLA differentiates
    that as one concatenation; basic slices would each fill a zero tensor
    as wide as ``proj`` and add into it). Meta tensors and ``DTensor``s keep
    the slices (the dry run's op counts, the mesh steps)."""
    if proj.is_meta or ops._is_dtensor(proj):
        z, _, _, _, dt = _split_proj(proj, d_inner, gn, heads)
        # x|B|C are adjacent in proj: one slice, the reference's concatenation
        return z, proj[..., d_inner:2 * d_inner + 2 * gn], dt
    return torch.split(proj, [d_inner, d_inner + 2 * gn, heads], dim=-1)


def _cut_xbc(xbc: torch.Tensor, d_inner: int, gn: int):
    """(x, B, C) of the convolution's output: one ``torch.split`` on a plain
    tensor (its gradient one ``cat``), the slices on meta tensors and
    ``DTensor``s, as :func:`_cut_proj`."""
    if xbc.is_meta or ops._is_dtensor(xbc):
        return xbc[..., :d_inner], xbc[..., d_inner:d_inner + gn], xbc[..., d_inner + gn:]
    return torch.split(xbc, [d_inner, gn, gn], dim=-1)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (B, S, C); returns (silu(y), new_state).

    ``state`` is the trailing (width-1) inputs from the previous call (used
    at decode time); None means zero history. The taps accumulate in x's
    dtype, one rounding per tap, as the reference does: B5
    (:func:`repro_torch.kernels.ops.causal_conv1d`) on the card, its plain
    version (``kernels.causal_conv.causal_conv1d_plain``) on the CPU.
    """
    return ops.causal_conv1d(x, w, b, state)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative sums: out[..., i, j] = sum x[j+1..i]."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,                     # (B, S, H, P)
    dt: torch.Tensor,                    # (B, S, H) softplus-ed step sizes
    A: torch.Tensor,                     # (H,) negative decay rates
    Bm: torch.Tensor,                    # (B, S, G, N)
    Cm: torch.Tensor,                    # (B, S, G, N)
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan, plain. Returns (y (B,S,H,P), final_state (B,H,P,N)).

    The reference's formulation, roundings included (C·Bᵀ in the inputs'
    dtype); the SSD kernel is held to it.
    """
    b, s, h, p = x.shape
    g = Bm.shape[2]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk}")
    reps = h // g
    Bh = torch.repeat_interleave(Bm, reps, dim=2)       # (B, S, H, N)
    Ch = torch.repeat_interleave(Cm, reps, dim=2)
    state = (torch.zeros((b, h, p, Bm.shape[3]), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state)
    ys = []
    for t0 in range(0, s, chunk):
        xq = x[:, t0:t0 + chunk]
        dtq = dt[:, t0:t0 + chunk].float()
        Bq, Cq = Bh[:, t0:t0 + chunk], Ch[:, t0:t0 + chunk]
        dA = dtq * A[None, None, :]                     # (B, Q, H), negative
        dA_cum = torch.cumsum(dA, dim=1)
        total = dA_cum[:, -1]                           # (B, H)
        L = torch.exp(segsum(dA.transpose(1, 2)))       # (B, H, Q, Q)
        scores = torch.einsum("bqhn,bkhn->bhqk", Cq, Bq)
        y_intra = torch.einsum("bhqk,bhqk,bkh,bkhp->bqhp", scores, L, dtq, xq.float())
        y_inter = torch.einsum("bqhn,bhpn,bqh->bqhp", Cq.float(), state, torch.exp(dA_cum))
        decay_to_end = torch.exp(total[:, None, :] - dA_cum)   # (B, Q, H)
        chunk_state = torch.einsum("bqhn,bqh,bqh,bqhp->bhpn",
                                   Bq.float(), decay_to_end, dtq, xq.float())
        state = chunk_state + torch.exp(total)[:, :, None, None] * state
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), state


def mamba2_mixer(
    params: Params,
    xin: torch.Tensor,                   # (B, S, D)
    cfg,
    conv_state: Optional[torch.Tensor] = None,
    ssm_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Full Mamba2 block body (pre-norm residual handled by caller)."""
    d_inner = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    heads = cfg.ssm_heads
    proj = matmul(xin, params["in_proj"])
    z, xbc, dt = _cut_proj(proj, d_inner, gn, heads)
    xbc, new_conv_state = causal_conv1d(xbc, params["conv_w"], params["conv_b"], conv_state)
    x, bm, cm = _cut_xbc(xbc, d_inner, gn)
    b_, s_, _ = x.shape
    xh = x.reshape(b_, s_, heads, cfg.ssm_head_dim)
    bmh = bm.reshape(b_, s_, cfg.ssm_groups, cfg.ssm_state)
    cmh = cm.reshape(b_, s_, cfg.ssm_groups, cfg.ssm_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, new_ssm_state = ops.ssd_bshp(xh, dt, A, bmh, cmh, chunk=min(cfg.ssm_chunk, s_),
                                    initial_state=ssm_state)
    # the skip connection y + xh·D in f32, ·silu(z), the norm: B4's gated form
    y = ops.gated_rms_norm(y, xh, params["D"], z, params["norm"], cfg.norm_eps).to(xin.dtype)
    out = matmul(y, params["out_proj"])
    if return_state:
        return out, (new_conv_state, new_ssm_state)
    return out


def mamba2_decode_step(
    params: Params,
    xin: torch.Tensor,                   # (B, 1, D)
    cfg,
    conv_state: torch.Tensor,            # (B, width-1, d_inner+2GN)
    ssm_state: torch.Tensor,             # (B, H, P, N) f32
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """O(1) single-token recurrent update."""
    d_inner = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    heads = cfg.ssm_heads
    proj = matmul(xin, params["in_proj"])
    z, xbc, dt = _cut_proj(proj, d_inner, gn, heads)
    xbc, new_conv_state = causal_conv1d(xbc, params["conv_w"], params["conv_b"], conv_state)
    x, bm, cm = _cut_xbc(xbc, d_inner, gn)
    b_ = x.shape[0]
    reps = heads // cfg.ssm_groups
    xh = x.reshape(b_, heads, cfg.ssm_head_dim).float()            # S=1 squeezed
    bmh = torch.repeat_interleave(bm.reshape(b_, cfg.ssm_groups, cfg.ssm_state), reps, dim=1)
    cmh = torch.repeat_interleave(cm.reshape(b_, cfg.ssm_groups, cfg.ssm_state), reps, dim=1)
    dt1 = F.softplus(dt.float() + params["dt_bias"])[:, 0]        # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt1 * A[None, :])                            # (B, H)
    # h' = decay * h + dt * B ⊗ x; y = C · h', as broadcast products: an
    # einsum here flattens (B, H) into one dim, which DTensor refuses where
    # both are sharded (torch 2.11)
    outer = (dt1[:, :, None] * xh)[..., None] * bmh.float()[:, :, None, :]
    new_state = decay[:, :, None, None] * ssm_state + outer
    y = (cmh.float()[:, :, None, :] * new_state).sum(dim=-1)       # (B, H, P) f32
    y = ops.gated_rms_norm(y[:, None], x.reshape(b_, 1, heads, cfg.ssm_head_dim),
                           params["D"], z, params["norm"], cfg.norm_eps).to(xin.dtype)
    out = matmul(y, params["out_proj"])
    return out, (new_conv_state, new_state)
