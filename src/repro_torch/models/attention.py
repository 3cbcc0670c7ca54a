"""Attention: GQA with RoPE / qk-norm / QKV-bias / sliding window.

Port of ``repro.models.attention``. The prefill path,
:func:`blockwise_attention`, is the flash kernel
(:func:`repro_torch.kernels.ops.flash_attention_bshd`); the reference's
pure-jnp blockwise loop is that kernel's oracle. :func:`cross_attention`
takes the same kernel, non-causal with Sq ≠ Sk. The projections and decode
attention stay plain PyTorch, as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from ..sharding import collectives as coll
from ..sharding.context import matmul
from .layers import rms_norm

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one (D, H·hd) product."""
    d, h, hd = w.shape
    return matmul(x, w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def project_qkv(
    params: Params,
    x: torch.Tensor,                     # (B, S, D)
    positions: torch.Tensor,             # (B, S)
    rope_theta: float = 10_000.0,
    qk_norm: bool = False,
    use_rope: bool = True,
    norm_eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if qk_norm:                          # per head over hd, before RoPE
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    if use_rope:                         # q and k in one launch (B7)
        q, k = ops.rope_qk(q, k, positions, rope_theta)
    return q, k, v


def blockwise_attention(
    q: torch.Tensor,                     # (B, Sq, H, hd)
    k: torch.Tensor,                     # (B, Sk, Kv, hd)
    v: torch.Tensor,                     # (B, Sk, Kv, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    q_block: int = 256,
    kv_block: int = 256,
) -> torch.Tensor:
    """Flash attention; returns (B, Sq, H, hd).

    ``q_offset`` is the absolute position of q[0] relative to k[0];
    ``window``: attend only to keys within ``window`` positions behind the
    query. ``q_block``/``kv_block`` keep the reference's signature; the
    kernel picks its own tiles.
    """
    return ops.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)


def attention_output(params: Params, attn: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one (H·hd, D) product."""
    h, hd, d = params["wo"].shape
    return matmul(attn.flatten(-2), params["wo"].reshape(h * hd, d))


def decode_attention(
    q: torch.Tensor,                     # (B, 1, H, hd)
    cache_k: torch.Tensor,               # (B, S, Kv, hd)
    cache_v: torch.Tensor,
    cache_len: int,                      # valid slots
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-token attention over the KV cache, GQA kept grouped.

    With a window, only the last ``window`` slots ending at ``cache_len``
    are read (the caller keeps the cache as a ring buffer). On a mesh whose
    cache has its sequence sharded, :func:`decode_device_body` on every
    device; otherwise attention on the shards of batch and heads.
    """
    if ops._is_dtensor(q):
        from torch.distributed.tensor import Shard
        if any(p == Shard(1) for p in cache_k.placements):
            return _decode_on_mesh(q, cache_k, cache_v, cache_len, window)
        return ops.attention_on_shards(
            lambda q, k, v: decode_attention(q, k, v, cache_len, window), q, cache_k, cache_v)
    b, sq, h, hd = q.shape
    kv = cache_k.shape[2]
    g = h // kv
    scale = hd ** -0.5
    if window is not None and cache_k.shape[1] > window:
        # clamped into range, as jax.lax.dynamic_slice does
        start = min(max(cache_len - window, 0), cache_k.shape[1] - window)
        cache_k = cache_k[:, start:start + window]
        cache_v = cache_v[:, start:start + window]
        valid = torch.arange(cache_k.shape[1], device=q.device) < min(cache_len, window)
    else:
        valid = torch.arange(cache_k.shape[1], device=q.device) < cache_len
    qg = q.reshape(b, sq, kv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), cache_k.float()) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cache_v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def write_slot(cache: torch.Tensor, pos: int, value: torch.Tensor) -> None:
    """``cache[:, pos] = value`` for a (B, S, Kv, hd) cache and a (B, Kv,
    hd) value. On a mesh whose cache has its slots sharded, only the device
    holding slot ``pos`` writes it, at its place in that device's piece
    (``DTensor`` would write the local index ``pos`` of every piece)."""
    from torch.distributed.tensor import Replicate, Shard
    if not ops._is_dtensor(cache) or Shard(1) not in cache.placements:
        cache[:, pos] = value
        return
    mesh = cache.device_mesh
    piece = coll.flat_rank(mesh, [i for i, p in enumerate(cache.placements) if p == Shard(1)])
    pv = [Replicate() if p == Shard(1) else Shard(max(p.dim - 1, 0)) if p.is_shard() else p
          for p in cache.placements]
    local = value.redistribute(mesh, pv).to_local()
    mine = cache.to_local()
    at = pos - piece * mine.shape[1]
    if 0 <= at < mine.shape[1]:
        mine[:, at] = local


def valid_slots(offset: int, slots: int, total: int, cache_len: int,
                window: Optional[int], device=None) -> torch.Tensor:
    """Which of the cache slots ``offset .. offset + slots`` of ``total``
    :func:`decode_attention` reads: the first ``cache_len``, or with a
    window the ``min(cache_len, window)`` from its clamped start."""
    pos = offset + torch.arange(slots, device=device)
    if window is not None and total > window:
        start = min(max(cache_len - window, 0), total - window)
        return (pos >= start) & (pos < start + min(cache_len, window))
    return pos < cache_len


def decode_device_body(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                       cache_len: int, window: Optional[int], offset: int,
                       total: int) -> coll.Body:
    """:func:`decode_attention` on one device's piece of a cache whose
    sequence is sharded over the group "seq" (``collectives`` generator):
    its slots ``offset ..`` of ``total``, masked at their global positions;
    its row max, exp-sums and unnormalised p·V; then a max all-reduce of the
    (B, 1, H) maxima and sum all-reduces of the rescaled (B, 1, H) sums and
    (B, 1, H, hd) partials. Equal to the whole cache's softmax within f32
    rounding. Returns (B, 1, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    kv = cache_k.shape[2]
    g = h // kv
    valid = valid_slots(offset, cache_k.shape[1], total, cache_len, window, q.device)
    qg = q.reshape(b, sq, kv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), cache_k.float()) * hd ** -0.5
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    top = yield coll.reduce(m, "seq", op="max")
    w = torch.exp(m - top)                                          # (b, kv, g, q, 1)
    den = yield coll.reduce(e.sum(dim=-1, keepdim=True) * w, "seq")
    num = torch.einsum("bhgqk,bkhd->bhgqd", e, cache_v.float()) * w
    num = yield coll.reduce(num, "seq")
    out = (num / den).permute(0, 3, 1, 2, 4)                        # (b, q, kv, g, hd)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _decode_on_mesh(q, cache_k, cache_v, cache_len: int, window: Optional[int]):
    """:func:`decode_device_body` on each device's shards: per mesh dim, a
    sequence-sharded cache keeps its slots there (q replicated, the
    softmax's stats and partials all-reduced over it); batch or heads
    sharded alike in q and the cache stay so; anything else is gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    r = Replicate()
    seq, pq, pkv = [], [], []
    for i, (p, pk, pv) in enumerate(zip(q.placements, cache_k.placements, cache_v.placements)):
        if pk == pv == Shard(1):
            seq.append(i)
            pq.append(r)
            pkv.append(pk)
        elif p in (Shard(0), Shard(2)) and p == pk == pv:
            pq.append(p)
            pkv.append(p)
        else:
            pq.append(r)
            pkv.append(r)
    total = cache_k.shape[1]

    def local(q, k, v):
        body = decode_device_body(q, k, v, cache_len, window,
                                  coll.flat_rank(mesh, seq) * k.shape[1], total)
        return coll.on_mesh(body, mesh, {"seq": seq})
    return local_map(local, out_placements=pq, in_placements=(pq, pkv, pkv),
                     device_mesh=mesh)(q.redistribute(mesh, pq), cache_k.redistribute(mesh, pkv),
                                       cache_v.redistribute(mesh, pkv))


def cross_attention(
    params: Params,
    x: torch.Tensor,                     # (B, S, D)
    kv_src: torch.Tensor,                # (B, T, D) encoder or image embeddings
    norm_eps: float = 1e-5,
    qk_norm: bool = False,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Cross-attention: no RoPE on keys from another modality; the output
    is scaled by ``tanh(attn_gate)`` where the block has a gate. ``kv``:
    the keys and values of ``kv_src`` where the caller has them already
    (before ``k_norm``)."""
    q = _proj(x, params["wq"])
    k, v = kv if kv is not None else (_proj(kv_src, params["wk"]), _proj(kv_src, params["wv"]))
    if qk_norm:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    y = attention_output(params, blockwise_attention(q, k, v, causal=False))
    if "attn_gate" in params:
        y = torch.tanh(params["attn_gate"]) * y
    return y
