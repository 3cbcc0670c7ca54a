"""Model-layer entry points around the kernels.

They hand the model's tensors to the kernels; K2 and K3 take the model's
(B, S, H, ·) layout as it comes, at its strides (slices of a fused
projection, views of the convolution's output), so no layout copy is made
around them on the ``sm90`` route. Each kernel is
called as an attribute of this module, so a caller can swap in its plain
version; callers in turn call these entry points as attributes of this
module (the runtime's Worker calls :func:`quantize_rows`).

Gradients: attention is differentiable through
:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn` (K2's
forward and its backward kernel), the SSD scan through
:class:`~repro_torch.kernels.ssd_scan.SsdScanFn` (K3's forward and its
backward kernel), each taken when grad mode is on and an input requires a
gradient; serving stays on the plain forward call. The MoE layer's
dispatch and combine (B2, :func:`fill_expert_slots` and
:func:`combine_expert_rows`) likewise take
:class:`~repro_torch.kernels.moe_dispatch.MoeFillFn` and
:class:`~repro_torch.kernels.moe_dispatch.MoeCombineFn` (B2's forward
kernels and their adjoint kernels) under grad on the card and on the CPU
(plain forwards and plain backwards there); meta tensors (the dry run)
keep the plain forwards, which autograd differentiates. So do every
RMSNorm (B4, :func:`rms_norm`, through
:class:`~repro_torch.kernels.rms_norm.RmsNormFn`), Mamba2's gated norm
(:func:`gated_rms_norm`, :class:`~repro_torch.kernels.rms_norm.GatedRmsNormFn`)
and its causal convolution (B5, :func:`causal_conv1d`,
:class:`~repro_torch.kernels.causal_conv.CausalConv1dFn`), the training
loss (B6, :func:`cross_entropy_loss`,
:class:`~repro_torch.kernels.cross_entropy.CrossEntropyFn`), RoPE of q
and k (B7, :func:`rope_qk`, :class:`~repro_torch.kernels.rope.RopeFn`)
and SwiGLU's gate ``silu(g)·u`` (B8, :func:`silu_mul`,
:class:`~repro_torch.kernels.swiglu.SwigluFn`); meta tensors (the dry
run) keep their eager chains. The int8 quantizer
is on no training path and has no backward: a CUDA input that requires a
gradient raises (its output would carry no ``grad_fn`` and the gradient
would be lost). On the CPU its plain version is ordinary differentiable
PyTorch.

On a mesh (``DTensor`` inputs) each kernel runs on every device's shards
(``local_map``). Batch and heads stay sharded as they come where the
kernel's arithmetic allows it (k/v heads sharded like q's; SSM groups
sharded like the heads, or a single group replicated; a norm's rows; the
convolution's channels); a mesh dim that shards anything else is gathered
first (decode over a cache whose
sequence is sharded does not come here: ``models.attention`` reduces its
softmax across the pieces). ``DTensor`` is never asked to flatten two
sharded dims into the kernels' (batch·heads) layout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .causal_conv import CausalConv1dFn, causal_conv1d_fwd, causal_conv1d_plain
from .cross_entropy import CrossEntropyFn, cross_entropy_fwd, cross_entropy_plain
from .flash_attention import FlashAttentionFn, flash_attention
from .int8_quant import quantize_int8
from .moe_dispatch import MoeCombineFn, MoeFillFn, moe_combine, moe_fill
from .rms_norm import (GatedRmsNormFn, RmsNormFn, gated_rms_norm_fwd, gated_rms_norm_plain,
                       rms_norm_fwd, rms_norm_plain)
from .rope import RopeFn, rope_plain, rope_qk_fwd
from .ssd_scan import SsdScanFn, ssd_scan
from .swiglu import SwigluFn, swiglu_fwd, swiglu_plain


def _no_cuda_grad(name: str, later: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raises for a CUDA input that requires a gradient under grad mode: the
    kernel has no backward, and its output would silently drop it."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.is_cuda and t.requires_grad:
            raise NotImplementedError(
                f"{name}: its kernel has no backward on the card ({later}); "
                f"run it under torch.no_grad(), or on the CPU")


def _is_dtensor(t: Optional[torch.Tensor]) -> bool:
    return t is not None and type(t) is not torch.Tensor and hasattr(t, "device_mesh")


def _on_shards(fn, args, placements, out_placements):
    """``fn`` on the local shards of DTensor ``args`` (None passes through),
    each first redistributed to its ``placements``."""
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if a is not None).device_mesh
    args = [None if a is None else a.redistribute(mesh, p) for a, p in zip(args, placements)]
    return local_map(fn, out_placements=out_placements,
                     in_placements=[None if a is None else p for a, p in zip(args, placements)],
                     device_mesh=mesh)(*args)


def attention_on_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` for (B, S, H, hd) DTensors on each device's shards:
    per mesh dim, the batch (dim 0) or the heads (dim 2, k/v's kv heads
    sharded alike) stay sharded. Where only one mesh dim shards q's heads
    and k/v are replicated over it, q's heads stay sharded too when each
    device's block of q heads lies in one kv head's group (the block divides
    the group, as GSPMD splits H = Kv·g): the device takes that kv head of
    k and v, and their gradients are summed over the dim. Anything else, a
    sharded sequence included, is gathered first."""
    from torch.distributed.tensor import Replicate, Shard

    from ..sharding.collectives import summing_grads
    mesh = q.device_mesh
    h, g = q.shape[2], q.shape[2] // k.shape[2]
    r = Replicate()
    kept = [p if p in (Shard(0), Shard(2)) and p == pk == pv else r
            for p, pk, pv in zip(q.placements, k.placements, v.placements)]
    heads = [i for i, p in enumerate(q.placements) if p == Shard(2)]
    if (len(heads) == 1 and kept[heads[0]] == r and k.placements[heads[0]] == r
            and v.placements[heads[0]] == r and h % mesh.size(heads[0]) == 0
            and g % (h // mesh.size(heads[0])) == 0):
        dim = heads[0]
        kv_kept = list(kept)
        kept[dim] = Shard(2)

        def sliced(q, k, v):
            kv = mesh.get_local_rank(dim) * q.shape[2] // g
            k, v = (summing_grads(t, mesh, [dim]) for t in (k, v))
            return fn(q, k[:, :, kv:kv + 1], v[:, :, kv:kv + 1])
        return _on_shards(sliced, [q, k, v], [kept, kv_kept, kv_kept], kept)
    return _on_shards(fn, [q, k, v], [kept] * 3, kept)


def flash_attention_bshd(
    q: torch.Tensor,                     # (B, Sq, H, hd)
    k: torch.Tensor,                     # (B, Sk, Kv, hd)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA flash attention on (B, S, H, hd) as the model made them, at their
    strides; returns a contiguous (B, Sq, H, hd), so the output projection's
    reshape is a view."""
    if _is_dtensor(q):
        return attention_on_shards(
            lambda q, k, v: flash_attention_bshd(q, k, v, causal, window, q_offset), q, k, v)
    g = q.shape[2] // k.shape[2]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, g, causal, window, q_offset)
    return flash_attention(q, k, v, q_heads_per_kv=g, causal=causal, window=window,
                           q_offset=q_offset)


def ssd_bshp(
    x: torch.Tensor,                     # (B, S, H, P)
    dt: torch.Tensor,                    # (B, S, H) f32
    A: torch.Tensor,                     # (H,) f32
    Bm: torch.Tensor,                    # (B, S, G, N)
    Cm: torch.Tensor,                    # (B, S, G, N)
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD on (B, S, H, P) + groups, x, dt, B and C read as the model
    made them, at their strides (x, B and C views of the convolution's
    output); returns (y (B, S, H, P), a view of a contiguous (B, H, S, P),
    final state (B, H, P, N) f32). The groups are not broadcast to heads:
    head h reads group ``h // (H // G)``."""
    if _is_dtensor(x):
        return _ssd_on_shards(x, dt, A, Bm, Cm, chunk, initial_state)
    b, h = x.shape[0], x.shape[2]
    g = h // Bm.shape[2]
    Af = A.repeat(b)
    init = None
    if initial_state is not None:        # a stateful prefill's (B, H, P, N) state
        init = initial_state.transpose(2, 3).contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, A, Bm, Cm, initial_state)):
        y, state = SsdScanFn.apply(x, dt, Af, Bm, Cm, chunk, g, init)
    else:
        y, state = ssd_scan(x, dt, Af, Bm, Cm, chunk=chunk, heads_per_group=g,
                            initial_state=init)
    return y, state.transpose(2, 3)


def _ssd_on_shards(x, dt, A, Bm, Cm, chunk, initial_state):
    """:func:`ssd_bshp` on the shards: per mesh dim, the batch (x's dim 0)
    or the heads (x's dim 2, with the groups sharded alike or a single
    group replicated) stay sharded; heads that arrive replicated are split
    over one mesh dim that they divide (a local slice: the scan is not
    repeated on its ranks); anything else is gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from ..sharding.collectives import summing_grads
    r = Replicate()
    mesh = x.device_mesh
    per_dim = []                         # (x, dt, A, B, C, init, y, state) per mesh dim
    a_sum, bc_sum = [], []               # dims over which A's, or B's and C's, gradient is a part
    h, g = x.shape[2], Bm.shape[2]
    split = Shard(2) in x.placements     # the heads split over a mesh dim already
    for i, p in enumerate(x.placements):
        n = mesh.size(i)
        heads = p == Shard(2) or (p == r and not split and h % n == 0)
        if p == Shard(0):
            per_dim.append((p, p, r, p, p, p, p, p))
            a_sum.append(i)
        elif heads and (g == 1 or g % n == 0):
            split = True
            bc = r if g == 1 else Shard(2)
            hp = Shard(2)
            per_dim.append((hp, hp, Shard(0), bc, bc, Shard(1), hp, Shard(1)))
            if g == 1:
                bc_sum.append(i)
        else:
            per_dim.append((r,) * 8)
    cols = [list(c) for c in zip(*per_dim)]

    def local(x, dt, A, Bm, Cm, init):
        A = summing_grads(A, mesh, a_sum)
        Bm, Cm = (summing_grads(t, mesh, bc_sum) for t in (Bm, Cm))
        return ssd_bshp(x, dt, A, Bm, Cm, chunk, init)
    return _on_shards(local, [x, dt, A, Bm, Cm, initial_state], cols[:6], (cols[6], cols[7]))


def quantize_rows(x: torch.Tensor, out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise int8 quantization of x (R, C): (q int8, scale f32 (R,)); with
    ``out`` (bf16 or f32, shaped like x) the same launch also writes
    ``q * scale[:, None]`` into it."""
    _no_cuda_grad("quantize_rows", "int8 quantization is not on any training path",
                  x, out)
    return quantize_int8(x, out)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q * scale[:, None]`` in f32, rounded once into ``out``'s dtype when given."""
    return torch.mul(q, scale[:, None], out=out)


def fill_expert_slots(rows: torch.Tensor, dest: torch.Tensor, kept: torch.Tensor,
                      cap: int) -> torch.Tensor:
    """The MoE layer's (E, cap, D) expert buffer from the route table: row
    ``dest[t, j]`` holds ``rows[t]`` of ``rows`` (T, D) for each kept
    destination, zeros past each expert's ``kept`` slots."""
    if torch.is_grad_enabled() and rows.requires_grad and not rows.is_meta:
        return MoeFillFn.apply(rows, dest, kept, cap)
    return moe_fill(rows, dest, kept, cap)


def combine_expert_rows(y: torch.Tensor, dest: torch.Tensor, gate: torch.Tensor,
                        expert0: int = 0, kept: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MoE layer's output (T, D): each token's gated rows ``dest`` of the
    experts' output y (E, C, D), added by expert id (y's first expert is
    ``expert0``). Under grad the backward needs ``kept``, each expert's kept
    rows in ``dest`` (the route table's)."""
    if (torch.is_grad_enabled() and (y.requires_grad or gate.requires_grad)
            and not y.is_meta):
        if kept is None:
            raise ValueError("combine_expert_rows: under grad its backward needs kept")
        return MoeCombineFn.apply(y, dest, gate, kept, expert0)
    return moe_combine(y, dest, gate, expert0)


def _norm_on_shards(x, scale, eps):
    """:func:`rms_norm` on the shards: per mesh dim, a sharded dim of x's
    rows (any but the last) stays sharded, ``scale`` is replicated and its
    gradient summed over those mesh dims; the normalised dim is gathered."""
    from torch.distributed.tensor import Replicate, Shard

    from ..sharding.collectives import summing_grads
    mesh, r = x.device_mesh, Replicate()
    kept = [p if isinstance(p, Shard) and p.dim < x.ndim - 1 else r for p in x.placements]
    sums = [i for i, p in enumerate(kept) if p != r]
    return _on_shards(lambda x, scale: rms_norm(x, summing_grads(scale, mesh, sums), eps),
                      [x, scale], [kept, [r] * mesh.ndim], kept)


def _gated_on_shards(y, xh, D, z, scale, eps):
    """:func:`gated_rms_norm` on the shards: per mesh dim, the batch or the
    sequence (dim 0 or 1, sharded alike in y, xh and z) stays sharded, D
    and ``scale`` are replicated and their gradients summed over those mesh
    dims; the heads, which the norm spans, are gathered."""
    from torch.distributed.tensor import Replicate, Shard

    from ..sharding.collectives import summing_grads
    mesh, r = z.device_mesh, Replicate()
    kept = [p if p in (Shard(0), Shard(1)) and p == py == px else r
            for p, py, px in zip(z.placements, y.placements, xh.placements)]
    sums = [i for i, p in enumerate(kept) if p != r]

    def local(y, xh, D, z, scale):
        D, scale = (summing_grads(t, mesh, sums) for t in (D, scale))
        return gated_rms_norm(y, xh, D, z, scale, eps)
    reps = [r] * mesh.ndim
    return _on_shards(local, [y, xh, D, z, scale], [kept, kept, reps, kept, reps], kept)


def _conv_on_shards(x, w, b, state):
    """:func:`causal_conv1d` on the shards: per mesh dim, the batch (x's and
    the state's dim 0; w and b replicated, their gradients summed over it)
    or the channels (dim 2, w's and b's sharded alike) stay sharded; the
    sequence, which the taps span, is gathered."""
    from torch.distributed.tensor import Replicate, Shard

    from ..sharding.collectives import summing_grads
    mesh, r = x.device_mesh, Replicate()
    xs, ws, bs, sums = [], [], [], []
    for i, p in enumerate(x.placements):
        if p == Shard(0):
            sums.append(i)
        p = p if p in (Shard(0), Shard(2)) else r
        xs.append(p)
        ws.append(Shard(1) if p == Shard(2) else r)
        bs.append(Shard(0) if p == Shard(2) else r)

    def local(x, w, b, state):
        w, b = (summing_grads(t, mesh, sums) for t in (w, b))
        return causal_conv1d(x, w, b, state)
    return _on_shards(local, [x, w, b, state], [xs, ws, bs, xs], (xs, xs))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over x's last dim (B4): f32 statistics, cast to x's dtype,
    then times ``scale``. Under grad :class:`RmsNormFn` (the forward kernel
    keeping each row's rstd, the adjoint kernel as its backward), else the
    forward kernel alone; on the CPU their plain versions. Meta tensors
    keep the eager chain; a ``DTensor`` runs on its shards."""
    if x.is_meta:
        return rms_norm_plain(x, scale, eps)
    if _is_dtensor(x):
        return _norm_on_shards(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RmsNormFn.apply(x, scale, eps)
    return rms_norm_fwd(x, scale, eps)[0]


def gated_rms_norm(y: torch.Tensor, xh: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                   scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's gated norm (B4's gated form): ``rms_norm((y + xh·D)·silu(z))``
    with the reference's roundings, y and xh (B, S, H, P) (y the SSD scan's
    output where it lies, f32 at decode), D (H,) f32, z (B, S, H·P); returns
    (B, S, H·P) in z's dtype. Under grad :class:`GatedRmsNormFn`, else the
    forward kernel; on the CPU their plain versions. Meta tensors keep the
    eager chain; ``DTensor``s run on their shards."""
    if z.is_meta:
        return gated_rms_norm_plain(y, xh, D, z, scale, eps)
    if _is_dtensor(z):
        return _gated_on_shards(y, xh, D, z, scale, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, xh, D, z, scale)):
        return GatedRmsNormFn.apply(y, xh, D, z, scale, eps)
    return gated_rms_norm_fwd(y, xh, D, z, scale, eps)[0]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's causal depthwise convolution (B5) over x (B, S, C) read at
    its strides: (silu of the W taps plus the bias, the new (B, W-1, C)
    state). Under grad :class:`CausalConv1dFn`, else the forward kernel; on
    the CPU their plain versions. Meta tensors keep the eager chain;
    ``DTensor``s run on their shards."""
    if x.is_meta:
        return causal_conv1d_plain(x, w, b, state)
    if _is_dtensor(x):
        return _conv_on_shards(x, w, b, state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w, b, state)):
        return CausalConv1dFn.apply(x, w, b, state)
    return causal_conv1d_fwd(x, w, b, state)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean softmax cross-entropy of logits (..., V) at int64 labels
    (B6): f32 log-sum-exp a row, minus the label's logit, averaged. Under
    grad :class:`CrossEntropyFn` (the forward kernel keeping each row's lse,
    the adjoint kernel as its backward), else the forward kernel and
    ``torch.mean`` of its rows; on the CPU their plain versions. Meta
    tensors and ``DTensor``s keep the eager chain (a mesh's loss is
    ``launch.steps.cross_entropy``'s one-hot form)."""
    if logits.is_meta or _is_dtensor(logits):
        return cross_entropy_plain(logits, labels)
    if torch.is_grad_enabled() and logits.requires_grad:
        return CrossEntropyFn.apply(logits, labels)
    return cross_entropy_fwd(logits, labels)[1].mean()


def _rope_on_shards(q, k, positions, theta):
    """:func:`rope_qk` on the shards: per mesh dim, the batch or the
    sequence (dims 0, 1) stay sharded where q and k are sharded alike, the
    positions then sharded with them; the heads (dim 2) stay sharded as
    each of q and k has them, the positions replicated; anything else is
    gathered. Plain positions (a mesh step's ``arange``) are taken as
    replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, r = q.device_mesh, Replicate()
    if not _is_dtensor(positions):
        positions = DTensor.from_local(positions, mesh, [r] * mesh.ndim, run_check=False)
    qs, ks, ps = [], [], []
    for i, pq in enumerate(q.placements):
        pk = pq if k is None else k.placements[i]
        if pq == pk and pq in (Shard(0), Shard(1)):
            qs.append(pq), ks.append(pq), ps.append(pq)
        else:
            qs.append(pq if pq == Shard(2) else r)
            ks.append(pk if pk == Shard(2) else r)
            ps.append(r)

    def local(q, k, positions):
        return rope_qk(q, k, positions, theta)
    return _on_shards(local, [q, k, positions], [qs, ks, ps], (qs, None if k is None else ks))


def rope_qk(q: torch.Tensor, k: Optional[torch.Tensor], positions: torch.Tensor,
            theta: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Half-split RoPE of q (B, S, Hq, hd) and k (B, S, Hk, hd) (or None) at
    positions broadcastable to (B, S), in one launch (B7): (q rotated, k
    rotated). Under grad :class:`RopeFn` (the kernel, then its adjoint
    mode), else the kernel; on the CPU the plain version. Meta tensors keep
    the eager chain, q's then k's; ``DTensor``s run on their shards."""
    if q.is_meta:
        return rope_plain(q, positions, theta), (None if k is None
                                                 else rope_plain(k, positions, theta))
    if _is_dtensor(q):
        return _rope_on_shards(q, k, positions, theta)
    if torch.is_grad_enabled() and (q.requires_grad or (k is not None and k.requires_grad)):
        return RopeFn.apply(q, k, positions, theta)
    return rope_qk_fwd(q, k, positions, theta)


def _silu_on_shards(g, u):
    """:func:`silu_mul` on the shards: every mesh dim keeps g's placement
    (an elementwise gate splits as its operands do; column-parallel
    products give g and u alike), u redistributed to it where it differs;
    a partial sum, which SiLU cannot take, is reduced first."""
    from torch.distributed.tensor import Replicate
    kept = [Replicate() if p.is_partial() else p for p in g.placements]
    return _on_shards(silu_mul, [g, u], [kept, kept], kept)


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """SwiGLU's gate ``silu(g) · u`` (B8) for g and u of one shape and
    dtype. Under grad :class:`SwigluFn` (the forward kernel, the adjoint
    kernel as its backward), else the forward kernel; on the CPU their
    plain versions. Meta tensors keep the eager chain; ``DTensor``s run on
    their shards with g's placements (:func:`_silu_on_shards`)."""
    if g.is_meta:
        return swiglu_plain(g, u)
    if _is_dtensor(g):
        return _silu_on_shards(g, u)
    if torch.is_grad_enabled() and (g.requires_grad or u.requires_grad):
        return SwigluFn.apply(g, u)
    return swiglu_fwd(g, u)
