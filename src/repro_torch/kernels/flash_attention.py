"""Flash attention: the CUDA kernels' wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``src/repro/kernels/flash_attention.py``. Two CUDA C++ kernels for sm_90a,
built by :mod:`repro_torch.kernels.build`, take a CUDA call by its dtype
(:func:`_route`):

- bf16 → ``sm90``: ``csrc/flash_attention_sm90.cu``, both products on
  ``wgmma``, K/V tiles by TMA through an mbarrier ring, warp-specialised;
- f32 → ``simt``: ``csrc/flash_attention.cu``, both products on the CUDA
  cores in f32.

Each header says what bounds its kernel on the H100 and what its design
does about that. A bf16 call that the ``sm90`` kernel cannot take raises;
nothing falls back to the other kernel. :func:`_flash_attention_simt`
reaches the ``simt`` kernel at bf16 too, for timing the two designs side by
side; the main path never calls it.

Layouts: the model's q (B, Sq, H, hd) and k/v (B, Sk, H / q_heads_per_kv,
hd), query head h reading kv head ``h // q_heads_per_kv`` (GQA), returning
a contiguous (B, Sq, H, hd); or the flattened q (BH, Sq, hd) and k/v
(BH / q_heads_per_kv, Sk, hd), contiguous, row i of q reading kv row
``i // q_heads_per_kv``. The ``sm90`` kernels read the model's layout in
place at any strides a tensor map takes (:mod:`.layout`) and write their
outputs at the strides of the tensors the wrapper allocates; the ``simt``
kernels and the plain versions take the flattened layout, and the wrapper
copies a (B, S, H, hd) call to it and back (``layout_copies`` counts those
tensors by route). The log-sum-exp is (B·H, Sq) either way, row
``b·H + h``. Scale ``hd ** -0.5``; masked scores are
the finite ``-1e30``; the output is ``acc / max(l, 1e-30)`` in q's dtype.
The ``sm90`` kernel rounds P to bf16 before P·V, as FlashAttention-2/3 and
SDPA do; the plain version keeps P in f32.

A CPU tensor goes to :func:`flash_attention_plain`; a CUDA tensor goes to a
kernel or raises. ``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_by_route`` splits them by route, under a lock;
``flash_attention.layout_copies`` counts the operands and outputs a route
copied to or from its kernel's layout (0 on ``sm90``).

Training: with ``return_lse=True`` the forward also returns each query
row's log-sum-exp (f32 (BH, Sq), natural log; exactly ``NEG_INF`` for a row
with no unmasked key). :func:`flash_attention_bwd` is the gradient, routed
by the same :func:`_route`:

- bf16 → ``sm90``: ``csrc/flash_attention_bwd_sm90.cu``, every product on
  ``wgmma`` (dK/dV in the transposed frame, then dQ), tiles by TMA through
  an mbarrier ring, warp-specialised; P and dS rounded to bf16 before the
  products that take them, as FlashAttention-2/3 and SDPA do;
- f32 → ``simt``: ``csrc/flash_attention_bwd.cu``, CUDA cores in f32.

Both take the same three passes (D = rowsum(dO∘O), dK/dV over all g heads
of a kv tile, dQ) without atomics, so two runs give the same bits. A bf16
call the ``sm90`` backward cannot take raises; nothing falls back.
:func:`_flash_attention_bwd_simt` reaches the ``simt`` backward at bf16 for
timing only. :func:`flash_attention_bwd_plain` is the plain version beside
both, ``flash_attention_bwd.launches`` and ``.launches_by_route`` count
launches, and :class:`FlashAttentionFn` ties the two directions together
for autograd. The TPU package has no backward kernel: XLA differentiates
its pure-jnp ``blockwise_attention`` (``src/repro/models/attention.py``).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .build import load_library
from .layout import bshw_as_rows, count_copies, kernel_strides, rows_to_bshw

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 112, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("sm90", "simt")
_LAUNCH_LOCK = threading.Lock()


def flash_attention_plain(
    q: torch.Tensor,                     # (BH, Sq, hd)
    k: torch.Tensor,                     # (BKv, Sk, hd)
    v: torch.Tensor,
    *,
    q_heads_per_kv: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    block_k: int = 128,
    return_lse: bool = False,
):
    """The kernel's arithmetic in PyTorch: online softmax over kv tiles.

    f32 state (m, l, acc) per query row; every query row at once, one kv
    tile of ``block_k`` keys at a time. Keys past ``Sk`` do not exist here,
    as in the oracle, so a fully masked row averages V over all ``Sk`` keys.
    With ``return_lse`` also returns ``m + log(l)`` per row (BH, Sq), f32.
    A (B, S, H, hd) call runs on its flattened copies and returns a
    contiguous (B, Sq, H, hd).
    """
    if q.dim() == 4:
        res = flash_attention_plain(
            bshw_as_rows(q), bshw_as_rows(k), bshw_as_rows(v), q_heads_per_kv=q_heads_per_kv,
            causal=causal, window=window, q_offset=q_offset, block_k=block_k,
            return_lse=return_lse)
        out, lse = res if return_lse else (res, None)
        out = rows_to_bshw(out, q.shape[2])
        return (out, lse) if return_lse else out
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    g = q_heads_per_kv
    scale = hd ** -0.5
    qf = q.float().reshape(bkv, g * sq, hd)        # rows of one kv head together
    q_pos = q_offset + torch.arange(sq, device=q.device).repeat(g)[:, None]
    m = torch.full((bkv, g * sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros_like(m)
    acc = torch.zeros((bkv, g * sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        s = torch.bmm(qf, kb.transpose(1, 2)) * scale
        k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        mask = torch.ones_like(s[0], dtype=torch.bool)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.bmm(p, vb)
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)
    out = out.reshape(bh, sq, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(m < 0.5 * NEG_INF, NEG_INF, m + torch.log(den))
    return out, lse.reshape(bh, sq)


def flash_attention_bwd_plain(
    q: torch.Tensor,                     # (BH, Sq, hd)
    k: torch.Tensor,                     # (BKv, Sk, hd)
    v: torch.Tensor,
    o: torch.Tensor,                     # (BH, Sq, hd): the forward's output
    lse: torch.Tensor,                   # (BH, Sq) f32: the forward's log-sum-exp
    do: torch.Tensor,                    # (BH, Sq, hd): the output's gradient
    *,
    q_heads_per_kv: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    block_k: int = 128,
):
    """The backward kernel's arithmetic in PyTorch, one kv tile at a time.

    ``P = exp(S·scale - lse)`` recomputed, ``D = rowsum(dO∘O)``,
    ``dV = Pᵀ dO``, ``dS = P∘(dO Vᵀ - D)`` (0 where masked), ``dQ = scale·dS K``,
    ``dK = scale·dSᵀ Q``; all in f32, each gradient rounded once to its
    input's dtype. A row whose ``lse`` is ``NEG_INF`` had no unmasked key and
    averaged V over all ``Sk`` keys: its P is ``1/Sk`` everywhere, its dS 0.
    Returns (dq, dk, dv); contiguous (B, S, ·, hd) for a (B, S, H, hd) call.
    """
    if q.dim() == 4:
        grads = flash_attention_bwd_plain(
            *(bshw_as_rows(t) for t in (q, k, v, o)), lse, bshw_as_rows(do),
            q_heads_per_kv=q_heads_per_kv, causal=causal, window=window, q_offset=q_offset,
            block_k=block_k)
        return tuple(rows_to_bshw(t, h) for t, h in zip(grads, (q.shape[2], k.shape[2],
                                                                k.shape[2])))
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    g = q_heads_per_kv
    scale = hd ** -0.5
    qf = q.float().reshape(bkv, g * sq, hd)
    dof = do.float().reshape(bkv, g * sq, hd)
    dsum = (dof * o.float().reshape(bkv, g * sq, hd)).sum(dim=-1, keepdim=True)
    lse_f = lse.float().reshape(bkv, g * sq, 1)
    dead = lse_f < 0.5 * NEG_INF
    q_pos = q_offset + torch.arange(sq, device=q.device).repeat(g)[:, None]
    dq = torch.zeros((bkv, g * sq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((bkv, sk, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        s = torch.bmm(qf, kb.transpose(1, 2)) * scale
        k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        mask = torch.ones_like(s[0], dtype=torch.bool)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        p_dead = torch.where(dead, 1.0 / sk, 0.0)
        p = torch.where(mask, torch.exp(torch.where(mask, s, 0.0) - lse_f), p_dead)
        dp = torch.bmm(dof, vb.transpose(1, 2))
        ds = torch.where(mask, p * (dp - dsum), 0.0)
        dv[:, k0:k0 + block_k] = torch.bmm(p.transpose(1, 2), dof)
        dk[:, k0:k0 + block_k] = torch.bmm(ds.transpose(1, 2), qf) * scale
        dq += torch.bmm(ds, kb) * scale
    return (dq.reshape(bh, sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share a dtype in {list(_DTYPE_CODE)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() not in (3, 4) or k.dim() != q.dim() or k.shape != v.shape:
        raise ValueError(f"want q (BH,Sq,hd), k = v (BKv,Sk,hd), or q (B,Sq,H,hd), k = v "
                         f"(B,Sk,Kv,hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dim() == 3:
        bh, sq, hd = q.shape
        match = g >= 1 and bh == k.shape[0] * g and k.shape[2] == hd
    else:
        b, sq, h, hd = q.shape
        match = (g >= 1 and b == k.shape[0] and h == k.shape[2] * g and k.shape[3] == hd)
    if not match:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)} "
                         f"with q_heads_per_kv={g}")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes a CUDA call: ``sm90`` for bf16, ``simt`` for f32."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "sm90"
    if dtype == torch.float32:
        return "simt"
    raise TypeError(f"no flash-attention kernel for {dtype}")


def flash_attention(
    q: torch.Tensor,                     # (BH, Sq, hd)
    k: torch.Tensor,                     # (BKv, Sk, hd)
    v: torch.Tensor,
    *,
    q_heads_per_kv: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Fused attention over the model's (B, S, H, hd) layout or the flattened
    (batch×heads) one; with ``return_lse``, (out, lse (B·H, Sq) f32).

    A tensor on the CPU or the card goes to :func:`_direct`; a meta tensor
    (the dry run, on each device's shards) to the custom op
    ``repro_torch::flash_attention``, whose fake kernel gives the outputs'
    shapes and whose FLOP formula the dry run counts."""
    g = q_heads_per_kv
    _check(q, k, v, g)
    if q.device.type != "meta":
        return _direct(q, k, v, g, causal, window, q_offset, return_lse)
    out, lse = torch.ops.repro_torch.flash_attention(q, k, v, g, causal, window, q_offset,
                                                     return_lse)
    return (out, lse) if return_lse else out


def _direct(q, k, v, g, causal, window, q_offset, return_lse):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_heads_per_kv=g, causal=causal, window=window,
                                     q_offset=q_offset, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(_route(q.dtype, q.shape[-1]), q, k, v, g, causal, window, q_offset,
                   return_lse)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int,
                        causal: bool, window: Optional[int], q_offset: int,
                        return_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 as a custom op, for the meta device: :func:`_flash_attention_fake`
    there; elsewhere :func:`_direct`, which :func:`flash_attention` calls
    itself without the dispatcher. Without ``return_lse`` the second output
    is empty."""
    res = _direct(q, k, v, g, causal, window, q_offset, return_lse)
    return res if return_lse else (res, q.new_empty((0,), dtype=torch.float32))


@_flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, g, causal, window, q_offset, return_lse):
    lse_shape = _lse_shape(q) if return_lse else (0,)
    return q.new_empty(q.shape), q.new_empty(lse_shape, dtype=torch.float32)


def _lse_shape(q: torch.Tensor) -> Tuple[int, int]:
    """(B·H, Sq) of either layout."""
    return (q.shape[0], q.shape[1]) if q.dim() == 3 else (q.shape[0] * q.shape[2], q.shape[1])


def _flash_attention_simt(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_heads_per_kv: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The CUDA-core kernel at either dtype, bf16 included; for timing only."""
    _check(q, k, v, q_heads_per_kv)
    if q.device.type != "cuda":
        raise ValueError(f"the simt kernel needs a CUDA tensor, got {q.device}")
    return _launch("simt", q, k, v, q_heads_per_kv, causal, window, q_offset)


def _check_cuda_operands(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _bsh(q: torch.Tensor, g: int) -> Tuple[int, int, int]:
    """(B, Sq, H) of q in either layout: a flattened (BH, Sq, hd) call is
    the (BH / g, Sq, g, hd) layout, one kv head a batch."""
    return (q.shape[0], q.shape[1], q.shape[2]) if q.dim() == 4 else (q.shape[0] // g,
                                                                        q.shape[1], g)


def _launch(route: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int,
            causal: bool, window: Optional[int], q_offset: int, return_lse: bool = False):
    """Checks what the kernel of ``route`` takes, then launches it on q's
    stream. The ``sm90`` kernel reads a (B, S, H, hd) call at its strides and
    writes a contiguous (B, Sq, H, hd); a flattened call must be contiguous.
    The ``simt`` kernel takes the flattened layout only: a (B, S, H, hd) call
    is copied to it and its output back."""
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if route == "sm90" and q.dtype != torch.bfloat16:
        raise ValueError(f"the sm90 kernel takes bf16, got {q.dtype}")
    if route == "simt" and q.dim() == 4:
        rows = [bshw_as_rows(t) for t in (q, k, v)]
        res = _launch(route, *rows, g, causal, window, q_offset, return_lse)
        out, lse = res if return_lse else (res, None)
        o4 = rows_to_bshw(out, q.shape[2])
        count_copies(flash_attention, route, [*zip(rows, (q, k, v)), (o4, out)])
        return (o4, lse) if return_lse else o4
    if q.dim() == 3:
        _check_cuda_operands(q=q, k=k, v=v)
    out = q.new_empty(q.shape)
    lse = (torch.empty(_lse_shape(q), dtype=torch.float32, device=q.device) if return_lse
           else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    if route == "sm90":
        strides = kernel_strides((("q", q, g, True), ("k", k, 1, True), ("v", v, 1, True),
                                  ("o", out, g, True)))
        b, sq, h = _bsh(q, g)
        lib = _lib_sm90()
        err = lib.flash_attention_sm90_fwd(
            *args, strides, b, h, sq, k.shape[1], hd, g, int(causal), int(window is not None),
            int(window or 0), int(q_offset), hd ** -0.5, stream)
        error_string = lib.flash_attention_sm90_error_string
    else:
        bh, sq, _ = q.shape
        lib = _lib()
        err = lib.flash_attention_fwd(*args, _DTYPE_CODE[q.dtype], bh, sq, k.shape[1], hd, g,
                                      int(causal), int(window is not None), int(window or 0),
                                      int(q_offset), hd ** -0.5, stream)
        error_string = lib.flash_attention_error_string
    if err != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"{error_string(err).decode()} ({err})")
    _count_launch(route)
    return out if lse is None else (out, lse)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention.layout_copies = dict.fromkeys(ROUTES, 0)


def _count_launch(route: str) -> None:
    with _LAUNCH_LOCK:
        flash_attention.launches += 1
        flash_attention.launches_by_route[route] += 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_sm90() -> ctypes.CDLL:
    lib = load_library("flash_attention_sm90")
    lib.flash_attention_sm90_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_sm90_fwd.restype = ctypes.c_int
    lib.flash_attention_sm90_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_sm90_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    q_heads_per_kv: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
):
    """(dq, dk, dv) of :func:`flash_attention` from its inputs, its output
    ``o``, its log-sum-exp ``lse`` and the output's gradient ``do``.

    A CPU tensor goes to :func:`flash_attention_bwd_plain`; a CUDA tensor
    launches the backward kernel of ``_route(dtype, hd)`` (bf16 → ``sm90``,
    f32 → ``simt``) or raises. ``flash_attention_bwd.launches`` and
    ``.launches_by_route`` count calls that launched, under the forward's
    lock.
    """
    g = q_heads_per_kv
    _check_bwd(q, k, v, o, lse, do, g)
    if q.device.type != "meta":
        return _direct_bwd(q, k, v, o, lse, do, g, causal, window, q_offset)
    return torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, lse, do, g, causal, window,
                                                     q_offset)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, g: int,
                            causal: bool, window: Optional[int], q_offset: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's backward as a custom op, as :func:`_flash_attention_op`."""
    return _direct_bwd(q, k, v, o, lse, do, g, causal, window, q_offset)


def _direct_bwd(q, k, v, o, lse, do, g, causal, window, q_offset):
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, q_heads_per_kv=g, causal=causal,
                                         window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_bwd(_route(q.dtype, q.shape[-1]), q, k, v, o, lse, do, g, causal, window,
                       q_offset)


@_flash_attention_bwd_op.register_fake
def _flash_attention_bwd_fake(q, k, v, o, lse, do, g, causal, window, q_offset):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_attention_bwd_simt(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    q_heads_per_kv: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
):
    """The CUDA-core backward at either dtype, bf16 included; for timing only."""
    _check_bwd(q, k, v, o, lse, do, q_heads_per_kv)
    if q.device.type != "cuda":
        raise ValueError(f"the simt kernel needs a CUDA tensor, got {q.device}")
    return _launch_bwd("simt", q, k, v, o, lse, do, q_heads_per_kv, causal, window, q_offset)


def _check_bwd(q, k, v, o, lse, do, g: int) -> None:
    _check(q, k, v, g)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must match q {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} {do.dtype}")
    if tuple(lse.shape) != _lse_shape(q) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {_lse_shape(q)}, got {tuple(lse.shape)} {lse.dtype}")
    if not (o.device == lse.device == do.device == q.device):
        raise ValueError("q, o, lse and do on different devices")


def _launch_bwd(route: str, q, k, v, o, lse, do, g: int, causal: bool, window: Optional[int],
                q_offset: int):
    """Checks what the backward kernel of ``route`` takes, then launches it
    on q's stream. As :func:`_launch`: the ``sm90`` kernel reads a (B, S, H,
    hd) call at its strides and writes contiguous (B, S, ·, hd) gradients;
    the ``simt`` kernel takes the flattened layout, copied to and back."""
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if route == "sm90" and q.dtype != torch.bfloat16:
        raise ValueError(f"the sm90 backward takes bf16, got {q.dtype}")
    if route == "simt" and q.dim() == 4:
        ins = (q, k, v, o, do)
        rows = [bshw_as_rows(t) for t in ins]
        grads = _launch_bwd(route, *rows[:4], lse, rows[4], g, causal, window, q_offset)
        outs = [rows_to_bshw(t, h) for t, h in zip(grads, (q.shape[2], k.shape[2], k.shape[2]))]
        count_copies(flash_attention_bwd, route, [*zip(rows, ins), *zip(outs, grads)])
        return tuple(outs)
    if q.dim() == 3:
        _check_cuda_operands(q=q, k=k, v=v, o=o, lse=lse, do=do)
    elif not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    dq, dk, dv = q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr())
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    tail = (int(causal), int(window is not None), int(window or 0), int(q_offset), hd ** -0.5,
            stream)
    if route == "sm90":
        strides = kernel_strides(tuple((name, t, heads, True) for name, t, heads in (
            ("q", q, g), ("k", k, 1), ("v", v, 1), ("o", o, g), ("do", do, g), ("dq", dq, g),
            ("dk", dk, 1), ("dv", dv, 1))))
        b, sq, h = _bsh(q, g)
        lib = _lib_bwd_sm90()
        pad = lib.flash_attention_bwd_sm90_pad()
        # lse·log2(e) and D = rowsum(dO∘O), rows padded to a multiple of pad
        aux = torch.empty(2 * b * h * (-(-sq // pad) * pad), dtype=torch.float32,
                          device=q.device)
        err = lib.flash_attention_bwd_sm90(*ptrs, aux.data_ptr(), *outs, strides, b, h, sq,
                                           k.shape[1], hd, g, *tail)
        error_string = lib.flash_attention_bwd_sm90_error_string
    else:
        bh, sq, _ = q.shape
        lib = _lib_bwd()
        dsum = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_bwd(*ptrs, dsum.data_ptr(), *outs, _DTYPE_CODE[q.dtype], bh,
                                      sq, k.shape[1], hd, g, *tail)
        error_string = lib.flash_attention_bwd_error_string
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd {route} kernel launch failed: "
                           f"{error_string(err).decode()} ({err})")
    _count_bwd_launch(route)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_bwd.layout_copies = dict.fromkeys(ROUTES, 0)


def _count_bwd_launch(route: str) -> None:
    with _LAUNCH_LOCK:
        flash_attention_bwd.launches += 1
        flash_attention_bwd.launches_by_route[route] += 1


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    lib = load_library("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd_sm90() -> ctypes.CDLL:
    lib = load_library("flash_attention_bwd_sm90")
    lib.flash_attention_bwd_sm90.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd_sm90.restype = ctypes.c_int
    lib.flash_attention_bwd_sm90_pad.argtypes = []
    lib.flash_attention_bwd_sm90_pad.restype = ctypes.c_int
    lib.flash_attention_bwd_sm90_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_sm90_error_string.restype = ctypes.c_char_p
    return lib


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` for autograd: the forward is K2 with its
    log-sum-exp saved, the backward :func:`flash_attention_bwd`. On the CPU
    both directions take their plain versions inside this same Function. In
    the model's (B, S, H, hd) layout dO is read as it comes (the output
    projection's gradient) and dq, dk, dv leave contiguous in that layout;
    the flattened layout keeps its contiguous dO."""

    @staticmethod
    def forward(ctx, q, k, v, q_heads_per_kv: int, causal: bool, window: Optional[int],
                q_offset: int):
        out, lse = flash_attention(q, k, v, q_heads_per_kv=q_heads_per_kv, causal=causal,
                                   window=window, q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(q_heads_per_kv=q_heads_per_kv, causal=causal, window=window,
                        q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.dim() == 3:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# what the dry run reads: the work of a call
# ---------------------------------------------------------------------------

def attended_pairs(sq: int, sk: int, causal: bool, window: Optional[int], q_offset: int) -> int:
    """(query, key) pairs the mask keeps for one head: the work K2 needs."""
    p = q_offset + np.arange(sq, dtype=np.int64)            # each query's position
    hi = np.minimum(p, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _pairs_of(q_shape, k_shape, causal, window, q_offset) -> int:
    bh = q_shape[0] * (q_shape[2] if len(q_shape) == 4 else 1)
    return bh * attended_pairs(q_shape[1], k_shape[1], causal, window, q_offset)


def register_flop_formulas() -> None:
    """FLOP formulas of K2's two ops for ``torch.utils.flop_counter``: two
    products of 2·hd FLOPs per attended pair forward, five backward (S, dP,
    dV, dK, dQ, as FlashAttention-2 counts them)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    if torch.ops.repro_torch.flash_attention in flop_registry:
        return

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _fwd(q, k, v, g, causal, window, q_offset, return_lse, *args, **kwargs) -> int:
        return 4 * q[-1] * _pairs_of(q, k, causal, window, q_offset)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
    def _bwd(q, k, v, o, lse, do, g, causal, window, q_offset, *args, **kwargs) -> int:
        return 10 * q[-1] * _pairs_of(q, k, causal, window, q_offset)
