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

Layout: q (BH, Sq, hd), k/v (BH / q_heads_per_kv, Sk, hd); row i of q reads
kv row ``i // q_heads_per_kv`` (GQA). Scale ``hd ** -0.5``; masked scores are
the finite ``-1e30``; the output is ``acc / max(l, 1e-30)`` in q's dtype.
The ``sm90`` kernel rounds P to bf16 before P·V, as FlashAttention-2/3 and
SDPA do; the plain version keeps P in f32.

A CPU tensor goes to :func:`flash_attention_plain`; a CUDA tensor goes to a
kernel or raises. ``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_by_route`` splits them by route, under a lock.

Training: with ``return_lse=True`` the forward also returns each query
row's log-sum-exp (f32 (BH, Sq), natural log; exactly ``NEG_INF`` for a row
with no unmasked key). :func:`flash_attention_bwd` is the gradient as a
third CUDA kernel, ``csrc/flash_attention_bwd.cu`` (f32 and bf16, CUDA
cores), with :func:`flash_attention_bwd_plain` beside it, and
:class:`FlashAttentionFn` ties the two directions together for autograd.
The TPU package has no backward kernel: XLA differentiates its pure-jnp
``blockwise_attention`` (``src/repro/models/attention.py``).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from .build import load_library

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
    """
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
    Returns (dq, dk, dv).
    """
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
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"want q (BH,Sq,hd), k = v (BKv,Sk,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, hd = q.shape
    if g < 1 or bh != k.shape[0] * g or k.shape[2] != hd:
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
    """Fused attention over flattened (batch×heads) leading dims; with
    ``return_lse``, (out, lse (BH, Sq) f32)."""
    g = q_heads_per_kv
    _check(q, k, v, g)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_heads_per_kv=g, causal=causal,
                                     window=window, q_offset=q_offset,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(_route(q.dtype, q.shape[2]), q, k, v, g, causal, window, q_offset,
                   return_lse)


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


def _launch(route: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int,
            causal: bool, window: Optional[int], q_offset: int, return_lse: bool = False):
    """Checks what the kernel of ``route`` takes, then launches it on q's stream."""
    bh, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if route == "sm90" and q.dtype != torch.bfloat16:
        raise ValueError(f"the sm90 kernel takes bf16, got {q.dtype}")
    _check_cuda_operands(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    params = (bh, sq, k.shape[1], hd, g, int(causal), int(window is not None),
              int(window or 0), int(q_offset), hd ** -0.5, stream)
    if route == "sm90":
        lib = _lib_sm90()
        err = lib.flash_attention_sm90_fwd(*args, *params)
        error_string = lib.flash_attention_sm90_error_string
    else:
        lib = _lib()
        err = lib.flash_attention_fwd(*args, _DTYPE_CODE[q.dtype], *params)
        error_string = lib.flash_attention_error_string
    if err != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"{error_string(err).decode()} ({err})")
    _count_launch(route)
    return out if lse is None else (out, lse)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)


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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
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
    launches ``csrc/flash_attention_bwd.cu`` (f32 or bf16, head dims
    ``HEAD_DIMS``) or raises. ``flash_attention_bwd.launches`` counts calls
    that launched it, under the forward's lock.
    """
    g = q_heads_per_kv
    _check(q, k, v, g)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must match q {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} {do.dtype}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {tuple(q.shape[:2])}, got {tuple(lse.shape)} {lse.dtype}")
    if not (o.device == lse.device == do.device == q.device):
        raise ValueError("q, o, lse and do on different devices")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, q_heads_per_kv=g, causal=causal,
                                         window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bh, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    _check_cuda_operands(q=q, k=k, v=v, o=o, lse=lse, do=do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _lib_bwd()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype],
        bh, sq, k.shape[1], hd, g, int(causal), int(window is not None), int(window or 0),
        int(q_offset), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"{lib.flash_attention_bwd_error_string(err).decode()} ({err})")
    with _LAUNCH_LOCK:
        flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


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


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` for autograd: the forward is K2 with its
    log-sum-exp saved, the backward :func:`flash_attention_bwd`. On the CPU
    both directions take their plain versions inside this same Function."""

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
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None
