"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``src/repro/kernels/flash_attention.py``. The kernel is
``csrc/flash_attention.cu`` (CUDA C++ for sm_90a, built by
:mod:`repro_torch.kernels.build`); its header says what bounds it on the
H100 and what its design does about that.

Layout: q (BH, Sq, hd), k/v (BH / q_heads_per_kv, Sk, hd); row i of q reads
kv row ``i // q_heads_per_kv`` (GQA). Scale ``hd ** -0.5``; masked scores are
the finite ``-1e30``; the output is ``acc / max(l, 1e-30)`` in q's dtype.

A CPU tensor goes to :func:`flash_attention_plain`; a CUDA tensor goes to
the kernel or raises. ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import load_library

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: online softmax over kv tiles.

    f32 state (m, l, acc) per query row; every query row at once, one kv
    tile of ``block_k`` keys at a time. Keys past ``Sk`` do not exist here,
    as in the oracle, so a fully masked row averages V over all ``Sk`` keys.
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
    return out.reshape(bh, sq, hd).to(q.dtype)


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


def flash_attention(
    q: torch.Tensor,                     # (BH, Sq, hd)
    k: torch.Tensor,                     # (BKv, Sk, hd)
    v: torch.Tensor,
    *,
    q_heads_per_kv: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Fused attention over flattened (batch×heads) leading dims."""
    g = q_heads_per_kv
    _check(q, k, v, g)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_heads_per_kv=g, causal=causal,
                                     window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bh, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], bh, sq, k.shape[1], hd, g, int(causal),
        int(window is not None), int(window or 0), int(q_offset), hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = _lib().flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib
