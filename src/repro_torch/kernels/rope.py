"""Rotary position embedding of q and k: the CUDA kernel's wrappers (B7),
its plain PyTorch version and the adjoint.

Replaces no Pallas kernel: the kernel is the counterpart of what XLA fuses
out of the reference's ``repro.models.layers.apply_rope`` (with
``rope_frequencies``), which ``project_qkv`` calls for q and for k, inside
its jitted steps. ``csrc/rope.cu``, CUDA C++ for sm_90a built by
:mod:`repro_torch.kernels.build`, rotates q and k in one launch; its header
says what bounds it (bytes) and what its design does about that.

* :func:`rope_plain`: the eager chain, half-split RoPE of x (..., S, H, hd)
  at positions broadcastable to (..., S) in f32, rounded to x's dtype;
* :func:`rope_bwd_plain`: its gradient as autograd computes it,
  ``dx1 = g1·cos + g2·sin``, ``dx2 = g2·cos − g1·sin``, each product and
  sum rounded on its own, then the cast to x's dtype;
* :func:`rope_qk_fwd` and :func:`rope_qk_bwd` (the kernel, forward and
  adjoint modes): q (B, S, Hq, hd) and k (B, S, Hk, hd) in one launch, k
  optional; every step rounded as the eager chain rounds it, so equal to
  the plain versions bit for bit.

The angles' frequencies are ``rope_frequencies`` on the device (the same
torch ops as the eager chain, so the same bits), made once a (head_dim,
theta, device) and kept (:func:`cached_frequencies`). Training goes
through :class:`RopeFn`; positions get no gradient. A CUDA tensor goes to
the kernel or raises; CPU tensors (the tests) take the plain versions.
Each wrapper counts its launches under a lock, in ``launches`` and in
``launches_by_route``: ``vector`` (16-byte units: hd/2 whole units, every
stride and pointer 16-byte aligned) or ``scalar`` (an element at a time).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .build import load_library, require

ROUTES = ("vector", "scalar")
_DTYPES = (torch.float32, torch.bfloat16)
_POS_DTYPES = (torch.int64, torch.int32)
_MODE_VECTOR, _MODE_DTYPE, _MODE_BWD, _MODE_POS32, _MODE_DEVICE_SHIFT = 1, 2, 4, 8, 8
# csrc/rope.cu: a block of THREADS threads, NI (head, unit) pairs in flight
# a thread; a block takes ITEMS // pairs-a-token tokens, 1..MAX_TB, within
# SMEM bytes of shared memory (cos and sin a frequency, two indices a token)
THREADS, NI, MAX_TB, SMEM = 256, 4, 64, 48 * 1024
ITEMS = THREADS * NI
_LAUNCH_LOCK = threading.Lock()
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_IP = ctypes.POINTER(ctypes.c_int)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """The (hd/2,) f32 frequencies ``1 / theta ** (2i / hd)``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)             # f32, as theta ** f32 array in jnp


@functools.lru_cache(maxsize=64)
def _frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False), torch.no_grad():
        return rope_frequencies(head_dim, theta, device)


def cached_frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` on ``device``, made once a (head_dim, theta,
    device) and kept: the same ops, so the same bits."""
    return _frequencies(head_dim, float(theta), torch.device(device))


def _angles(positions: torch.Tensor, freqs: torch.Tensor):
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rope_plain(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE, the eager chain. x: (..., S, H, hd); positions:
    broadcastable to (..., S)."""
    hd = x.shape[-1]
    cos, sin = _angles(positions, rope_frequencies(hd, theta, x.device))
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_bwd_plain(g: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """The gradient of :func:`rope_plain` by x for the output's gradient g
    (of x's dtype): ``dx1 = g1·cos + g2·sin``, ``dx2 = g2·cos − g1·sin`` in
    f32, rounded to g's dtype."""
    hd = g.shape[-1]
    cos, sin = _angles(positions, rope_frequencies(hd, theta, g.device))
    g1, g2 = torch.chunk(g.float(), 2, dim=-1)
    out = torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin], dim=-1)
    return out.to(g.dtype)


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------

def _count(fn, route: str) -> None:
    with _LAUNCH_LOCK:
        fn.launches += 1
        fn.launches_by_route[route] += 1


def _raise(name: str, err: int) -> None:
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{_lib().rope_error_string(err).decode()} ({err})")


def tokens_a_block(heads: int, units: int, half: int) -> int:
    """Tokens a block takes: about ``ITEMS`` (head, unit) pairs, 1 to
    ``MAX_TB`` tokens, their cos and sin within ``SMEM`` bytes."""
    tb = max(1, min(MAX_TB, ITEMS // max(1, heads * units)))
    return max(1, min(tb, SMEM // (8 * half + 16)))


def rope_checks(q: torch.Tensor, k: Optional[torch.Tensor], positions: torch.Tensor):
    """The kernel's conditions as (ok, message) pairs: q (B, S, Hq, hd) and k
    (B, S, Hk, hd) or None, f32 or bf16 of one dtype, hd even, the last dim
    contiguous; positions int64 or int32 broadcastable to (B, S); one card."""
    if q.dim() != 4 or (k is not None and k.dim() != 4):
        return ((False, "q (B, S, Hq, hd) and k (B, S, Hk, hd)"),)
    b, s, _, hd = q.shape
    pos_ok = positions.dim() <= 2 and all(
        n in (1, want) for n, want in zip(reversed(positions.shape), (s, b)))
    return ((k is None or (k.shape[:2] == (b, s) and k.shape[3] == hd and k.dtype == q.dtype),
             "k of q's (B, S), hd and dtype"),
            (q.dtype in _DTYPES, "q and k f32 or bf16"),
            (hd % 2 == 0 and hd > 0, "hd even"),
            (q.stride(-1) == 1 and (k is None or k.stride(-1) == 1), "the last dims contiguous"),
            (positions.dtype in _POS_DTYPES and pos_ok,
             "positions int64 or int32, broadcastable to (B, S)"),
            (positions.get_device() == q.get_device()
             and (k is None or k.get_device() == q.get_device()), "one device"))


def _mode(vector: bool, dtype: torch.dtype, bwd: bool, pos32: bool, device: int) -> int:
    return (int(vector) * _MODE_VECTOR | (_MODE_DTYPE if dtype == torch.bfloat16 else 0)
            | (_MODE_BWD if bwd else 0) | (_MODE_POS32 if pos32 else 0)
            | device << _MODE_DEVICE_SHIFT)


# the layouts that passed the checks, keyed by (name, theta, q's, k's and the
# positions' shape, strides, dtype and device): (B, S, Hq, Hk, hd/2, the
# strides as the kernel takes them, whether the shape takes 16-byte units,
# tokens a block on each route, the mode bits of each route, the
# frequencies, the device)
_LAYOUTS: dict = {}


def _layout(name: str, q: torch.Tensor, k: Optional[torch.Tensor], positions: torch.Tensor,
            theta: float, bwd: bool) -> tuple:
    """The checks (:func:`rope_checks`, raising on a refusal) and the plan for
    these layouts, made once a layout."""
    key = (name, theta, q.shape, q.stride(), q.dtype, q.device,
           None if k is None else (k.shape, k.stride(), k.dtype, k.device),
           positions.shape, positions.stride(), positions.dtype, positions.device)
    lay = _LAYOUTS.get(key)
    if lay is None:
        require(name, rope_checks(q, k, positions), q, k, positions)
        b, s, hq, hd = q.shape
        hk = 0 if k is None else k.shape[2]
        half, dev, es = hd // 2, q.get_device(), q.element_size()
        pos = positions.expand(b, s)
        strides = (*q.stride()[:3], *(k.stride()[:3] if k is not None else (0, 0, 0)),
                   *pos.stride())
        v = 16 // es
        shape_vector = half % v == 0 and all(st * es % 16 == 0 for st in strides[:6])
        pos32 = pos.dtype == torch.int32
        lay = (b, s, hq, hk, half, (_LL * 8)(*strides), shape_vector,
               tokens_a_block(hq + hk, half // v, half), tokens_a_block(hq + hk, half, half),
               _mode(True, q.dtype, bwd, pos32, dev), _mode(False, q.dtype, bwd, pos32, dev),
               cached_frequencies(hd, theta, q.device), dev)
        if len(_LAYOUTS) >= 4096:
            _LAYOUTS.clear()
        _LAYOUTS[key] = lay
    return lay


def _rotate(name: str, q: torch.Tensor, k: Optional[torch.Tensor], positions: torch.Tensor,
            theta: float, bwd: bool):
    """One launch rotating q and k (k may be None): (route, q's output, k's
    output or None), the outputs contiguous. The checks and the plan are
    made once a layout (:func:`_layout`); a call reads its pointers'
    alignment."""
    b, s, hq, hk, half, strides, shape_vector, tb_v, tb_s, mode_v, mode_s, freqs, dev = \
        _layout(name, q, k, positions, theta, bwd)
    oq = q.new_empty(q.shape)
    ok = None if k is None else k.new_empty(k.shape)
    qp, op = q.data_ptr(), oq.data_ptr()
    kp, okp = (None, None) if k is None else (k.data_ptr(), ok.data_ptr())
    vector = shape_vector and (qp | op | (kp or 0) | (okp or 0)) % 16 == 0
    err = _lib().rope_qk(mode_v if vector else mode_s, qp, kp, positions.data_ptr(),
                         freqs.data_ptr(), op, okp, b, s, hq, hk, half, strides,
                         tb_v if vector else tb_s, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise(name, err)
    return "vector" if vector else "scalar", oq, ok


def rope_qk_fwd(q: torch.Tensor, k: Optional[torch.Tensor], positions: torch.Tensor,
                theta: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(q rotated, k rotated or None), contiguous, in their dtype: on the card
    one launch of the kernel on the current stream (q (B, S, Hq, hd), k (B,
    S, Hk, hd) or None, read at their strides with the last dim contiguous;
    positions int64 or int32 broadcastable to (B, S), read at their
    strides); on the CPU the plain version of each."""
    if not q.is_cuda:
        return (rope_plain(q, positions, theta),
                None if k is None else rope_plain(k, positions, theta))
    route, oq, ok = _rotate("rope_qk_fwd", q, k, positions, theta, bwd=False)
    _count(rope_qk_fwd, route)
    return oq, ok


rope_qk_fwd.launches = 0
rope_qk_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def rope_qk_bwd(gq: torch.Tensor, gk: Optional[torch.Tensor], positions: torch.Tensor,
                theta: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradients of q and k (or None) for their outputs' gradients gq, gk
    (laid out as the forward takes q and k): on the card one launch of the
    kernel in its adjoint mode (the rotation by the negated angle), on the
    CPU :func:`rope_bwd_plain` of each."""
    if not gq.is_cuda:
        return (rope_bwd_plain(gq, positions, theta),
                None if gk is None else rope_bwd_plain(gk, positions, theta))
    route, dq, dk = _rotate("rope_qk_bwd", gq, gk, positions, theta, bwd=True)
    _count(rope_qk_bwd, route)
    return dq, dk


rope_qk_bwd.launches = 0
rope_qk_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def attributes(dtype: torch.dtype, bwd: bool, device: int) -> dict:
    """The vector route's kernel's registers a thread and local memory (its
    stack frame, spills included) as the runtime reports them, for int64
    positions."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().rope_qk_attributes(_mode(True, dtype, bwd, False, device),
                                    ctypes.byref(regs), ctypes.byref(local))
    if err:
        _raise("rope_qk_attributes", err)
    return {"registers": regs.value, "local_bytes": local.value}


class RopeFn(torch.autograd.Function):
    """:func:`rope_qk_fwd` over (q, k, positions, theta), k optional, with
    :func:`rope_qk_bwd` as the backward; positions get no gradient. On the
    CPU both take their plain versions."""

    @staticmethod
    def forward(ctx, q, k, positions, theta):
        oq, ok = rope_qk_fwd(q, k, positions, theta)
        ctx.save_for_backward(positions)
        ctx.theta = theta
        ctx.dtypes = (q.dtype, None if k is None else k.dtype)
        return oq, ok

    @staticmethod
    @once_differentiable
    def backward(ctx, gq, gk):
        (positions,) = ctx.saved_tensors
        qd, kd = ctx.dtypes

        def ready(g, dtype):
            g = g.to(dtype)
            return g if g.stride(-1) == 1 else g.contiguous()
        gk = None if kd is None else ready(gk, kd)
        dq, dk = rope_qk_bwd(ready(gq, qd), gk, positions, ctx.theta)
        return dq, dk, None, None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points' argument and result types on a built
    ``csrc/rope.cu``."""
    lib.rope_qk.argtypes = [_I, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P, _I, _P]
    lib.rope_qk.restype = ctypes.c_int
    lib.rope_qk_smem.argtypes = [_I, _I]
    lib.rope_qk_smem.restype = ctypes.c_longlong
    lib.rope_qk_attributes.argtypes = [_I, _IP, _IP]
    lib.rope_qk_attributes.restype = ctypes.c_int
    lib.rope_error_string.argtypes = [ctypes.c_int]
    lib.rope_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(load_library("rope"))
