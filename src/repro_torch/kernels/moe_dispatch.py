"""The MoE layer's dispatch and combine: the CUDA kernels' wrappers (B2) and
their plain PyTorch versions.

Replaces no Pallas kernel: the two kernels are the counterpart of what XLA
makes of the reference's sort dispatch inside ``repro.models.moe.moe_ffn``,
the buffer's scatter and the combine's gather-scale-mask and scatter-add.
``csrc/moe_dispatch.cu``, CUDA C++ for sm_90a built by
:mod:`repro_torch.kernels.build`, holds both; its header says what bounds
each (bytes) and what its design does about that.

Both read one token-major route table (``repro_torch.models.moe.route_table``):

* ``dest`` (T, k) int32: token t's j-th assignment goes to row
  ``dest[t, j]`` of the (E, C, D) buffer (``e·C + slot``, e counted from the
  table's first expert), or is dropped where ``dest[t, j] < 0``: then
  ``-1 - dest[t, j]`` is its (global) expert;
* ``kept`` (E,) int32: how many slots of each expert are filled (its
  first ``kept[e]``); the others are zeros. It is derived from ``dest`` (the
  count of each expert's rows there): the fill kernel trusts it to tell
  which slots to zero, the plain fill reads only its length;
* ``gate`` (T, k) f32, the router's gates.

:func:`moe_fill` writes the buffer: every token's row to its kept
destinations, zeros elsewhere. :func:`moe_combine` adds each token's k gated
contributions ``y[dest] · gate`` (+0.0 where dropped) in ascending expert
id, every product and sum rounded to y's dtype, as :func:`moe_combine_plain`
adds them, so the two agree bit for bit.

Training goes through :class:`MoeFillFn` and :class:`MoeCombineFn`, whose
backwards are the two adjoint kernels of the same source:
:func:`moe_fill_bwd` (each token's gradient the f32 sum of its kept slots'
rows, in ascending expert id, rounded once) and :func:`moe_combine_bwd`
(each kept slot's gradient ``grad_out · gate``, zeros in the empty slots,
and each route's gate gradient, the dot of ``grad_out`` with its row of
y), each equal to its plain version (:func:`moe_fill_bwd_plain`,
:func:`moe_combine_bwd_plain`) bit for bit but for the f32 order of the
gate gradient's sum.

A CUDA tensor goes to the kernel or raises; CPU and meta tensors (the
tests, the dry run) go to the plain versions. Each wrapper counts its
launches under a lock, in ``launches`` and in ``launches_by_route``:
``vector`` (16-byte pieces: D a multiple of 8 bf16 or 4 f32 elements, the
rows 16-byte aligned) or ``scalar`` (an element at a time).
"""
from __future__ import annotations

import ctypes
import functools
import threading

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from .build import load_library

ROUTES = ("vector", "scalar")
MAX_K = 32                       # a token's assignments: one a lane of a warp
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32, _FLOAT32 = torch.int32, torch.float32
_LAUNCH_LOCK = threading.Lock()
# an entry point's `mode`: the route (1 vector), the dtype, k and the device
# in one int (each ctypes argument costs host time; decode's calls are
# host-paced)
_MODE_DTYPE_SHIFT, _MODE_K_SHIFT, _MODE_DEVICE_SHIFT = 1, 2, 8
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# mode, rows, dest, kept, out, tokens, experts, cap, d, stream
_FILL_ARGTYPES = [_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P]
# mode, y, dest, gate, out, tokens, experts, cap, d, expert0, stream
_COMBINE_ARGTYPES = [_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _P]
# mode, grad_buf, dest, out, tokens, experts, cap, d, stream
_FILL_BWD_ARGTYPES = [_I, _P, _P, _P, _LL, _LL, _LL, _LL, _P]
# mode, grad_out, y, dest, gate, kept, dy, dgate, tokens, experts, cap, d, stream
_COMBINE_BWD_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P]


def _mode(vector: bool, dtype: torch.dtype, k: int, device: int) -> int:
    return (int(vector) | _DTYPE_CODE[dtype] << _MODE_DTYPE_SHIFT | k << _MODE_K_SHIFT
            | device << _MODE_DEVICE_SHIFT)


def _count(fn, route: str) -> None:
    with _LAUNCH_LOCK:
        fn.launches += 1
        fn.launches_by_route[route] += 1


def _raise(name: str, err: int) -> None:
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{_lib().moe_error_string(err).decode()} ({err})")


def moe_fill_plain(rows: torch.Tensor, dest: torch.Tensor, kept: torch.Tensor,
                   cap: int) -> torch.Tensor:
    """The contiguous (E, cap, D) buffer, E = ``kept``'s length: row
    ``dest[t, j]`` holds ``rows[t]`` for every kept destination, zeros
    elsewhere. ``rows`` (T, D). An index_put into zeros with a waste row for
    the dropped assignments, cut away."""
    e, (t, k), d = kept.shape[0], dest.shape, rows.shape[1]
    flat = dest.reshape(-1)
    slot = torch.where(flat >= 0, flat, e * cap)
    buf = torch.index_put(rows.new_zeros((e * cap + 1, d)), (slot,),
                          rows.repeat_interleave(k, dim=0))
    return buf[:-1].view(e, cap, d)


def expert_order(dest: torch.Tensor, cap: int, expert0: int = 0) -> torch.Tensor:
    """(T, k): each token's assignments in ascending expert id (stable),
    the order in which the reference's scatter-add applies them."""
    expert = torch.where(dest >= 0, torch.div(dest, cap, rounding_mode="floor") + expert0,
                         -1 - dest)
    return torch.argsort(expert, dim=1, stable=True)


def moe_combine_plain(y: torch.Tensor, dest: torch.Tensor, gate: torch.Tensor,
                      expert0: int = 0) -> torch.Tensor:
    """Each token's gated contributions ``y[dest] · gate`` of its k routes
    (+0.0 where dropped, which still takes part in the sum), added in
    ascending expert id (:func:`expert_order`), the product and each sum in
    y's dtype. y (E, C, D); ``expert0`` the global id of y's first expert.
    Returns (T, D) in y's dtype."""
    e, cap, d = y.shape
    order = expert_order(dest, cap, expert0)
    dest, gate = dest.gather(1, order), gate.gather(1, order)
    kept = dest >= 0
    rows = y.reshape(e * cap, d)[torch.where(kept, dest, 0).long()]          # (T, k, D)
    contrib = rows * gate[..., None].to(y.dtype)
    contrib = torch.where(kept[..., None], contrib, torch.zeros((), dtype=y.dtype,
                                                                device=y.device))
    out2d = contrib[:, 0]
    for j in range(1, dest.shape[1]):
        out2d = out2d + contrib[:, j]
    return out2d


def moe_fill_bwd_plain(grad_buf: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`moe_fill_plain`'s rows: token t's row is the
    sum of the rows ``dest[t, j]`` of ``grad_buf`` (E, C, D) over its kept
    routes, added in f32 from +0.0 in ascending expert id
    (:func:`expert_order`) and rounded once to ``grad_buf``'s dtype (f64,
    which only the CPU takes, sums in f64); a dropped route adds nothing
    (its +0.0 leaves the sum as it is). Returns (T, D). Autograd of the
    fill computes the same sum in its own order."""
    e, cap, d = grad_buf.shape
    wide = torch.promote_types(torch.float32, grad_buf.dtype)
    dest = dest.gather(1, expert_order(dest, cap))
    kept = dest >= 0
    rows = grad_buf.reshape(e * cap, d)[torch.where(kept, dest, 0).long()]     # (T, k, D)
    zero = torch.zeros((), dtype=wide, device=grad_buf.device)
    acc = torch.zeros((dest.shape[0], d), dtype=wide, device=grad_buf.device)
    for j in range(dest.shape[1]):
        acc = acc + torch.where(kept[:, j, None], rows[:, j].to(wide), zero)
    return acc.to(grad_buf.dtype)


def moe_combine_bwd_plain(grad_out: torch.Tensor, y: torch.Tensor, dest: torch.Tensor,
                          gate: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`moe_combine_plain` by y and the gate, as its
    arithmetic rounds: ``dy`` (E, C, D) in y's dtype holds
    ``grad_out[t] · gate[t, j]`` (the gate rounded to y's dtype, the product
    rounded) at row ``dest[t, j]`` of each kept route, zeros in every slot
    no kept route reaches; ``dgate`` (T, k) in the gate's dtype (f32) is
    the sum over D of the products ``grad_out[t] · y[dest[t, j]]``, each
    rounded to y's dtype, added in f32 (f64 for f64 y, which only the CPU
    takes), rounded to y's dtype and widened; 0 where dropped. No sum runs
    over the routes, so no order (and no ``expert0``) enters."""
    e, cap, d = y.shape
    kept = dest >= 0
    go = grad_out.to(y.dtype)
    prod = go[:, None, :] * gate[..., None].to(y.dtype)                       # (T, k, D)
    slot = torch.where(kept, dest, e * cap).reshape(-1).long()
    dy = torch.index_put(y.new_zeros((e * cap + 1, d)), (slot,), prod.reshape(-1, d))
    rows = y.reshape(e * cap, d)[torch.where(kept, dest, 0).long()]           # (T, k, D)
    wide = torch.promote_types(torch.float32, y.dtype)
    dgate = (go[:, None, :] * rows).to(wide).sum(dim=-1).to(y.dtype).to(gate.dtype)
    return dy[:-1].view(e, cap, d), torch.where(kept, dgate, torch.zeros_like(dgate))


def _fill_shapes(rows, dest, kept) -> None:
    if rows.dim() != 2 or dest.dim() != 2 or kept.dim() != 1 or dest.shape[0] != rows.shape[0]:
        raise ValueError(f"moe_fill: want rows (T, D), dest (T, k) and kept (E,); got "
                         f"{tuple(rows.shape)}, {tuple(dest.shape)}, {tuple(kept.shape)}")


def _refuse(name: str, k: int, *tensors) -> None:
    """Raises for what a CUDA call was refused: a tensor on another device,
    of another dtype or not contiguous, or k out of range; ``tensors`` are
    (tensor, dtype, or None for f32 or bf16)."""
    first = tensors[0][0]
    for t, dt in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: want every tensor on {first.device}; got {t.device}")
        if (t.dtype not in _DTYPE_CODE) if dt is None else t.dtype != dt:
            raise TypeError(f"{name}: want {dt or list(_DTYPE_CODE)}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    raise ValueError(f"{name}: k must be in 1..{MAX_K}; got {k}")


def moe_fill(rows: torch.Tensor, dest: torch.Tensor, kept: torch.Tensor,
             cap: int) -> torch.Tensor:
    """The (E, cap, D) buffer of :func:`moe_fill_plain`: on the card one
    launch of the fill kernel on the current stream (rows f32 or bf16,
    dest and kept int32, each contiguous on one card); on the CPU (or
    meta) the plain version. ``kept`` must be the count of each expert's
    rows in ``dest``, as ``route_table`` makes it. The checks are one
    expression over each tensor's shape read once: decode's calls are
    host-paced, and each tensor attribute read costs host time."""
    if not rows.is_cuda:
        _fill_shapes(rows, dest, kept)
        return moe_fill_plain(rows, dest, kept, cap)
    rs, ds, ks, dev = rows.shape, dest.shape, kept.shape, rows.get_device()
    if not (len(rs) == 2 and len(ds) == 2 and len(ks) == 1 and ds[0] == rs[0]
            and 0 < ds[1] <= MAX_K and rows.dtype in _DTYPE_CODE and dest.dtype == _INT32
            and kept.dtype == _INT32 and rows.is_contiguous() and dest.is_contiguous()
            and kept.is_contiguous() and dest.get_device() == dev and kept.get_device() == dev):
        _fill_shapes(rows, dest, kept)
        _refuse("moe_fill", ds[1], (rows, None), (dest, _INT32), (kept, _INT32))
    (t, d), k, e = rs, ds[1], ks[0]
    out = rows.new_empty((e, cap, d))
    rp, op = rows.data_ptr(), out.data_ptr()
    vector = d * rows.element_size() % 16 == 0 and (rp | op) % 16 == 0
    err = _lib().moe_fill(_mode(vector, rows.dtype, k, dev), rp, dest.data_ptr(),
                          kept.data_ptr(), op, t, e, cap, d,
                          torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise("moe_fill", err)
    _count(moe_fill, "vector" if vector else "scalar")
    return out


moe_fill.launches = 0
moe_fill.launches_by_route = dict.fromkeys(ROUTES, 0)


def moe_combine(y: torch.Tensor, dest: torch.Tensor, gate: torch.Tensor,
                expert0: int = 0) -> torch.Tensor:
    """The (T, D) output of :func:`moe_combine_plain`: on the card one
    launch of the combine kernel on the current stream (y f32 or bf16, dest
    int32 and gate f32, (T, k) with k ≤ ``MAX_K``, each contiguous on one
    card); on the CPU (or meta) the plain version."""
    if y.dim() != 3 or dest.dim() != 2 or gate.shape != dest.shape:
        raise ValueError(f"moe_combine: want y (E, C, D), dest and gate (T, k); got "
                         f"{tuple(y.shape)}, {tuple(dest.shape)}, {tuple(gate.shape)}")
    if not y.is_cuda:
        return moe_combine_plain(y, dest, gate, expert0)
    (e, cap, d), (t, k), dev = y.shape, dest.shape, y.get_device()
    if not (0 < k <= MAX_K and y.dtype in _DTYPE_CODE and dest.dtype == _INT32
            and gate.dtype == _FLOAT32 and y.is_contiguous() and dest.is_contiguous()
            and gate.is_contiguous() and dest.get_device() == dev and gate.get_device() == dev):
        _refuse("moe_combine", k, (y, None), (dest, _INT32), (gate, _FLOAT32))
    out = y.new_empty((t, d))
    yp, op = y.data_ptr(), out.data_ptr()
    vector = d * y.element_size() % 16 == 0 and (yp | op) % 16 == 0
    err = _lib().moe_combine(_mode(vector, y.dtype, k, dev), yp, dest.data_ptr(),
                             gate.data_ptr(), op, t, e, cap, d, expert0,
                             torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise("moe_combine", err)
    _count(moe_combine, "vector" if vector else "scalar")
    return out


moe_combine.launches = 0
moe_combine.launches_by_route = dict.fromkeys(ROUTES, 0)


def moe_fill_bwd(grad_buf: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """The rows' gradient (T, D) of :func:`moe_fill_bwd_plain`: on the card
    one launch of the fill's adjoint kernel on the current stream
    (``grad_buf`` (E, C, D) f32 or bf16, dest (T, k) int32, each
    contiguous on one card); on the CPU the plain version."""
    if grad_buf.dim() != 3 or dest.dim() != 2:
        raise ValueError(f"moe_fill_bwd: want grad_buf (E, C, D) and dest (T, k); got "
                         f"{tuple(grad_buf.shape)}, {tuple(dest.shape)}")
    if not grad_buf.is_cuda:
        return moe_fill_bwd_plain(grad_buf, dest)
    (e, cap, d), (t, k), dev = grad_buf.shape, dest.shape, grad_buf.get_device()
    if not (0 < k <= MAX_K and grad_buf.dtype in _DTYPE_CODE and dest.dtype == _INT32
            and grad_buf.is_contiguous() and dest.is_contiguous() and dest.get_device() == dev):
        _refuse("moe_fill_bwd", k, (grad_buf, None), (dest, _INT32))
    out = grad_buf.new_empty((t, d))
    gp, op = grad_buf.data_ptr(), out.data_ptr()
    vector = d * grad_buf.element_size() % 16 == 0 and (gp | op) % 16 == 0
    err = _lib().moe_fill_bwd(_mode(vector, grad_buf.dtype, k, dev), gp, dest.data_ptr(), op,
                              t, e, cap, d, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise("moe_fill_bwd", err)
    _count(moe_fill_bwd, "vector" if vector else "scalar")
    return out


moe_fill_bwd.launches = 0
moe_fill_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def moe_combine_bwd(grad_out: torch.Tensor, y: torch.Tensor, dest: torch.Tensor,
                    gate: torch.Tensor, kept: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy (E, C, D), dgate (T, k) f32) of :func:`moe_combine_bwd_plain`:
    on the card one launch of the combine's adjoint kernel on the current
    stream (grad_out (T, D) of y's dtype, y f32 or bf16, dest int32, gate
    f32, kept (E,) int32 as :func:`moe_fill` reads it, each contiguous on
    one card); on the CPU the plain version, which needs no ``kept``."""
    if (y.dim() != 3 or dest.dim() != 2 or gate.shape != dest.shape or grad_out.dim() != 2
            or grad_out.shape[0] != dest.shape[0] or grad_out.shape[1] != y.shape[2]
            or kept.shape != y.shape[:1]):
        raise ValueError(f"moe_combine_bwd: want grad_out (T, D), y (E, C, D), dest and gate "
                         f"(T, k), kept (E,); got {tuple(grad_out.shape)}, {tuple(y.shape)}, "
                         f"{tuple(dest.shape)}, {tuple(gate.shape)}, {tuple(kept.shape)}")
    if not y.is_cuda:
        return moe_combine_bwd_plain(grad_out, y, dest, gate)
    (e, cap, d), (t, k), dev = y.shape, dest.shape, y.get_device()
    if not (0 < k <= MAX_K and y.dtype in _DTYPE_CODE and grad_out.dtype == y.dtype
            and dest.dtype == _INT32 and gate.dtype == _FLOAT32 and kept.dtype == _INT32
            and all(a.is_contiguous() and a.get_device() == dev
                    for a in (grad_out, y, dest, gate, kept))):
        _refuse("moe_combine_bwd", k, (y, None), (grad_out, y.dtype), (dest, _INT32),
                (gate, _FLOAT32), (kept, _INT32))
    dy = y.new_empty((e, cap, d))
    dgate = gate.new_empty((t, k))
    gp, yp, op = grad_out.data_ptr(), y.data_ptr(), dy.data_ptr()
    vector = d * y.element_size() % 16 == 0 and (gp | yp | op) % 16 == 0
    err = _lib().moe_combine_bwd(_mode(vector, y.dtype, k, dev), gp, yp, dest.data_ptr(),
                                 gate.data_ptr(), kept.data_ptr(), op, dgate.data_ptr(), t, e,
                                 cap, d, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise("moe_combine_bwd", err)
    _count(moe_combine_bwd, "vector" if vector else "scalar")
    return dy, dgate


moe_combine_bwd.launches = 0
moe_combine_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


class MoeFillFn(torch.autograd.Function):
    """:func:`moe_fill` with its adjoint (:func:`moe_fill_bwd`) as the
    backward: the rows' gradient only (dest and kept are indices)."""

    @staticmethod
    def forward(ctx, rows, dest, kept, cap):
        ctx.save_for_backward(dest)
        return moe_fill(rows, dest, kept, cap)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_buf):
        (dest,) = ctx.saved_tensors
        return moe_fill_bwd(grad_buf.contiguous(), dest), None, None, None


class MoeCombineFn(torch.autograd.Function):
    """:func:`moe_combine` with its adjoint (:func:`moe_combine_bwd`) as the
    backward: y's and the gate's gradients. ``kept`` (E,) int32 tells the
    adjoint which of dy's slots are empty."""

    @staticmethod
    def forward(ctx, y, dest, gate, kept, expert0):
        ctx.save_for_backward(y, dest, gate, kept)
        return moe_combine(y, dest, gate, expert0)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        y, dest, gate, kept = ctx.saved_tensors
        dy, dgate = moe_combine_bwd(grad_out.to(y.dtype).contiguous(), y, dest, gate, kept)
        return (dy if ctx.needs_input_grad[0] else None, None,
                dgate if ctx.needs_input_grad[2] else None, None, None)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("moe_dispatch")
    lib.moe_fill.argtypes = _FILL_ARGTYPES
    lib.moe_fill.restype = ctypes.c_int
    lib.moe_combine.argtypes = _COMBINE_ARGTYPES
    lib.moe_combine.restype = ctypes.c_int
    lib.moe_fill_bwd.argtypes = _FILL_BWD_ARGTYPES
    lib.moe_fill_bwd.restype = ctypes.c_int
    lib.moe_combine_bwd.argtypes = _COMBINE_BWD_ARGTYPES
    lib.moe_combine_bwd.restype = ctypes.c_int
    lib.moe_error_string.argtypes = [ctypes.c_int]
    lib.moe_error_string.restype = ctypes.c_char_p
    return lib
