"""SwiGLU's gate ``silu(g) · u``: the CUDA kernel's wrappers (B8), its plain
PyTorch version and the adjoint.

Replaces no Pallas kernel: the kernel is the counterpart of what XLA fuses
out of ``jax.nn.silu(g) * u`` in the reference's ``repro.models.layers.swiglu``
and ``repro.models.moe.moe_ffn``'s expert block, and out of its autodiff,
inside the jitted steps. ``csrc/swiglu.cu``, CUDA C++ for sm_90a built by
:mod:`repro_torch.kernels.build`, computes the forward in one pass and the
adjoint in another; its header says what bounds it (bytes) and what its
design does about that.

* :func:`swiglu_plain`: the eager chain, ``F.silu(g) * u``;
* :func:`swiglu_bwd_plain`: its gradient as autograd computes it, each op
  rounded to the dtype on its own: ``ds = dh·u``, ``du = dh·silu(g)``,
  ``dg = silu_backward(ds, g)``;
* :func:`swiglu_fwd` and :func:`swiglu_bwd` (the kernels): g and u (..., N)
  of one shape and dtype (f32 or bf16), rows evenly spaced and the last dim
  contiguous; every step rounded as the eager chain rounds it, so equal to
  the plain versions bit for bit.

Training goes through :class:`SwigluFn`, which keeps g and u (not
``silu(g)``: the adjoint recomputes it). A CUDA tensor goes to the kernel or
raises; CPU tensors (the tests) take the plain versions. Each wrapper
counts its launches under a lock, in ``launches`` and in
``launches_by_route``: ``vector`` (16-byte units: N whole units, every row
stride and pointer 16-byte aligned) or ``scalar`` (an element at a time).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .build import load_library, require
from .rms_norm import _row_stride

ROUTES = ("vector", "scalar")
_DTYPES = (torch.float32, torch.bfloat16)
_MODE_VECTOR, _MODE_DTYPE, _MODE_DEVICE_SHIFT = 1, 2, 8
# csrc/swiglu.cu: a block of THREADS threads, NI units in flight a thread
THREADS, NI = 256, 4
_LAUNCH_LOCK = threading.Lock()
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_IP = ctypes.POINTER(ctypes.c_int)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def swiglu_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g) · u``, the eager chain."""
    return F.silu(g) * u


def swiglu_bwd_plain(dh: torch.Tensor, g: torch.Tensor,
                     u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dg, du) of :func:`swiglu_plain` for the output's gradient dh, as
    autograd computes them: mul's two products, each rounded to the dtype,
    then ``silu_backward`` (the op ``F.silu``'s autograd calls) on the
    rounded ``dh·u``."""
    du = dh * F.silu(g)
    dg = torch.ops.aten.silu_backward(dh * u, g)
    return dg, du


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _count(fn, route: str) -> None:
    with _LAUNCH_LOCK:
        fn.launches += 1
        fn.launches_by_route[route] += 1


def _raise(name: str, err: int) -> None:
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{_lib().swiglu_error_string(err).decode()} ({err})")


def swiglu_checks(g: torch.Tensor, u: torch.Tensor, dh=None):
    """The kernels' conditions as (ok, message) pairs: g and u (and the
    adjoint's dh) of one shape and dtype, f32 or bf16, each with its rows
    evenly spaced and the last dim contiguous (:func:`_row_stride`); one
    card."""
    ts = (g, u) if dh is None else (g, u, dh)
    return ((all(t.shape == g.shape for t in ts) and g.dim() >= 1, "g, u (and dh) of one shape"),
            (all(t.dtype == g.dtype for t in ts) and g.dtype in _DTYPES,
             "g, u (and dh) of one dtype, f32 or bf16"),
            (all(_row_stride(t) is not None for t in ts),
             "rows evenly spaced, the last dim contiguous"),
            (all(t.get_device() == g.get_device() for t in ts), "one device"))


def _mode(vector: bool, dtype: torch.dtype, device: int) -> int:
    return (int(vector) * _MODE_VECTOR | (_MODE_DTYPE if dtype == torch.bfloat16 else 0)
            | device << _MODE_DEVICE_SHIFT)


# the layouts that passed the checks, keyed by the name and each input's
# shape, strides, dtype and device: (rows, cols, the row strides, whether
# the layout takes 16-byte units, the mode bits of each route)
_LAYOUTS: dict = {}


def _plan(name: str, ts) -> tuple:
    """(rows, cols, the row strides, the route, the mode) for inputs ``ts``
    (g, u and maybe dh), refusing what the kernels do not take; the route
    ``vector`` where cols is whole 16-byte units and every row stride and
    pointer 16-byte aligned. The checks and all but the pointers' alignment
    are made once a layout."""
    key = (name, *((t.shape, t.stride(), t.dtype, t.device) for t in ts))
    lay = _LAYOUTS.get(key)
    if lay is None:
        require(name, swiglu_checks(*ts), *ts)
        g = ts[0]
        cols = g.shape[-1]
        rows = g.numel() // cols if cols else 0
        strides = [_row_stride(t) for t in ts]
        es, dev = g.element_size(), g.get_device()
        shape_vector = cols * es % 16 == 0 and all(st * es % 16 == 0 for st in strides)
        lay = (rows, cols, strides, shape_vector, _mode(True, g.dtype, dev),
               _mode(False, g.dtype, dev))
        if len(_LAYOUTS) >= 4096:
            _LAYOUTS.clear()
        _LAYOUTS[key] = lay
    rows, cols, strides, shape_vector, mode_v, mode_s = lay
    vector = shape_vector and all(t.data_ptr() % 16 == 0 for t in ts)
    return rows, cols, strides, ("vector" if vector else "scalar"), mode_v if vector else mode_s


def swiglu_fwd(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g) · u`` contiguous, in g's shape and dtype: on the card one
    launch of the forward kernel on the current stream (g and u read at
    their row strides), on the CPU :func:`swiglu_plain`."""
    if not g.is_cuda:
        return swiglu_plain(g, u)
    rows, cols, (gs, us), route, mode = _plan("swiglu_fwd", (g, u))
    h = g.new_empty(g.shape)
    err = _lib().swiglu_fwd(mode, g.data_ptr(), u.data_ptr(), h.data_ptr(), rows, cols, gs, us,
                            torch._C._cuda_getCurrentRawStream(g.get_device()))
    if err:
        _raise("swiglu_fwd", err)
    _count(swiglu_fwd, route)
    return h


swiglu_fwd.launches = 0
swiglu_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def swiglu_bwd(dh: torch.Tensor, g: torch.Tensor,
               u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dg, du), contiguous, for the output's gradient dh: on the card one
    launch of the adjoint kernel (dh, g and u read at their row strides),
    on the CPU :func:`swiglu_bwd_plain`."""
    if not g.is_cuda:
        return swiglu_bwd_plain(dh, g, u)
    rows, cols, (gs, us, hs), route, mode = _plan("swiglu_bwd", (g, u, dh))
    dg, du = g.new_empty(g.shape), g.new_empty(g.shape)
    err = _lib().swiglu_bwd(mode, g.data_ptr(), u.data_ptr(), dh.data_ptr(), dg.data_ptr(),
                            du.data_ptr(), rows, cols, gs, us, hs,
                            torch._C._cuda_getCurrentRawStream(g.get_device()))
    if err:
        _raise("swiglu_bwd", err)
    _count(swiglu_bwd, route)
    return dg, du


swiglu_bwd.launches = 0
swiglu_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def attributes(dtype: torch.dtype, bwd: bool, device: int) -> dict:
    """The vector route's kernel's registers a thread and local memory (its
    stack frame, spills included) as the runtime reports them."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().swiglu_attributes(_mode(True, dtype, device), int(bwd), ctypes.byref(regs),
                                   ctypes.byref(local))
    if err:
        _raise("swiglu_attributes", err)
    return {"registers": regs.value, "local_bytes": local.value}


class SwigluFn(torch.autograd.Function):
    """:func:`swiglu_fwd` over (g, u) with :func:`swiglu_bwd` as the
    backward; keeps g and u only. On the CPU both take their plain
    versions."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return swiglu_fwd(g, u)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        g, u = ctx.saved_tensors
        dh = dh.to(g.dtype)
        if dh.is_cuda and _row_stride(dh) is None:       # the kernel reads evenly spaced rows
            dh = dh.contiguous()
        return swiglu_bwd(dh, g, u)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points' argument and result types on a built
    ``csrc/swiglu.cu``."""
    lib.swiglu_fwd.argtypes = [_I, _P, _P, _P, _LL, _LL, _LL, _LL, _P]
    lib.swiglu_fwd.restype = ctypes.c_int
    lib.swiglu_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _P]
    lib.swiglu_bwd.restype = ctypes.c_int
    lib.swiglu_attributes.argtypes = [_I, _I, _IP, _IP]
    lib.swiglu_attributes.restype = ctypes.c_int
    lib.swiglu_error_string.argtypes = [ctypes.c_int]
    lib.swiglu_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(load_library("swiglu"))
