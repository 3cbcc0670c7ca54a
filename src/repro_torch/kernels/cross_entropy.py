"""The training loss, softmax cross-entropy over the vocabulary: the CUDA
kernels' wrappers (B6), their plain PyTorch versions and the adjoint.

Replaces no Pallas kernel: the kernels are the counterpart of what XLA
fuses out of the reference's ``repro.train.loop.cross_entropy_loss`` (the
f32 cast, ``log_softmax``, the label's gather and the mean) and of its
autodiff inside the jitted step. ``csrc/cross_entropy.cu``, CUDA C++ for
sm_90a built by :mod:`repro_torch.kernels.build`, holds the forward and
the adjoint kernel; its header says what bounds them (bytes) and what
their design does about that.

* :func:`cross_entropy_plain`: the eager chain, ``-mean(log_softmax(x32)
  [label])``;
* :func:`cross_entropy_fwd` (kernel; plain version
  :func:`cross_entropy_fwd_plain`): each row's f32 log-sum-exp and
  ``nll = lse - x[label]``; the loss is ``torch.mean`` of the nll;
* :func:`cross_entropy_bwd` (kernel; plain version
  :func:`cross_entropy_bwd_plain`): ``(exp(x - lse) - onehot) · g / N`` in
  f32, each op rounded on its own, rounded once to the logits' dtype: the
  kernel equals the plain adjoint bit for bit at the same lse.

Training goes through :class:`CrossEntropyFn`, which keeps the logits,
each row's lse and the labels, and nothing of the vocabulary's size in
f32. A CUDA tensor goes to the kernels or raises; CPU tensors (the tests)
take the plain versions. Each wrapper counts its launches under a lock, in
``launches`` and in ``launches_by_route``: ``vector`` (16-byte units: the
width and every row start whole units) or ``scalar`` (an element at a
time).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from .build import load_library, require
from .rms_norm import _row_stride

ROUTES = ("vector", "scalar")
_DTYPES = (torch.float32, torch.bfloat16)
_F32 = torch.float32
_MODE_VECTOR, _MODE_DTYPE, _MODE_DEVICE_SHIFT = 1, 2, 8
# csrc/cross_entropy.cu's adjoint: a block of THREADS threads a chunk of
# THREADS * UNROLL units of a row, at most 65535 chunks
_BWD_UNITS, _MAX_CHUNKS = 256 * 4, 65535
_LAUNCH_LOCK = threading.Lock()
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_IP = ctypes.POINTER(ctypes.c_int)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def cross_entropy_plain(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The eager chain of the reference's loss: f32 log-softmax over the last
    dim, the label's entry, minus the mean."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.gather(lp, -1, labels[..., None])[..., 0]
    return -torch.mean(tgt)


def cross_entropy_fwd_plain(logits: torch.Tensor, labels: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each row's f32 log-sum-exp, each row's ``lse - x[label]``), shaped
    like ``labels``."""
    x32 = logits.float()
    lse = torch.logsumexp(x32, dim=-1)
    return lse, lse - torch.gather(x32, -1, labels[..., None])[..., 0]


def cross_entropy_bwd_plain(grad: torch.Tensor, logits: torch.Tensor, lse: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """The gradient of the mean loss by the logits, in f32 from the
    forward's ``lse``: ``p = exp(x - lse)``, the label's entry ``p - 1``,
    times ``g / N`` (``grad``, the loss's gradient, over the rows; a tensor
    division, correctly rounded), rounded once to the logits' dtype."""
    v = logits.shape[-1]
    d = torch.exp(logits.float() - lse[..., None]).reshape(-1, v)
    rows = torch.arange(d.shape[0], device=d.device)
    flat = labels.reshape(-1)
    d[rows, flat] = d[rows, flat] - 1.0
    scale = grad.float() / torch.full((), float(d.shape[0]), dtype=_F32, device=d.device)
    return (d * scale).to(logits.dtype).reshape(logits.shape)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _count(fn, route: str) -> None:
    with _LAUNCH_LOCK:
        fn.launches += 1
        fn.launches_by_route[route] += 1


def _raise(name: str, err: int) -> None:
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{_lib().cross_entropy_error_string(err).decode()} ({err})")


def loss_checks(logits: torch.Tensor, labels: torch.Tensor, rs):
    """The kernels' conditions as (ok, message) pairs, ``rs`` the logits' row
    stride (``rms_norm._row_stride``): logits f32 or bf16 with rows evenly
    spaced and the last dim contiguous, labels int64 of the logits' leading
    shape, one card; the adjoint's chunks within the grid's limit."""
    v = logits.shape[-1] if logits.dim() else 0
    return ((logits.dim() >= 1 and v > 0, "logits (..., V), V > 0"),
            (rs is not None, "the logits' rows evenly spaced, the last dim contiguous"),
            (logits.dtype in _DTYPES, "logits f32 or bf16"),
            (labels.dtype == torch.int64 and labels.shape == logits.shape[:-1],
             "labels int64 of the logits' leading shape"),
            (-(-v // _BWD_UNITS) <= _MAX_CHUNKS, "V within the adjoint's grid"),
            (labels.get_device() == logits.get_device(), "logits and labels on one device"))


def _mode(vector: bool, dtype: torch.dtype, device: int) -> int:
    return (int(vector) * _MODE_VECTOR | (_MODE_DTYPE if dtype == torch.bfloat16 else 0)
            | device << _MODE_DEVICE_SHIFT)


def _layout(name: str, logits: torch.Tensor, labels: torch.Tensor, *extra):
    """(rows, V, row stride, labels flat, whether the shape takes 16-byte
    units) after the checks, which raise on a refusal."""
    rs = _row_stride(logits) if logits.dim() >= 1 else None
    require(name, loss_checks(logits, labels, rs) + extra, logits, labels)
    v = logits.shape[-1]
    es = logits.element_size()
    flat = labels.reshape(-1)
    return logits.numel() // v, v, rs, flat, v * es % 16 == 0 and rs * es % 16 == 0


def cross_entropy_fwd(logits: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each row's f32 lse, each row's f32 nll), shaped like ``labels``: on
    the card one launch of the forward kernel on the current stream (logits
    f32 or bf16, rows evenly spaced and the last dim contiguous; labels
    int64, taken to lie in [0, V)); on the CPU the plain version."""
    if not logits.is_cuda:
        return cross_entropy_fwd_plain(logits, labels)
    rows, v, rs, flat, shape_vector = _layout("cross_entropy_fwd", logits, labels)
    dev = logits.get_device()
    lse = torch.empty(labels.shape, dtype=_F32, device=logits.device)
    nll = torch.empty(labels.shape, dtype=_F32, device=logits.device)
    xp = logits.data_ptr()
    vector = shape_vector and xp % 16 == 0
    err = _lib().cross_entropy_fwd(_mode(vector, logits.dtype, dev), xp, flat.data_ptr(),
                                   lse.data_ptr(), nll.data_ptr(), rows, v, rs, flat.stride(0),
                                   torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise("cross_entropy_fwd", err)
    _count(cross_entropy_fwd, "vector" if vector else "scalar")
    return lse, nll


cross_entropy_fwd.launches = 0
cross_entropy_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def cross_entropy_bwd(grad: torch.Tensor, logits: torch.Tensor, lse: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """The logits' gradient (contiguous, their dtype) of
    :func:`cross_entropy_bwd_plain`: on the card one launch of the adjoint
    kernel (``grad`` the loss's gradient, one value on the card; lse the
    forward's, f32 contiguous); on the CPU the plain version."""
    if not logits.is_cuda:
        return cross_entropy_bwd_plain(grad, logits, lse, labels)
    grad = grad.to(_F32)
    rows, v, rs, flat, shape_vector = _layout(
        "cross_entropy_bwd", logits, labels,
        (grad.numel() == 1 and grad.get_device() == logits.get_device(),
         "grad one value on the logits' card"),
        (lse.dtype == _F32 and lse.is_contiguous() and lse.shape == labels.shape
         and lse.get_device() == logits.get_device(), "lse f32 contiguous, one a row"))
    dev = logits.get_device()
    dx = torch.empty(logits.shape, dtype=logits.dtype, device=logits.device)
    xp, dp = logits.data_ptr(), dx.data_ptr()
    vector = shape_vector and (xp | dp) % 16 == 0
    err = _lib().cross_entropy_bwd(_mode(vector, logits.dtype, dev), xp, flat.data_ptr(),
                                   lse.data_ptr(), grad.data_ptr(), dp, rows, v, rs,
                                   flat.stride(0), torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise("cross_entropy_bwd", err)
    _count(cross_entropy_bwd, "vector" if vector else "scalar")
    return dx


cross_entropy_bwd.launches = 0
cross_entropy_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def attributes(dtype: torch.dtype, bwd: bool, device: int) -> dict:
    """The vector route's kernel's registers a thread and local memory (its
    stack frame, spills included) as the runtime reports them."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().cross_entropy_attributes(_mode(True, dtype, device), int(bwd),
                                          ctypes.byref(regs), ctypes.byref(local))
    if err:
        _raise("cross_entropy_attributes", err)
    return {"registers": regs.value, "local_bytes": local.value}


class CrossEntropyFn(torch.autograd.Function):
    """The mean loss through :func:`cross_entropy_fwd` (``torch.mean`` of
    the rows' nll), with :func:`cross_entropy_bwd` as the backward: it keeps
    the logits, each row's f32 lse and the labels. On the CPU both take
    their plain versions."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse, nll = cross_entropy_fwd(logits, labels)
        ctx.save_for_backward(logits, lse, labels)
        return nll.mean()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        logits, lse, labels = ctx.saved_tensors
        return cross_entropy_bwd(grad, logits, lse, labels), None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points' argument and result types on a built
    ``csrc/cross_entropy.cu``."""
    lib.cross_entropy_fwd.argtypes = [_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P]
    lib.cross_entropy_fwd.restype = ctypes.c_int
    lib.cross_entropy_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P]
    lib.cross_entropy_bwd.restype = ctypes.c_int
    lib.cross_entropy_attributes.argtypes = [_I, _I, _IP, _IP]
    lib.cross_entropy_attributes.restype = ctypes.c_int
    lib.cross_entropy_error_string.argtypes = [ctypes.c_int]
    lib.cross_entropy_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(load_library("cross_entropy"))
