"""Row-wise int8 quantization: the CUDA kernels' wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``_quant_kernel`` / ``quantize_int8`` of
``src/repro/kernels/int8_quant.py``. Two CUDA C++ kernels for sm_90a, built
by :mod:`repro_torch.kernels.build`, take a CUDA call by its shape
(:func:`_route`):

- ``sm90``: ``csrc/int8_quant_sm90.cu``, persistent blocks fed by 1-D bulk
  copies through an mbarrier ring; it takes rows that are whole 16-byte
  pieces of at most 48 KB, with x and ``out`` 16-byte aligned;
- ``simt``: ``csrc/int8_quant.cu``, a block or a warp per row, every other
  shape.

Each header says what bounds its kernel on the H100 and what its design
does about that. The route is chosen from the shape and the pointers, never
by catching a failure.

Per row of x (R, C), f32 or bf16: ``scale = max(absmax, 1e-8) / 127`` in f32
and ``q = clip(round(x / scale), -127, 127)`` as int8, rounding half to even.
Given ``out`` (bf16 or f32, shaped like x), the same pass also writes the
dequantized rows ``out = q * scale``, one f32 product rounded once into
``out``'s dtype: what ``torch.mul(q, scale[:, None], out=out)`` writes. The
runtime's Worker uses it at its opt-in int8 staging boundary (paper §5.1);
:func:`repro_torch.kernels.ops.dequantize_rows` is the inverse alone, for
callers that hold only q and scale.

A row that holds a NaN gets a NaN scale and a row that holds an inf an inf
scale, as in the plain version and the reference. q and ``out`` are defined
only on rows whose scale is finite: elsewhere both versions cast a NaN to
int8.

A CPU tensor goes to :func:`quantize_int8_plain`; a CUDA tensor goes to a
kernel or raises. ``quantize_int8.launches`` counts kernel launches and
``quantize_int8.launches_by_route`` splits them by route, under a lock: the
staging threads of several Workers may launch at once.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
SM90_MAX_ROW_BYTES = 48 * 1024            # a row must fit one stage of the ring
ROUTES = ("sm90", "simt")
_LAUNCH_LOCK = threading.Lock()


def quantize_int8_plain(x: torch.Tensor, out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' arithmetic in PyTorch: returns (q int8 (R, C), scale f32 (R,)),
    and writes ``q * scale`` into ``out`` when given.

    Both divisions are tensor by tensor: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which is not the IEEE
    quotient the kernels compute.
    """
    absmax = x.float().abs().amax(dim=1).clamp_min(1e-8)
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.round(x.float() / scale[:, None]).clamp(-127, 127).to(torch.int8)
    if out is not None:
        torch.mul(q, scale[:, None], out=out)
    return q, scale


def _route(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> str:
    """The kernel that takes a CUDA call: ``sm90`` when each row is whole
    16-byte pieces that fit one stage and x and ``out`` are 16-byte aligned
    (what its bulk copies and vector stores need), else ``simt``."""
    row_bytes = x.shape[1] * x.element_size()
    if (row_bytes % 16 == 0 and row_bytes <= SM90_MAX_ROW_BYTES and x.data_ptr() % 16 == 0
            and (out is None or out.data_ptr() % 16 == 0)):
        return "sm90"
    return "simt"


def _check(x: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be one of {list(_DTYPE_CODE)}; got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"want a non-empty (R, C) tensor; got {tuple(x.shape)}")
    if out is None:
        return
    if out.dtype not in _DTYPE_CODE:
        raise TypeError(f"out must be one of {list(_DTYPE_CODE)}; got {out.dtype}")
    if out.shape != x.shape or out.is_cuda != x.is_cuda or out.get_device() != x.get_device():
        raise ValueError(f"out must be shaped like x on its device; got {tuple(out.shape)} "
                         f"on {out.device} for {tuple(x.shape)} on {x.device}")


def quantize_int8(x: torch.Tensor, out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8 (R, C), scale f32 (R,)) for x (R, C) f32 or bf16; with
    ``out`` (bf16 or f32, shaped like x) also writes the dequantized rows."""
    _check(x, out)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return quantize_int8_plain(x, out)
    if not x.is_contiguous() or (out is not None and not out.is_contiguous()):
        raise ValueError("x and out must be contiguous")
    if x.shape[0] > _INT_MAX or x.shape[1] > _INT_MAX:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's int sizes")
    return _launch(_route(x, out), x, out)


def _launch(route: str, x: torch.Tensor, out: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the kernel of ``route`` on the current stream of x's device."""
    rows, cols = x.shape
    q = torch.empty_like(x, dtype=torch.int8)
    scale = x.new_empty((rows,), dtype=torch.float32)
    # the raw stream of x's device, without building a Stream object per call
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(),
            None if out is None else out.data_ptr(), _DTYPE_CODE[x.dtype],
            0 if out is None else _DTYPE_CODE[out.dtype], rows, cols, stream)
    if route == "sm90":
        lib = _lib_sm90()
        err = lib.int8_quant_sm90_rows(*args)
        error_string = lib.int8_quant_sm90_error_string
    else:
        lib = _lib()
        err = lib.int8_quant_rows(*args)
        error_string = lib.int8_quant_error_string
    if err != 0:
        raise RuntimeError(f"int8_quant {route} kernel launch failed: "
                           f"{error_string(err).decode()} ({err})")
    _count_launch(route)
    return q, scale


quantize_int8.launches = 0
quantize_int8.launches_by_route = dict.fromkeys(ROUTES, 0)


def _count_launch(route: str) -> None:
    with _LAUNCH_LOCK:
        quantize_int8.launches += 1
        quantize_int8.launches_by_route[route] += 1


# x, q, scale, out; dtype, out_dtype, rows, cols; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("int8_quant")
    lib.int8_quant_rows.argtypes = _ARGTYPES
    lib.int8_quant_rows.restype = ctypes.c_int
    lib.int8_quant_error_string.argtypes = [ctypes.c_int]
    lib.int8_quant_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_sm90() -> ctypes.CDLL:
    lib = load_library("int8_quant_sm90")
    lib.int8_quant_sm90_rows.argtypes = _ARGTYPES
    lib.int8_quant_sm90_rows.restype = ctypes.c_int
    lib.int8_quant_sm90_error_string.argtypes = [ctypes.c_int]
    lib.int8_quant_sm90_error_string.restype = ctypes.c_char_p
    return lib
