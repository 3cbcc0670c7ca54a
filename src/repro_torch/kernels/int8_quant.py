"""Row-wise int8 quantization: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``_quant_kernel`` / ``quantize_int8`` of
``src/repro/kernels/int8_quant.py``. The kernel is ``csrc/int8_quant.cu``
(CUDA C++ for sm_90a, built by :mod:`repro_torch.kernels.build`); its header
says what bounds it on the H100 and what its design does about that.

Per row of x (R, C), f32 or bf16: ``scale = max(absmax, 1e-8) / 127`` in f32
and ``q = clip(round(x / scale), -127, 127)`` as int8, rounding half to even.
The runtime's Worker uses it at its opt-in int8 staging boundary (paper
§5.1); its inverse ``q * scale`` is the plain
:func:`repro_torch.kernels.ops.dequantize_rows` (no kernel, as in the
reference).

A row that holds a NaN gets a NaN scale and a row that holds an inf an inf
scale, as in the plain version and the reference. q is defined only on rows
whose scale is finite: elsewhere both versions cast a NaN to int8.

A CPU tensor goes to :func:`quantize_int8_plain`; a CUDA tensor goes to the
kernel or raises. ``quantize_int8.launches`` counts kernel launches, under a
lock: the staging threads of several Workers may launch at once.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
_LAUNCH_LOCK = threading.Lock()


def quantize_int8_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch: returns (q int8 (R, C), scale f32 (R,)).

    Both divisions are tensor by tensor: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which is not the IEEE
    quotient the kernel computes.
    """
    absmax = x.float().abs().amax(dim=1).clamp_min(1e-8)
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.round(x.float() / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8 (R, C), scale f32 (R,)) for x (R, C) f32 or bf16."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be one of {list(_DTYPE_CODE)}; got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"want a non-empty (R, C) tensor; got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    r, c = x.shape
    if r > _INT_MAX or c > _INT_MAX:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's int sizes")
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scale = torch.empty((r,), dtype=torch.float32, device=x.device)
    err = _lib().int8_quant_rows(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                 _DTYPE_CODE[x.dtype], r, c,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = _lib().int8_quant_error_string(err).decode()
        raise RuntimeError(f"int8_quant kernel launch failed: {msg} ({err})")
    _count_launch()
    return q, scale


quantize_int8.launches = 0


def _count_launch() -> None:
    with _LAUNCH_LOCK:
        quantize_int8.launches += 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("int8_quant")
    lib.int8_quant_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.int8_quant_rows.restype = ctypes.c_int
    lib.int8_quant_error_string.argtypes = [ctypes.c_int]
    lib.int8_quant_error_string.restype = ctypes.c_char_p
    return lib
