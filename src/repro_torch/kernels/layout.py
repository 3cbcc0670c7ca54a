"""The (B, S, H, W) operand layout of K2's and K3's ``sm90`` kernels.

The model makes attention's q, k, v and the SSD scan's x, B, C as
(batch, sequence, heads, width) tensors, often views: slices of one fused
projection, or of the causal convolution's output at a token stride of
x|B|C's whole width. The ``sm90`` kernels read such an operand in place
through a TMA tensor map over (W, S, H, B) (K3 splits S into its chunks)
and write their results at the strides of the tensors the wrappers
allocate, so no layout copy is made around them. A map takes a unit
stride in W, every other stride a multiple of 16 bytes, and a 16-byte
aligned base: :func:`kernel_strides` gives a launch its operands' strides
as the kernels' int64 array, checks them and raises otherwise, built once
a layout (``_STRIDES``).

The flattened layouts of the kernels' older interface, (B·H, S, W) for
K2's q, k, v and K3's x and (B·G, S, N) for B and C, are the (B, S, H, W)
layout of a contiguous (B, H, S, W) tensor: :func:`rows_as_bshw` gives
that view, so both interfaces reach one kernel. The ``simt`` kernels and
the plain versions keep the flattened contiguous layout:
:func:`bshw_as_rows` and :func:`rows_to_bshw` copy to and from it.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence, Tuple

import torch

MAP_ALIGN = 16                           # bytes: TMA's stride and base alignment
_STRIDES: Dict[tuple, "ctypes.Array"] = {}
_COUNT_LOCK = threading.Lock()


def _checked(name: str, shape, stride, itemsize: int) -> Tuple[int, int, int]:
    """The (batch, sequence, head) strides of a (B, S, H, W) layout that a
    tensor map reads: ``ValueError`` unless W has unit stride and every
    other stride is a multiple of 16 bytes. A dim of extent 1 is only ever
    read at 0, so its stride is taken as 16 bytes whatever PyTorch reports."""
    if stride[3] != 1 and shape[3] > 1:
        raise ValueError(f"{name} must be contiguous in its last dim (unit stride); got "
                         f"strides {tuple(stride)}")
    unit = MAP_ALIGN // itemsize
    out = []
    for d in (0, 1, 2):
        s = stride[d] if shape[d] > 1 else unit
        if s % unit or s <= 0:
            raise ValueError(f"{name}: stride {stride[d]} of dim {d} is not a positive "
                             f"multiple of {MAP_ALIGN} bytes; strides {tuple(stride)}")
        out.append(s)
    return out[0], out[1], out[2]


def kernel_strides(operands: Sequence[tuple]) -> "ctypes.Array":
    """The kernels' int64 array of (batch, sequence, head) strides, in
    elements, of each ``(name, tensor, heads, mapped)`` in order. A tensor in
    the model's layout, (B, S, H, W) or dt's (B, S, H), gives its own; a
    flattened one, (B·H, S, W) or (B·H, S), those of its (B, S, H, ·) view
    with ``heads`` heads. A ``mapped`` operand (read through a tensor map or
    written in 16-byte units) must be one a map takes (:func:`_checked`)
    and 16-byte aligned, else ``ValueError``. Built once a layout: the
    array is cached on the operands' shapes and strides, the alignment
    checked every call."""
    key = tuple((name, t.shape, t.stride(), t.dtype, heads, mapped)
                for name, t, heads, mapped in operands)
    for name, t, _, mapped in operands:
        if mapped and t.data_ptr() % MAP_ALIGN:
            raise ValueError(f"{name} must be 16-byte aligned")
    array = _STRIDES.get(key)
    if array is None:
        st = []
        for name, t, heads, mapped in operands:
            stride, shape = t.stride(), t.shape
            if t.dim() == (4 if mapped else 3):                      # the model's layout
                bsh = stride[:3]
            else:                                                    # flattened rows
                bsh = (heads * stride[0], stride[1], stride[0])
                shape = (shape[0] // heads, shape[1], heads, *shape[2:])
                stride = (*bsh, *stride[2:])
            if mapped:
                bsh = _checked(name, shape, stride, t.element_size())
            st.extend(bsh)
        array = _STRIDES.setdefault(key, (ctypes.c_longlong * len(st))(*st))
    return array


def rows_as_bshw(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B·H, S, ...) viewed as (B, S, H, ...): the flattened rows, b-major."""
    return t.unflatten(0, (t.shape[0] // heads, heads)).transpose(1, 2)


def bshw_as_rows(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, ...) copied to the contiguous flattened (B·H, S, ...)."""
    return t.transpose(1, 2).flatten(0, 1).contiguous()


def rows_to_bshw(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B·H, S, ...) copied to a contiguous (B, S, H, ...)."""
    return rows_as_bshw(t, heads).contiguous()


def count_copies(fn, route: str, pairs) -> None:
    """Adds to ``fn.layout_copies[route]`` how many of the (result, source)
    pairs are copies, not views: a layout change that found its source
    already in place copies nothing."""
    n = sum(a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr() for a, b in pairs)
    with _COUNT_LOCK:
        fn.layout_copies[route] += n
