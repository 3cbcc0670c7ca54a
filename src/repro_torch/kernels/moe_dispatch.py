"""The MoE layer's dispatch and combine: the CUDA kernels' wrappers (B2) and
their plain PyTorch versions.

Replaces no Pallas kernel: the two kernels are the counterpart of what XLA
makes of the reference's sort dispatch inside ``repro.models.moe.moe_ffn``,
the buffer's scatter and the combine's gather-scale-mask and scatter-add.
``csrc/moe_dispatch.cu``, CUDA C++ for sm_90a built by
:mod:`repro_torch.kernels.build`, holds both; its header says what bounds
each (bytes) and what its design does about that.

* :func:`moe_fill`: the (E, C, D) expert buffer in one pass, slot (e, c)
  holding ``rows[src[e, c]]``, or zeros where ``src[e, c]`` is the
  sentinel ``fill`` (the number of rows);
* :func:`moe_combine`: each token's k gated contributions
  ``y[expert, slot] · gate`` (+0.0 where dropped) added in ascending sorted
  position, i.e. by expert id, every product and sum rounded to y's dtype,
  as :func:`moe_combine_plain` adds them, so the two agree bit for bit.
  The kernel reads the plan's sorted entries as they are and, built here
  by torch ops, the argsort's inverse permutation (:func:`inverse_order`),
  which gives each token's k sorted positions; a warp orders them itself.

A CUDA tensor goes to the kernel or raises; CPU and meta tensors (the
tests, the dry run) go to the plain versions. Each wrapper counts its
launches under a lock, in ``launches`` and in ``launches_by_route``:
``vector`` (16-byte vectors: D a multiple of 8 bf16 or 4 f32 elements,
the tensors 16-byte aligned) or ``scalar`` (an element at a time).
Neither kernel has a backward: ``ops`` refuses a CUDA input that
requires a gradient.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from .build import load_library

ROUTES = ("vector", "scalar")
MAX_K = 32                       # a token's assignments: one a lane of a warp
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH_LOCK = threading.Lock()


def _route(d: int, *tensors: torch.Tensor) -> str:
    """``vector`` where rows of D elements are whole 16-byte vectors and
    every tensor starts on a 16-byte boundary, else ``scalar``."""
    whole = d * tensors[0].element_size() % 16 == 0
    return "vector" if whole and all(t.data_ptr() % 16 == 0 for t in tensors) else "scalar"


def _on(t: torch.Tensor):
    """The context that makes ``t``'s card current (none where it is)."""
    index = t.get_device()
    return contextlib.nullcontext() if index == torch.cuda.current_device() \
        else torch.cuda.device(index)


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s card, as the kernels take it."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _count(fn, route: str) -> None:
    with _LAUNCH_LOCK:
        fn.launches += 1
        fn.launches_by_route[route] += 1


def moe_fill_plain(rows: torch.Tensor, src: torch.Tensor, fill: int) -> torch.Tensor:
    """``rows`` (N, D) gathered into a contiguous (E, C, D) buffer by ``src``
    (E, C): slot (e, c) holds ``rows[src[e, c]]``, zeros where ``src[e, c]``
    is ``fill`` (= N). The rows with a zero row appended, indexed."""
    padded = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    return padded[src].contiguous()


def moe_combine_plain(y: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
                      gate: torch.Tensor, keep: torch.Tensor, order: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """Each token's gated contributions ``y[expert, slot] · gate`` of the
    sorted assignments (zero where not ``keep``; a dropped assignment's slot
    may be C), added per token in ascending sorted position, i.e. by expert
    id: the order in which the reference's scatter-add applies them.
    y (E, C, D); the rest are the plan's (T·k,) sorted entries. Returns
    (T, D) in y's dtype."""
    e, _, d = y.shape
    ypad = torch.cat([y, torch.zeros((e, 1, d), dtype=y.dtype, device=y.device)], dim=1)
    contrib = ypad[expert, slot] * gate[:, None].to(ypad.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros((), dtype=ypad.dtype,
                                                              device=ypad.device))
    per_token = contrib[inverse_order(order).view(-1, k).sort(dim=1).values]   # (t, k, D)
    out2d = per_token[:, 0]
    for j in range(1, k):
        out2d = out2d + per_token[:, j]
    return out2d


def inverse_order(order: torch.Tensor) -> torch.Tensor:
    """The inverse of the plan's argsort: ``inverse[order[p]] = p``, so token
    t's k assignments sit at sorted positions ``inverse[t·k : t·k + k]``."""
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=order.device)
    return inverse


def _check_fill(rows: torch.Tensor, src: torch.Tensor, fill: int) -> None:
    if rows.dim() != 2 or src.dim() != 2:
        raise ValueError(f"moe_fill: want rows (N, D) and src (E, C); got "
                         f"{tuple(rows.shape)}, {tuple(src.shape)}")
    if fill != rows.shape[0]:
        raise ValueError(f"moe_fill: the sentinel must be the number of rows "
                         f"{rows.shape[0]}; got {fill}")
    if src.device != rows.device:
        raise ValueError(f"moe_fill: rows on {rows.device}, src on {src.device}")


def moe_fill(rows: torch.Tensor, src: torch.Tensor, fill: int) -> torch.Tensor:
    """The (E, C, D) buffer of :func:`moe_fill_plain`, contiguous: on the card
    one launch of the fill kernel on the current stream (rows f32 or bf16
    and contiguous, src int32 and contiguous); on the CPU (or meta) the
    plain version."""
    _check_fill(rows, src, fill)
    if rows.device.type != "cuda":
        return moe_fill_plain(rows, src, fill)
    if rows.dtype not in _DTYPE_CODE or src.dtype != torch.int32:
        raise TypeError(f"moe_fill: want rows in {list(_DTYPE_CODE)} and src int32; got "
                        f"{rows.dtype}, {src.dtype}")
    if not (rows.is_contiguous() and src.is_contiguous()):
        raise ValueError("moe_fill: rows and src must be contiguous")
    e, c = src.shape
    n, d = rows.shape
    out = torch.empty((e, c, d), dtype=rows.dtype, device=rows.device)
    if out.numel() == 0:
        return out
    route = _route(d, rows, out)
    lib = _lib()
    with _on(rows):
        err = lib.moe_fill(_DTYPE_CODE[rows.dtype], int(route == "vector"), rows.data_ptr(),
                           src.data_ptr(), out.data_ptr(), e * c, n, d, _stream(rows))
    if err != 0:
        raise RuntimeError(f"moe_fill kernel launch failed: "
                           f"{lib.moe_error_string(err).decode()} ({err})")
    _count(moe_fill, route)
    return out


moe_fill.launches = 0
moe_fill.launches_by_route = dict.fromkeys(ROUTES, 0)


def moe_combine(y: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
                keep: torch.Tensor, order: torch.Tensor, k: int) -> torch.Tensor:
    """The (T, D) output of :func:`moe_combine_plain`: on the card the plan's
    inverse permutation (:func:`inverse_order`) and one launch of the
    combine kernel on the current stream (y f32 or bf16 and contiguous;
    expert, slot and order int64, keep bool, gate f32, each contiguous;
    k ≤ ``MAX_K``); on the CPU (or meta) the plain version."""
    if y.dim() != 3 or order.shape[0] % k:
        raise ValueError(f"moe_combine: want y (E, C, D) and T·k assignments; got "
                         f"{tuple(y.shape)}, {order.shape[0]} for k {k}")
    if y.device.type != "cuda":
        return moe_combine_plain(y, expert, slot, gate, keep, order, k)
    plan = {"expert": (expert, torch.int64), "slot": (slot, torch.int64),
            "order": (order, torch.int64), "keep": (keep, torch.bool),
            "gate": (gate, torch.float32)}
    if y.dtype not in _DTYPE_CODE or any(t.dtype != dt for t, dt in plan.values()):
        raise TypeError(f"moe_combine: want y in {list(_DTYPE_CODE)} and the plan as "
                        f"{ {n: dt for n, (_, dt) in plan.items()} }; got y {y.dtype}, "
                        f"{ {n: t.dtype for n, (t, _) in plan.items()} }")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"moe_combine: k must be in 1..{MAX_K}; got {k}")
    if not (y.is_contiguous() and all(t.is_contiguous() and t.shape == order.shape
                                      for t, _ in plan.values())):
        raise ValueError("moe_combine: y and the plan's (T·k,) entries must be contiguous")
    if any(t.device != y.device for t, _ in plan.values()):
        raise ValueError(f"moe_combine: want the plan on y's {y.device}")
    e, cap, d = y.shape
    tokens = order.shape[0] // k
    out = torch.empty((tokens, d), dtype=y.dtype, device=y.device)
    if out.numel() == 0:
        return out
    inverse = inverse_order(order)
    route = _route(d, y, out)
    lib = _lib()
    with _on(y):
        err = lib.moe_combine(_DTYPE_CODE[y.dtype], int(route == "vector"), y.data_ptr(),
                              inverse.data_ptr(), expert.data_ptr(), slot.data_ptr(),
                              keep.data_ptr(), gate.data_ptr(), out.data_ptr(), tokens, k, d, e,
                              cap, _stream(y))
    if err != 0:
        raise RuntimeError(f"moe_combine kernel launch failed: "
                           f"{lib.moe_error_string(err).decode()} ({err})")
    _count(moe_combine, route)
    return out


moe_combine.launches = 0
moe_combine.launches_by_route = dict.fromkeys(ROUTES, 0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("moe_dispatch")
    lib.moe_fill.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                             + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    lib.moe_fill.restype = ctypes.c_int
    lib.moe_combine.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                                + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 3
                                + [ctypes.c_void_p])
    lib.moe_combine.restype = ctypes.c_int
    lib.moe_error_string.argtypes = [ctypes.c_int]
    lib.moe_error_string.restype = ctypes.c_char_p
    return lib
