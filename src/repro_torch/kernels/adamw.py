"""AdamW's update: the CUDA kernel's wrapper (B3) and its plain PyTorch version.

Replaces no Pallas kernel: it is the counterpart of what XLA makes of the
reference's AdamW update (``upd`` in ``repro.train.optimizer.adamw``)
inside the reference's jitted train step, one fused pass over p, g, m and
v. ``csrc/adamw.cu``, CUDA C++ for sm_90a built by
:mod:`repro_torch.kernels.build`, updates a list of tensors in place, many
tensors a launch; its header says what bounds it and what its design does
about that.

Per element, in f32: ``m = b1*m + (1-b1)*g``, ``v = b2*v + ((1-b2)*g)*g``,
``p = p - lr*((m/bc1)/(sqrt(v/bc2) + eps) + wd*p)``, p rounded back to its
dtype; ``bc1`` and ``bc2`` are the 0-dim f32 bias corrections on the
tensors' device. The kernel rounds every step as PyTorch's eager ops do in
:func:`adamw_update_plain`, with each Python constant rounded to f32
(:func:`constants`), so the two agree bit for bit.

A CUDA tensor goes to the kernel or raises; CPU and meta tensors (the
tests, the dry run) go to :func:`adamw_update_plain`. ``adamw_update.launches``
counts kernel launches under a lock.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import threading
from typing import List, NamedTuple, Sequence, Tuple

import torch

from .build import load_library

#: elements per slice of the plain update: 64 Mi f32 temporaries are 256 MiB
CHUNK = 1 << 26
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/adamw.cu's layout: NTHREADS x ILP x (16 bytes of p) elements a unit,
# MAX_TENSORS a launch, the parameter struct's bytes
NTHREADS, ILP = 256, 4
UNIT = {torch.float32: NTHREADS * ILP * 4, torch.bfloat16: NTHREADS * ILP * 8}
MAX_TENSORS = 640
LIST_BYTES = 48 + 8 * (MAX_TENSORS + 1) + 5 * 8 * MAX_TENSORS
PARAM_LIMIT = 32764              # bytes of kernel parameters, CUDA 12.1 and later
_LAUNCH_LOCK = threading.Lock()


class Launch(NamedTuple):
    dtype: torch.dtype
    index: List[int]             # positions in the caller's lists
    unit_start: List[int]        # len(index) + 1 entries from 0


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as PyTorch takes a Python scalar
    into an f32 tensor op."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


def constants(cfg) -> Tuple[float, ...]:
    """The kernel's constants from an ``AdamWConfig``: lr, b1, 1-b1, b2, 1-b2,
    eps, weight decay, each the f32 rounding of the Python double that the
    plain version hands to PyTorch (``1 - 0.9`` is 0.09999999999999998)."""
    return tuple(f32(x) for x in (cfg.lr, cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
                                  cfg.weight_decay))


def plan_launches(tensors: Sequence[Tuple[int, torch.dtype]],
                  max_tensors: int = MAX_TENSORS) -> List[Launch]:
    """The launches for tensors of (numel, dtype): the non-empty ones grouped
    by dtype in order of first appearance, each group cut into launches of
    at most ``max_tensors``, each tensor owning ``ceil(numel / UNIT)`` work
    units of its launch."""
    groups = {}
    for i, (n, dtype) in enumerate(tensors):
        if n:
            groups.setdefault(dtype, []).append(i)
    launches = []
    for dtype, index in groups.items():
        for lo in range(0, len(index), max_tensors):
            part = index[lo:lo + max_tensors]
            starts = [0]
            for i in part:
                starts.append(starts[-1] + -(-tensors[i][0] // UNIT[dtype]))
            launches.append(Launch(dtype, part, starts))
    return launches


def _check(ps, gs, ms, vs, bc1, bc2) -> None:
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError(f"want as many p, g, m, v; got {len(ps)}, {len(gs)}, {len(ms)}, "
                         f"{len(vs)}")
    device = bc1.device
    for name, b in (("bc1", bc1), ("bc2", bc2)):
        if b.dtype != torch.float32 or b.dim() != 0 or b.device != device:
            raise ValueError(f"{name} must be a 0-dim f32 tensor on {device}; got {b.dtype} "
                             f"{tuple(b.shape)} on {b.device}")
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        if p.dtype not in _DTYPE_CODE:
            raise TypeError(f"tensor {i}: p must be one of {list(_DTYPE_CODE)}; got {p.dtype}")
        if g.dtype != p.dtype or m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError(f"tensor {i}: want g in p's {p.dtype} and m, v in f32; got "
                            f"{g.dtype}, {m.dtype}, {v.dtype}")
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"tensor {i}: shapes differ: {tuple(p.shape)}, {tuple(g.shape)}, "
                             f"{tuple(m.shape)}, {tuple(v.shape)}")
        if any(t.device != device for t in (p, g, m, v)):
            raise ValueError(f"tensor {i}: want every tensor on {device}; got {p.device}, "
                             f"{g.device}, {m.device}, {v.device}")
        if not all(t.is_contiguous() for t in (p, g, m, v)):
            raise ValueError(f"tensor {i}: p, g, m and v must be contiguous")


def _upd(p, g, m, v, bc1, bc2, cfg) -> None:
    """One slice of a tensor, in place: the reference's ``upd``."""
    g32 = g.float()
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
    del g32
    mh = m / bc1
    den = (v / bc2).sqrt_().add_(cfg.eps)
    delta = mh.div_(den).add_(cfg.weight_decay * p.float())
    del den
    p.copy_(p.float() - cfg.lr * delta)


def adamw_update_plain(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                       ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                       bc1: torch.Tensor, bc2: torch.Tensor, cfg) -> None:
    """The kernel's arithmetic in PyTorch, in place, a tensor at a time in
    slices of ``CHUNK`` elements, which bounds the f32 temporaries and
    changes no value (the update is elementwise)."""
    for p, g, m, v in zip(ps, gs, ms, vs):
        pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
        for lo in range(0, pf.numel(), CHUNK):
            sl = slice(lo, min(lo + CHUNK, pf.numel()))
            _upd(pf[sl], gf[sl], mf[sl], vf[sl], bc1, bc2, cfg)


def adamw_update(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                 ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                 bc1: torch.Tensor, bc2: torch.Tensor, cfg) -> None:
    """AdamW's update of every (p, g, m, v) in place: p f32 or bf16, g in p's
    dtype, m and v f32, all contiguous and of one shape, on ``bc1``'s device.
    On the card the kernel, as many launches as ``plan_launches`` gives, on
    the current stream; on the CPU (or meta) the plain version."""
    _check(ps, gs, ms, vs, bc1, bc2)
    if bc1.device.type != "cuda":
        adamw_update_plain(ps, gs, ms, vs, bc1, bc2, cfg)
        return
    launches = plan_launches([(p.numel(), p.dtype) for p in ps])
    if not launches:
        return
    lib = _lib()
    consts = (ctypes.c_float * 7)(*constants(cfg))
    index = bc1.get_device()
    with torch.cuda.device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        for launch in launches:
            k = len(launch.index)
            ptrs = [(ctypes.c_void_p * k)(*(ts[i].data_ptr() for i in launch.index))
                    for ts in (ps, gs, ms, vs)]
            err = lib.adamw_update(_DTYPE_CODE[launch.dtype], k, *ptrs,
                                   (ctypes.c_int64 * k)(*(ps[i].numel() for i in launch.index)),
                                   (ctypes.c_int64 * (k + 1))(*launch.unit_start),
                                   bc1.data_ptr(), bc2.data_ptr(), consts, stream)
            if err != 0:
                raise RuntimeError(f"adamw kernel launch failed: "
                                   f"{lib.adamw_error_string(err).decode()} ({err})")
            with _LAUNCH_LOCK:
                adamw_update.launches += 1


adamw_update.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("adamw")
    lib.adamw_update.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                                 + [ctypes.c_void_p] * 4)
    lib.adamw_update.restype = ctypes.c_int
    lib.adamw_error_string.argtypes = [ctypes.c_int]
    lib.adamw_error_string.restype = ctypes.c_char_p
    lib.adamw_max_tensors.restype = ctypes.c_int
    lib.adamw_list_bytes.restype = ctypes.c_longlong
    lib.adamw_unit.argtypes = [ctypes.c_int]
    lib.adamw_unit.restype = ctypes.c_longlong
    built = (lib.adamw_max_tensors(), lib.adamw_list_bytes(),
             {dt: lib.adamw_unit(code) for dt, code in _DTYPE_CODE.items()})
    if built != (MAX_TENSORS, LIST_BYTES, UNIT):
        raise RuntimeError(f"csrc/adamw.cu's layout {built} is not the binding's "
                           f"{(MAX_TENSORS, LIST_BYTES, UNIT)}")
    return lib
