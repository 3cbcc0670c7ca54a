"""Mamba2 SSD chunk scan: the CUDA kernels' wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_scan`` of
``src/repro/kernels/ssd_scan.py``. Two CUDA C++ kernels for sm_90a, built by
:mod:`repro_torch.kernels.build`, take a CUDA call by its dtype
and shape (:func:`_route`):

- bf16 with N and P multiples of 8 and P ≤ 128 → ``sm90``:
  ``csrc/ssd_scan_sm90.cu``, all four products on ``wgmma``, chunks by TMA
  through an mbarrier ring, warp-specialised;
- f32, and bf16 of any other N or P → ``simt``: ``csrc/ssd_scan.cu``, the
  products on the CUDA cores in f32.

Each header says what bounds its kernel on the H100 and what its design
does about that. The route is chosen from the shape before any launch;
nothing falls back from one kernel to the other on failure. The limits
both kernels share (chunk and N in 1..128) raise. :func:`_ssd_scan_simt`
reaches the ``simt`` kernel at bf16 for any shape, for timing the two
designs side by side; the main path never calls it.

Layout: x (BH, S, P); dt (BH, S) f32, post-softplus; A (BH,) f32, negative;
B and C (BH / heads_per_group, S, N), row ``i`` of x reading group row
``i // heads_per_group`` (with ``heads_per_group=1`` this is the TPU
kernel's per-head interface). Returns y (BH, S, P) in x's dtype and the
final state (BH, N, P) f32. ``S`` must be a multiple of ``chunk``; an
optional ``initial_state`` (BH, N, P) f32 replaces the zero state. The
``sm90`` kernel rounds W, the state that C·state reads and the decayed X to
bf16 before their products; the plain version keeps them in f32.

A CPU tensor goes to :func:`ssd_scan_plain`; a CUDA tensor goes to a kernel
or raises. ``ssd_scan.launches`` counts kernel launches and
``ssd_scan.launches_by_route`` splits them by route, under a lock.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from .build import load_library

MAX_CHUNK = 128
MAX_STATE = 128
SM90_MAX_WIDTH = 128                     # N and P of the sm90 kernel
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("sm90", "simt")
_LAUNCH_LOCK = threading.Lock()


def ssd_scan_plain(
    x: torch.Tensor,                     # (BH, S, P)
    dt: torch.Tensor,                    # (BH, S)
    A: torch.Tensor,                     # (BH,)
    Bm: torch.Tensor,                    # (BH / heads_per_group, S, N)
    Cm: torch.Tensor,
    *,
    chunk: int = 128,
    heads_per_group: int = 1,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's arithmetic in PyTorch: f32 throughout, one chunk at a
    time, every row at once."""
    bh, s, p = x.shape
    n = Bm.shape[-1]
    bm = torch.repeat_interleave(Bm, heads_per_group, dim=0).float()
    cm = torch.repeat_interleave(Cm, heads_per_group, dim=0).float()
    a = A.float()[:, None]
    if initial_state is None:
        state = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    else:
        state = initial_state.float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, s, chunk):
        xq = x[:, t0:t0 + chunk].float()
        dtq = dt[:, t0:t0 + chunk].float()
        bq, cq = bm[:, t0:t0 + chunk], cm[:, t0:t0 + chunk]
        cum = torch.cumsum(dtq * a, dim=-1)                    # (BH, Q)
        total = cum[:, -1:]
        # select, never multiply: exp overflows to inf where j > i; the
        # exponent is selected too, so autograd's exp' there is not inf · 0
        diff = torch.where(tri, cum[:, :, None] - cum[:, None, :], 0.0)
        L = torch.where(tri, torch.exp(diff), 0.0)
        w = torch.bmm(cq, bq.transpose(1, 2)) * L * dtq[:, None, :]
        y = torch.bmm(w, xq) + torch.bmm(cq, state) * torch.exp(cum)[:, :, None]
        xw = xq * (torch.exp(total - cum) * dtq)[:, :, None]
        state = torch.bmm(bq.transpose(1, 2), xw) + torch.exp(total)[:, :, None] * state
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), state


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, chunk: int, g: int,
           initial_state: Optional[torch.Tensor]) -> None:
    tensors = [x, dt, A, Bm, Cm] + ([] if initial_state is None else [initial_state])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x, B, C must share a dtype in {list(_DTYPE_CODE)}; got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, {A.dtype}")
    if x.dim() != 3 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"want x (BH,S,P), B = C (BG,S,N); got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    bh, s, p = x.shape
    n = Bm.shape[-1]
    if g < 1 or bh != Bm.shape[0] * g or Bm.shape[1] != s:
        raise ValueError(f"x {tuple(x.shape)} does not match B {tuple(Bm.shape)} "
                         f"with heads_per_group={g}")
    if tuple(dt.shape) != (bh, s) or tuple(A.shape) != (bh,):
        raise ValueError(f"want dt ({bh}, {s}) and A ({bh},); got {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    if initial_state is not None and (tuple(initial_state.shape) != (bh, n, p)
                                      or initial_state.dtype != torch.float32):
        raise ValueError(f"initial_state must be float32 ({bh}, {n}, {p}); got "
                         f"{initial_state.dtype} {tuple(initial_state.shape)}")
    if s < 1 or chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} is not a positive multiple of chunk {chunk}")


def _sm90_takes(p: int, n: int) -> bool:
    """N and P in multiples of 8 (16-byte rows for TMA), P up to 128."""
    return n % 8 == 0 and p % 8 == 0 and p <= SM90_MAX_WIDTH


def _route(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The kernel that takes a CUDA call: ``sm90`` for bf16 of a shape it
    takes (:func:`_sm90_takes`), ``simt`` for f32 and every other bf16 shape.

    Raises ``ValueError`` for a chunk or state size neither kernel takes."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must be in 1..{MAX_CHUNK}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n} must be in 1..{MAX_STATE}")
    if dtype == torch.bfloat16:
        return "sm90" if _sm90_takes(p, n) else "simt"
    if dtype == torch.float32:
        return "simt"
    raise TypeError(f"no SSD scan kernel for {dtype}")


def ssd_scan(
    x: torch.Tensor,                     # (BH, S, P)
    dt: torch.Tensor,                    # (BH, S)
    A: torch.Tensor,                     # (BH,)
    Bm: torch.Tensor,                    # (BH / heads_per_group, S, N)
    Cm: torch.Tensor,
    *,
    chunk: int = 128,
    heads_per_group: int = 1,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (BH, S, P), final_state (BH, N, P) f32)."""
    g = heads_per_group
    _check(x, dt, A, Bm, Cm, chunk, g, initial_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, heads_per_group=g,
                              initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    route = _route(x.dtype, x.shape[2], Bm.shape[2], chunk)
    return _launch(route, x, dt, A, Bm, Cm, chunk, g, initial_state)


def _ssd_scan_simt(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int = 128,
    heads_per_group: int = 1,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core kernel at either dtype, bf16 included; for timing only."""
    _check(x, dt, A, Bm, Cm, chunk, heads_per_group, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"the simt kernel needs a CUDA tensor, got {x.device}")
    return _launch("simt", x, dt, A, Bm, Cm, chunk, heads_per_group, initial_state)


def _launch(route: str, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, chunk: int, g: int,
            initial_state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Checks what the kernel of ``route`` takes, then launches it on x's stream."""
    bh, s, p = x.shape
    n = Bm.shape[-1]
    if route == "sm90":
        if x.dtype != torch.bfloat16 or _route(x.dtype, p, n, chunk) != "sm90":
            raise ValueError(f"the sm90 kernel takes bf16 with N and P multiples of 8 and "
                             f"P up to {SM90_MAX_WIDTH}; got {x.dtype}, N {n}, P {p}")
    elif chunk > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"chunk {chunk} and state size {n} must be at most "
                         f"{MAX_CHUNK} and {MAX_STATE}")
    named = [("x", x), ("dt", dt), ("A", A), ("B", Bm), ("C", Cm)]
    if initial_state is not None:
        named.append(("initial_state", initial_state))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if route == "sm90":                  # TMA reads x, B and C
        for name, t in (("x", x), ("B", Bm), ("C", Cm)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty_like(x)
    state = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), state.data_ptr())
    shape = (bh, s, p, n, chunk, g, torch.cuda.current_stream(x.device).cuda_stream)
    if route == "sm90":
        lib = _lib_sm90()
        err = lib.ssd_scan_sm90_fwd(*args, *shape)
        error_string = lib.ssd_scan_sm90_error_string
    else:
        lib = _lib()
        err = lib.ssd_scan_fwd(*args, _DTYPE_CODE[x.dtype], *shape)
        error_string = lib.ssd_scan_error_string
    if err != 0:
        raise RuntimeError(f"ssd_scan {route} kernel launch failed: "
                           f"{error_string(err).decode()} ({err})")
    _count_launch(route)
    return y, state


ssd_scan.launches = 0
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)


def _count_launch(route: str) -> None:
    with _LAUNCH_LOCK:
        ssd_scan.launches += 1
        ssd_scan.launches_by_route[route] += 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_sm90() -> ctypes.CDLL:
    lib = load_library("ssd_scan_sm90")
    lib.ssd_scan_sm90_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    lib.ssd_scan_sm90_fwd.restype = ctypes.c_int
    lib.ssd_scan_sm90_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_sm90_error_string.restype = ctypes.c_char_p
    return lib
