"""Mamba2's causal depthwise convolution: the CUDA kernels' wrappers (B5),
the plain PyTorch version and its adjoint.

Replaces no Pallas kernel: the kernels are the counterpart of what XLA
fuses out of the reference's ``repro.models.ssm.causal_conv1d`` (the
history's concatenation, W taps, the bias, SiLU) inside its jitted steps.
``csrc/causal_conv1d.cu``, CUDA C++ for sm_90a built by
:mod:`repro_torch.kernels.build`, holds the forward and adjoint kernels; its
header says what bounds them (bytes) and what their design does about that.

The function, over x (B, S, C) and an optional (B, W-1, C) ``state`` of the
W-1 inputs before t = 0 (zeros where None): ``xin = [state, x]``,
``out[t] = silu(Σ_i xin[t+i]·w[i] + b)`` with each tap's product and each
add rounded to x's dtype, as :func:`causal_conv1d_plain` computes it, and
the new state ``xin[S:S+W-1]``. The forward kernel equals the plain version
bit for bit; it reads x at its (b, s) strides, so the model hands it the
x|B|C columns of the input projection in place. One kernel serves
prefill, training and decode (S = 1, with the cache's state).

The adjoint (:func:`causal_conv1d_bwd`; plain :func:`causal_conv1d_bwd_plain`,
written out by hand in f32) recomputes the pre-activation with the same
roundings and gives dx (the taps shifted the other way, one pass), the
state's gradient where asked, and dw, db as f32 partial rows summed in a
fixed order and rounded once. Training goes through
:class:`CausalConv1dFn`.

A CUDA tensor goes to the kernels or raises; CPU tensors (the tests) take
the plain versions. Each wrapper counts its launches under a lock, in
``launches`` and in ``launches_by_route``. The forward's routes
(``FWD_ROUTES``), by layout alone (:func:`fwd_route`): ``staged`` (tiles of
x brought to shared memory by TMA, a persistent grid of the measured
residency, ``fwd_plan``: x, the state, every pointer and row stride 16-byte
aligned, C a whole number of 16 bytes, more than one step), else
``vector`` (the register-window kernel in 8-byte units: C and every row
start 8-byte aligned; a decode step), else ``scalar`` (the same a channel at
a time); its checks and plan are made once a layout (:func:`_fwd_layout`).
The adjoint's: ``vector``, the staged kernel (tiles
of x and G brought to shared memory by TMA: x, G, every pointer and row
stride 16-byte aligned), or ``scalar``, the register-window kernel a channel
a thread. :func:`conv_preactivation` returns the staged adjoint's
recomputed pre-activation, for the tests that hold it to the forward's.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .build import load_library, require

ROUTES = ("vector", "scalar")
FWD_ROUTES = ("staged", "vector", "scalar")
# csrc/causal_conv1d.cu's layout: the window forward's and the scalar
# adjoint's L time steps a thread, blocks of UNITS_X channel units by
# TILES_Y tiles, widths up to MAX_W; the staged adjoint's tiles of TL steps
# by CHUNK_BYTES of channels, SEG steps a warp; the staged forward's tiles
# of FWD_TL steps by FWD_CHUNK_BYTES, FWD_SEG steps a warp
L, UNITS_X, TILES_Y, MAX_W = 16, 32, 8, 4
TL, SEG, CHUNK_BYTES = 64, 8, 128
FWD_TL, FWD_SEG, FWD_CHUNK_BYTES = 64, 8, 256
MAX_GRID_Y = 65535
_DTYPES = (torch.float32, torch.bfloat16)
# the mode int: the route in bits 0-1 (the forward's staged route 2), the
# dtype bit, the width from bit 3
_ROUTE_CODE = {"scalar": 0, "vector": 1, "staged": 2}
_MODE_DTYPE, _MODE_W_SHIFT, _MODE_DEVICE_SHIFT = 4, 3, 8
_LAUNCH_LOCK = threading.Lock()
_LL, _P = ctypes.c_longlong, ctypes.c_void_p
_IP = ctypes.POINTER(ctypes.c_int)
# mode, x, state, w, b, out, new_state, B, S, C, xsb, xss, grid, stream
_FWD_ARGTYPES = [ctypes.c_int, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P]
# mode, x, state, w, b, g, dx, dstate, dwb, part, pre, B, S, C, xsb, xss, grid, slots, stream
_BWD_ARGTYPES = [ctypes.c_int] + [_P] * 10 + [_LL] * 7 + [_P]


def _history(x: torch.Tensor, width: int, state: Optional[torch.Tensor]):
    """(the state, zeros where None; xin = [state, x], (B, S+W-1, C))."""
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    return state, torch.cat([state, x], dim=1)


def causal_conv1d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (B, S, C); returns (silu(y), new_state).

    ``state`` is the trailing (width-1) inputs from the previous call (used
    at decode time); None means zero history. The taps accumulate in x's
    dtype, one rounding per tap, as the reference does."""
    width = w.shape[0]
    bsz, s, c = x.shape
    state, xin = _history(x, width, state)
    y = torch.zeros((bsz, s, c), dtype=x.dtype, device=x.device)
    for i in range(width):
        y = y + xin[:, i:i + s] * w[i]
    y = y + b
    new_state = xin[:, -(width - 1):] if width > 1 else state
    return F.silu(y), new_state


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The plain adjoint's arithmetic: f32 (f64 where x is)."""
    return torch.promote_types(torch.float32, dtype)


def causal_conv1d_bwd_plain(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, state: Optional[torch.Tensor] = None,
                            need_dstate: bool = False):
    """The gradients of :func:`causal_conv1d_plain`'s output by x, w, b and
    (where asked) the state, in f32 (f64 where x is): the pre-activation
    recomputed with the forward's roundings, ``dpre = g·silu'(pre)``
    (``silu'(v) = s·(1 + v·(1 − s))``, s the sigmoid), ``dx[t] = Σ_i
    dpre[t+W−1−i]·w[i]`` (taps in ascending order), ``dw[i] = Σ dpre[u]·
    xin[u+i]``, ``db = Σ dpre``, the state's row j ``Σ_{i≤j} dpre[j−i]·w[i]``.
    Returns (dx, dw, db, dstate or None), each rounded once to its tensor's
    dtype."""
    width = w.shape[0]
    bsz, s, c = x.shape
    wide = _wide(x.dtype)
    _, xin = _history(x, width, state)
    pre = torch.zeros((bsz, s, c), dtype=x.dtype, device=x.device)
    for i in range(width):
        pre = pre + xin[:, i:i + s] * w[i]
    pre = (pre + b).to(wide)
    sig = torch.sigmoid(pre)
    dpre = g.to(wide) * (sig * (1 + pre * (1 - sig)))
    # dpre at xin's positions: row j of xin takes dpre[j - i] of tap i
    padded = torch.cat([dpre, dpre.new_zeros((bsz, width - 1, c))], dim=1)   # u < S+W-1
    ww = w.to(wide)
    dxin = torch.zeros((bsz, s + width - 1, c), dtype=wide, device=x.device)
    for i in range(width):                     # row j: dpre[j - i] * w[i], i ascending
        shifted = torch.cat([dpre.new_zeros((bsz, i, c)), padded[:, :s + width - 1 - i]], dim=1)
        dxin = dxin + shifted * ww[i]
    xw = xin.to(wide)
    dw = torch.stack([(dpre * xw[:, i:i + s]).sum((0, 1)) for i in range(width)])
    db = dpre.sum((0, 1))
    dstate = dxin[:, :width - 1].to(x.dtype) if need_dstate and state is not None else None
    return dxin[:, width - 1:].to(x.dtype), dw.to(w.dtype), db.to(b.dtype), dstate


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _count(fn, route: str) -> None:
    with _LAUNCH_LOCK:
        fn.launches += 1
        fn.launches_by_route[route] += 1


def _raise(name: str, err: int) -> None:
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{_lib().causal_conv1d_error_string(err).decode()} ({err})")


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _residency(device: int, route: str, bf16: bool, width: int) -> int:
    """Blocks of the adjoint's kernel for ``route`` an SM of ``device`` holds
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for the
    built kernel, its shared memory included)."""
    mode = (_ROUTE_CODE[route] | (_MODE_DTYPE if bf16 else 0) | width << _MODE_W_SHIFT
            | device << _MODE_DEVICE_SHIFT)
    n = _lib().causal_conv1d_bwd_residency(mode)
    if n <= 0:
        _raise("causal_conv1d_bwd_residency", -n if n else 1)
    return n


def bwd_attributes(route: str, bf16: bool, width: int, device: int) -> dict:
    """The adjoint kernel's registers a thread and local memory (its stack
    frame, spills included) on ``route`` as the runtime reports them."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    mode = (_ROUTE_CODE[route] | (_MODE_DTYPE if bf16 else 0) | width << _MODE_W_SHIFT
            | device << _MODE_DEVICE_SHIFT)
    err = _lib().causal_conv1d_bwd_attributes(mode, ctypes.byref(regs), ctypes.byref(local))
    if err:
        _raise("causal_conv1d_bwd_attributes", err)
    return {"registers": regs.value, "local_bytes": local.value}


@functools.lru_cache(maxsize=None)
def _fwd_residency(device: int, bf16: bool, width: int) -> int:
    """Blocks of the staged forward kernel an SM of ``device`` holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, its shared memory
    included)."""
    n = _lib().causal_conv1d_fwd_residency(_mode("staged", torch.bfloat16 if bf16
                                                 else torch.float32, width, device))
    if n <= 0:
        _raise("causal_conv1d_fwd_residency", -n if n else 1)
    return n


def fwd_attributes(route: str, bf16: bool, width: int, device: int) -> dict:
    """The forward kernel's registers a thread and local memory (its stack
    frame, spills included) on ``route`` as the runtime reports them."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().causal_conv1d_fwd_attributes(
        _mode(route, torch.bfloat16 if bf16 else torch.float32, width, device),
        ctypes.byref(regs), ctypes.byref(local))
    if err:
        _raise("causal_conv1d_fwd_attributes", err)
    return {"registers": regs.value, "local_bytes": local.value}


def fwd_units(batch: int, seq: int, channels: int, esize: int) -> int:
    """The staged forward's units: chunks of FWD_CHUNK_BYTES × batch ×
    FWD_SEG-step segments."""
    return -(-channels * esize // FWD_CHUNK_BYTES) * batch * -(-seq // FWD_SEG)


def fwd_plan(batch: int, seq: int, channels: int, esize: int, sms: int, per_sm: int) -> int:
    """The staged forward's grid for ``sms`` SMs that hold ``per_sm`` of its
    blocks at once: a persistent grid of at most one wave, ``sms · per_sm``
    blocks over the units, at least one each (the kernel gives block g the
    units [g·units/grid, (g+1)·units/grid)). A short sequence (a decode
    step: one segment a chunk and sequence) is a tile of one segment, so its
    units spread over as many blocks as the card holds."""
    return max(1, min(sms * per_sm, fwd_units(batch, seq, channels, esize)))


def staged_units(batch: int, seq: int, channels: int, esize: int) -> Tuple[int, int]:
    """(the staged adjoint's units: chunks × batch × SEG-step segments, the
    units of one chunk)."""
    per_chunk = batch * -(-seq // SEG)
    return -(-channels * esize // CHUNK_BYTES) * per_chunk, per_chunk


def plan(batch: int, seq: int, channels: int, esize: int, route: str, sms: int,
         per_sm: int) -> Tuple[int, int]:
    """The adjoint's grid and its partial rows (slots), for ``sms`` SMs that
    hold ``per_sm`` of the route's blocks at once.

    ``vector`` (the staged kernel): a persistent grid of at most one wave,
    ``sms · per_sm`` blocks over the units (at least a tile's worth each),
    and the partial rows a chunk's units can meet: ``ceil(per_chunk /
    (units // grid)) + 1``. ``scalar``: ``grid`` blocks over the tiles
    (grid.y), at most a wave over the channel blocks, one partial row
    each."""
    wave = max(1, sms * per_sm)
    if route == "vector":
        units, per_chunk = staged_units(batch, seq, channels, esize)
        grid = max(1, min(wave, -(-units // (TL // SEG))))
        return grid, min(grid, -(-per_chunk // (units // grid)) + 1)
    gx = -(-channels // UNITS_X)
    need = -(-batch * -(-seq // L) // TILES_Y)
    grid = max(1, min(need, -(-wave // gx), MAX_GRID_Y))
    return grid, grid


def conv_checks(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor]):
    """The kernels' conditions as (ok, message) pairs, each shape read once:
    x (B, S>=1, C) with the channels contiguous; x, w, b and the state of
    one dtype, f32 or bf16; w (W, C) with W <= ``MAX_W``, b (C,) and the
    state (B, W-1, C) contiguous; one card; the tiles within the grid."""
    if x.dim() != 3 or w.dim() != 2:
        return ((False, "x (B, S, C) and w (W, C)"),)
    (bsz, s, c), width, dtype, dev = x.shape, w.shape[0], x.dtype, x.get_device()
    return (
        (x.stride(-1) == 1 and s >= 1, "x (B, S>=1, C), channels contiguous"),
        (dtype in _DTYPES and w.dtype == dtype and b.dtype == dtype,
         "x, w and b of one dtype, f32 or bf16"),
        (w.shape == (width, c) and b.shape == (c,) and w.is_contiguous() and b.is_contiguous(),
         "w (W, C) and b (C,) contiguous"),
        (1 <= width <= MAX_W, "width 1..MAX_W"),
        (state is None or (state.shape == (bsz, width - 1, c) and state.dtype == dtype
                           and state.is_contiguous()),
         "state (B, W-1, C) of x's dtype, contiguous"),
        (w.get_device() == dev and b.get_device() == dev
         and (state is None or state.get_device() == dev), "one device"),
        (-(-bsz * -(-s // L) // TILES_Y) <= MAX_GRID_Y, "at most MAX_GRID_Y blocks of tiles"))


# the forward's layouts that passed its checks (``_layout_key``): (B, S, C,
# x's element size, W, x's strides, the staged grid where the shape takes
# that route, else 0, each route's mode bits, the device)
_FWD_LAYOUTS: dict = {}


def _layout_key(x, w, b, state) -> tuple:
    """What :func:`conv_checks` reads of the forward's inputs: x's shape,
    strides, dtype and device; w's, b's and the state's shape, dtype,
    device and contiguity."""
    return (x.shape, x.stride(), x.dtype, x.get_device(),
            w.shape, w.dtype, w.get_device(), w.is_contiguous(),
            b.shape, b.dtype, b.get_device(), b.is_contiguous(),
            None if state is None else (state.shape, state.dtype, state.get_device(),
                                        state.is_contiguous()))


def _fwd_layout(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor]) -> tuple:
    """The forward's checks (:func:`conv_checks`, raising on a refusal) and,
    where the shape takes the staged route, its grid (:func:`fwd_plan`),
    made once a layout."""
    key = _layout_key(x, w, b, state)
    lay = _FWD_LAYOUTS.get(key)
    if lay is None:
        require("causal_conv1d_fwd", conv_checks(x, w, b, state), x, w, b, state)
        (bsz, s, c), width, dtype, dev = x.shape, w.shape[0], x.dtype, x.get_device()
        es = x.element_size()
        xsb, xss, _ = x.stride()
        grid = (fwd_plan(bsz, s, c, es, _sm_count(dev),
                         _fwd_residency(dev, dtype == torch.bfloat16, width))
                if fwd_route(s, c, es, xsb, xss, 0) == "staged" else 0)
        lay = (bsz, s, c, es, width, xsb, xss, grid,
               {r: _mode(r, dtype, width, dev) for r in FWD_ROUTES}, dev)
        if len(_FWD_LAYOUTS) >= 4096:
            _FWD_LAYOUTS.clear()
        _FWD_LAYOUTS[key] = lay
    return lay


def fwd_route(steps: int, channels: int, esize: int, xsb: int, xss: int,
              pointers: int) -> str:
    """The forward's route for a layout: ``staged`` where C's bytes, x's
    (b, s) strides and every pointer (``pointers``, their bits or-ed) are
    16-byte aligned, as TMA takes them, and there is more than one step;
    else ``vector`` where they are 8-byte aligned; else ``scalar``. A decode
    step (S = 1) keeps the register-window kernel: it has no tile to stage,
    and it timed faster there (PERF.md)."""
    bits = channels * esize | xsb * esize | xss * esize | pointers
    if bits % 16 == 0 and steps > 1:
        return "staged"
    return "vector" if bits % 8 == 0 else "scalar"


def causal_conv1d_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(silu of the taps (B, S, C), new state (B, W-1, C)) of
    :func:`causal_conv1d_plain`: on the card one launch of the forward
    kernel on the current stream (x, w, b and state of one dtype, f32 or
    bf16; x at its (b, s) strides with the channels contiguous; w, b and
    state contiguous; W <= ``MAX_W``), on :func:`fwd_route`'s route; on the
    CPU the plain version."""
    if not x.is_cuda:
        return causal_conv1d_plain(x, w, b, state)
    bsz, s, c, es, width, xsb, xss, grid, modes, dev = _fwd_layout(x, w, b, state)
    out = x.new_empty((bsz, s, c))
    if width == 1:
        new_state, ns = (state if state is not None else x.new_zeros((bsz, 0, c))), 0
    else:
        new_state = x.new_empty((bsz, width - 1, c))
        ns = new_state.data_ptr()
    sp = 0 if state is None else state.data_ptr()
    xp, wp, bp, op = x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr()
    route = fwd_route(s, c, es, xsb, xss, xp | wp | bp | op | sp | ns)
    err = _lib().causal_conv1d_fwd(modes[route], xp, sp or None, wp, bp, op, ns or None, bsz, s,
                                   c, xsb, xss, grid, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise("causal_conv1d_fwd", err)
    _count(causal_conv1d_fwd, route)
    return out, new_state


causal_conv1d_fwd.launches = 0
causal_conv1d_fwd.launches_by_route = dict.fromkeys(FWD_ROUTES, 0)


def _mode(route: str, dtype: torch.dtype, width: int, device: int) -> int:
    return (_ROUTE_CODE[route] | (_MODE_DTYPE if dtype == torch.bfloat16 else 0)
            | width << _MODE_W_SHIFT | device << _MODE_DEVICE_SHIFT)


def _bwd_checks(g, x, w, b, state):
    return conv_checks(x, w, b, state) + (
        (g.shape == x.shape and g.dtype == x.dtype and g.is_contiguous()
         and g.get_device() == x.get_device(), "g shaped like x, of its dtype, contiguous"),)


def _staged_ok(x, g, es: int, ptrs) -> bool:
    """The staged route's conditions: TMA's 16-byte alignment of x, G and
    their row strides, C a whole number of 16 bytes; 16-byte pointers."""
    c, (xsb, xss, _) = x.shape[-1], x.stride()
    pa = 0
    for p in ptrs:
        pa |= p
    return c * es % 16 == 0 and (xsb * es | xss * es) % 16 == 0 and pa % 16 == 0


def _bwd(name: str, g, x, w, b, state, need_dstate: bool, route: Optional[str],
         keep_pre: bool = False):
    """One launch of the adjoint and its sum pass on ``route`` (None: the
    staged kernel where it takes the layout, else ``scalar``); returns (the
    route, dx, dw, db, dstate or None, the pre-activation or None)."""
    require(name, _bwd_checks(g, x, w, b, state), x, w, b, state, g)
    (bsz, s, c), width, dtype, dev = x.shape, w.shape[0], x.dtype, x.get_device()
    es = x.element_size()
    dx = torch.empty((bsz, s, c), dtype=dtype, device=x.device)
    dwb = torch.empty((width + 1, c), dtype=dtype, device=x.device)
    dstate = (torch.empty((bsz, width - 1, c), dtype=dtype, device=x.device)
              if need_dstate and state is not None else None)
    pre = torch.empty((bsz, s, c), dtype=dtype, device=x.device) if keep_pre else None
    xsb, xss, _ = x.stride()
    sp = 0 if state is None else state.data_ptr()
    dsp = 0 if dstate is None else dstate.data_ptr()
    pp = 0 if pre is None else pre.data_ptr()
    xp, wp, bp, gp, dp, dwp = (x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                               dx.data_ptr(), dwb.data_ptr())
    ptrs = (xp, wp, bp, gp, dp, sp, dsp, pp)
    if route is None:
        route = "vector" if _staged_ok(x, g, es, ptrs) else "scalar"
    elif route == "vector":
        require(name, ((_staged_ok(x, g, es, ptrs),
                        "x, g, every pointer and row stride 16-byte aligned"),), x, g)
    per_sm = _residency(dev, route, dtype == torch.bfloat16, width)
    grid, slots = plan(bsz, s, c, es, route, _sm_count(dev), per_sm)
    part = torch.empty((slots, width + 1, c), dtype=torch.float32, device=x.device)
    err = _lib().causal_conv1d_bwd(_mode(route, dtype, width, dev), xp, sp or None, wp, bp, gp,
                                   dp, dsp or None, dwp, part.data_ptr(), pp or None, bsz, s, c,
                                   xsb, xss, grid, slots, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise(name, err)
    return route, dx, dwb[:width], dwb[width], dstate, pre


def causal_conv1d_bwd(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      state: Optional[torch.Tensor] = None, need_dstate: bool = False):
    """(dx (B, S, C) contiguous, dw, db, dstate or None) of
    :func:`causal_conv1d_bwd_plain`: on the card one launch of the adjoint
    kernel and its sum pass (inputs as the forward takes them, g (B, S, C)
    contiguous of x's dtype): the staged kernel where x, g, every pointer
    and row stride are 16-byte aligned and C a whole number of 16 bytes, the
    ``scalar`` route otherwise; on the CPU the plain version."""
    if not x.is_cuda:
        return causal_conv1d_bwd_plain(g, x, w, b, state, need_dstate)
    route, dx, dw, db, dstate, _ = _bwd("causal_conv1d_bwd", g, x, w, b, state, need_dstate,
                                        None)
    _count(causal_conv1d_bwd, route)
    return dx, dw, db, dstate


causal_conv1d_bwd.launches = 0
causal_conv1d_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def conv_preactivation(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pre-activation (B, S, C) the staged adjoint recomputes (packed bf16
    products and sums in bf16), from one launch of it; for the checks that
    hold it to the forward's bit for bit. Raises where the staged route does
    not take the layout."""
    *_, pre = _bwd("conv_preactivation", g, x, w, b, state, False, "vector", keep_pre=True)
    _count(conv_preactivation, "vector")
    return pre


conv_preactivation.launches = 0
conv_preactivation.launches_by_route = dict.fromkeys(ROUTES, 0)


class CausalConv1dFn(torch.autograd.Function):
    """:func:`causal_conv1d_fwd` with :func:`causal_conv1d_bwd` as the
    backward: x's, w's, b's and the state's gradients. Gradients are not
    materialised; the new state's (where it reaches the loss) is added to
    the inputs it copies. On the CPU both directions take their plain
    versions."""

    @staticmethod
    def forward(ctx, x, w, b, state):
        out, new_state = causal_conv1d_fwd(x, w, b, state)
        ctx.save_for_backward(x, w, b, state)
        ctx.set_materialize_grads(False)
        return out, new_state

    @staticmethod
    @once_differentiable
    def backward(ctx, g, g_state):
        x, w, b, state = ctx.saved_tensors
        need_dstate = state is not None and ctx.needs_input_grad[3]
        if g is None:
            g = torch.zeros_like(x, memory_format=torch.contiguous_format)
        dx, dw, db, dstate = causal_conv1d_bwd(g.to(x.dtype).contiguous(), x, w, b, state,
                                               need_dstate)
        if g_state is not None and w.shape[0] > 1:
            # new_state = xin[S:S+W-1]: its rows are x's last rows and,
            # where S < W-1, the state's last rows
            w1, s = w.shape[0] - 1, x.shape[1]
            if s >= w1:
                dx[:, s - w1:] += g_state.to(dx.dtype)
            else:
                dx += g_state[:, w1 - s:].to(dx.dtype)
                if dstate is not None:
                    dstate[:, s:] += g_state[:, :w1 - s].to(dstate.dtype)
        return dx, dw, db, dstate


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points' argument and result types on a built
    ``csrc/causal_conv1d.cu`` (or a variant of it, as the probes build)."""
    lib.causal_conv1d_fwd.argtypes = _FWD_ARGTYPES
    lib.causal_conv1d_fwd.restype = ctypes.c_int
    lib.causal_conv1d_fwd_residency.argtypes = [ctypes.c_int]
    lib.causal_conv1d_fwd_residency.restype = ctypes.c_int
    lib.causal_conv1d_fwd_attributes.argtypes = [ctypes.c_int, _IP, _IP]
    lib.causal_conv1d_fwd_attributes.restype = ctypes.c_int
    lib.causal_conv1d_bwd.argtypes = _BWD_ARGTYPES
    lib.causal_conv1d_bwd.restype = ctypes.c_int
    lib.causal_conv1d_bwd_residency.argtypes = [ctypes.c_int]
    lib.causal_conv1d_bwd_residency.restype = ctypes.c_int
    lib.causal_conv1d_bwd_attributes.argtypes = [ctypes.c_int, _IP, _IP]
    lib.causal_conv1d_bwd_attributes.restype = ctypes.c_int
    lib.causal_conv1d_error_string.argtypes = [ctypes.c_int]
    lib.causal_conv1d_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(load_library("causal_conv1d"))
