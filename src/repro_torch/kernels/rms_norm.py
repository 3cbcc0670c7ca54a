"""RMSNorm, plain and Mamba2's gated form: the CUDA kernels' wrappers (B4),
their plain PyTorch versions and their adjoints.

Replaces no Pallas kernel: the kernels are the counterpart of what XLA
fuses out of the reference's ``repro.models.layers.rms_norm`` and of the
tail of ``repro.models.ssm.mamba2_mixer`` (``y + xh·D``, ``·silu(z)``, the
norm) inside its jitted steps. ``csrc/rms_norm.cu``, CUDA C++ for sm_90a
built by :mod:`repro_torch.kernels.build`, holds both forms' forward and
adjoint kernels; its header says what bounds them (bytes) and what their
design does about that.

* plain (:func:`rms_norm_plain`): f32 statistics over the last dim,
  ``x·rsqrt(mean(x²)+eps)`` rounded to x's dtype, *then* times ``scale``
  in x's dtype (the reference's order);
* gated (:func:`gated_rms_norm_plain`): ``y + xh·D`` in f32 (y the SSD
  scan's output, xh its input as (B, S, H, P), D (H,) f32), rounded to the
  model's dtype; times ``silu(z)``, silu rounded first, the product
  rounded; then the plain form.

The forward kernels round every step where these eager chains round it, so
their output equals the plain one bit for bit wherever a row's f32 sum of
squares comes out equal (the kernel adds in its own order). They keep each
row's f32 ``rstd`` for the adjoints when asked. The adjoints
(:func:`rms_norm_bwd`, :func:`gated_rms_norm_bwd`; plain versions
:func:`rms_norm_bwd_plain`, :func:`gated_rms_norm_bwd_plain`, written out by
hand in f32) give dx, for the gated form dy (in y's layout), dxh and dz,
and the gradients of ``scale`` and of D as f32 partials of blocks of rows,
summed in a fixed order and rounded once.

Training goes through :class:`RmsNormFn` and :class:`GatedRmsNormFn`. A
CUDA tensor goes to the kernels or raises; CPU tensors (the tests) take the
plain versions, the forward's and the adjoint's. Each wrapper counts its
launches under a lock, in ``launches`` and in ``launches_by_route``:
``vector`` (16-byte units: every row start, stride and the width, for the
gated form a head, whole 16-byte pieces) or ``scalar`` (an element at a
time).
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
# csrc/rms_norm.cu's layout: the forward's thread holds at most ELEMS
# elements of a row, a row takes at most MAX_TPR threads, a block
# max(ROW_BLOCK, tpr) threads; the one-pass adjoint's row takes at most
# BWD_MAX_TPR threads, NU units each (BWD_NU on the vector route, the
# gated form first, then the plain; SCALAR_NU elements on the scalar), a
# block BWD_ROW_BLOCK // tpr rows where a row takes fewer threads
ELEMS, MAX_TPR, ROW_BLOCK = 32, 512, 256
BWD_MAX_TPR, BWD_ROW_BLOCK, BWD_NU, SCALAR_NU = 1024, 512, (1, 2, 4), 16
MAX_WIDTH = MAX_TPR * ELEMS
_DTYPES = (torch.float32, torch.bfloat16)
_F32 = torch.float32
_MODE_DTYPE, _MODE_GATED, _MODE_Y_F32, _MODE_DEVICE_SHIFT = 2, 4, 8, 8
_LAUNCH_LOCK = threading.Lock()
_I, _LL, _P, _F = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# mode, x, y, xh, z, D, scale, out, rstd, rows, d, x_stride, S, P, strides, eps, tpr, stream
_FWD_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _P, _F, _I, _P]
# mode, x, y, xh, z, D, scale, g, rstd, dx, dy, dxh, dz, dD, dscale, part, part_d,
# rows, d, x_stride, S, P, strides, tpr, nu, blocks, stream
_BWD_ARGTYPES = [_I] + [_P] * 16 + [_LL] * 5 + [_P, _I, _I, _LL, _P]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics, cast to x's dtype, *then* multiply by ``scale``: the
    eager chain of ``repro_torch.models.layers.rms_norm``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def gated_product_plain(y: torch.Tensor, xh: torch.Tensor, D: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
    """``(y + xh·D)`` in f32 rounded to z's dtype, times ``silu(z)``: the
    gated form's input to the norm, (B, S, H·P). y, xh (B, S, H, P), D (H,)
    f32, z (B, S, H·P)."""
    b, s, h, p = xh.shape
    pre = y + xh * D[None, None, :, None]
    return pre.reshape(b, s, h * p).to(z.dtype) * F.silu(z)


def gated_rms_norm_plain(y: torch.Tensor, xh: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                         scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The tail of ``mamba2_mixer``: :func:`rms_norm_plain` of
    :func:`gated_product_plain`, in z's dtype."""
    return rms_norm_plain(gated_product_plain(y, xh, D, z), scale, eps).to(z.dtype)


def _rstd_plain(x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    return torch.rsqrt(torch.mean(x32 * x32, dim=-1) + eps)


def rms_norm_fwd_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                       keep_rstd: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(:func:`rms_norm_plain`, the rows' f32 rstd where asked, else None)."""
    return rms_norm_plain(x, scale, eps), _rstd_plain(x, eps) if keep_rstd else None


def gated_rms_norm_fwd_plain(y: torch.Tensor, xh: torch.Tensor, D: torch.Tensor,
                             z: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                             keep_rstd: bool = False
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(:func:`gated_rms_norm_plain`, the rows' f32 rstd where asked)."""
    g = gated_product_plain(y, xh, D, z)
    out = rms_norm_plain(g, scale, eps).to(z.dtype)
    return out, _rstd_plain(g, eps) if keep_rstd else None


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(_F32, dtype)


def _norm_bwd_rows(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                   rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain norm's adjoint in f32 (f64 where x is): (dx, dscale) unrounded,
    for x (..., d), g like x, rstd (...)."""
    wide = _wide(x.dtype)
    xw, gw, r = x.to(wide), g.to(wide), rstd.to(wide)[..., None]
    d = x.shape[-1]
    n_rounded = (xw * r).to(x.dtype).to(wide)
    dscale = (gw * n_rounded).reshape(-1, d).sum(0)
    dn = gw * scale.to(wide)
    dot = (dn * xw).sum(-1, keepdim=True)
    dx = r * dn - xw * (r * r * r * dot / d)
    return dx, dscale


def rms_norm_bwd_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                       rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`rms_norm_plain` by x and ``scale``, in f32
    from the forward's ``rstd`` (rows of x): with n = x·r,
    ``dscale = Σ_rows g·round(n)``, ``dn = g·scale``,
    ``dx = r·dn − x·r³·Σ(dn·x)/d``; each rounded once to its tensor's
    dtype. g is the output's gradient, shaped like x."""
    dx, dscale = _norm_bwd_rows(g, x, scale, rstd)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def gated_rms_norm_bwd_plain(g: torch.Tensor, y: torch.Tensor, xh: torch.Tensor,
                             D: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                             rstd: torch.Tensor):
    """The gradients of :func:`gated_rms_norm_plain` by y, xh, D, z and
    ``scale``, in f32 from the forward's ``rstd`` (B, S): the plain norm's
    adjoint over the gated product gp = round(yT·sz) (yT = round(y + xh·D),
    sz = round(silu(z))) gives dgp; then ``dpre = dgp·sz``,
    ``dz = dgp·yT·silu'(z)``, ``dy = dpre``, ``dxh = dpre·D`` and
    ``dD = Σ dpre·xh`` over each head's elements and rows. Returns (dy, dxh,
    dD, dz, dscale), each rounded once: dy to y's dtype in y's shape, dxh
    and dz to theirs, dD f32, dscale to scale's."""
    wide = _wide(z.dtype)
    b, s, h, p = xh.shape
    pre = y.to(wide) + xh.to(wide) * D.to(wide)[None, None, :, None]
    yT = pre.reshape(b, s, h * p).to(z.dtype).to(wide)
    zw = z.to(wide)
    sz = F.silu(zw).to(z.dtype).to(wide)
    gp = (yT * sz).to(z.dtype)
    dgp, dscale = _norm_bwd_rows(g, gp, scale, rstd)
    sig = torch.sigmoid(zw)
    dz = dgp * yT * (sig * (1 + zw * (1 - sig)))
    dpre = (dgp * sz).reshape(b, s, h, p)
    dD = (dpre * xh.to(wide)).sum((0, 1, 3))
    dxh = dpre * D.to(wide)[None, None, :, None]
    return (dpre.to(y.dtype), dxh.to(xh.dtype), dD.to(D.dtype), dz.to(z.dtype),
            dscale.to(scale.dtype))


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _count(fn, route: str) -> None:
    with _LAUNCH_LOCK:
        fn.launches += 1
        fn.launches_by_route[route] += 1


def _raise(name: str, err: int) -> None:
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{_lib().rms_norm_error_string(err).decode()} ({err})")


@functools.lru_cache(maxsize=None)
def plan(d: int, vector: bool, esize: int) -> Tuple[int, int]:
    """(threads a row, threads a block) for rows of ``d`` elements of
    ``esize`` bytes: the least power of two whose threads hold the row at
    ``ELEMS`` elements each (in 16-byte units on the ``vector`` route), the
    block ``max(ROW_BLOCK, tpr)``. Wider rows than ``MAX_WIDTH`` raise."""
    v = 16 // esize if vector else 1
    units, per = -(-d // v), ELEMS // v
    tpr = 1
    while tpr * per < units:
        tpr *= 2
    if tpr > MAX_TPR:
        raise ValueError(f"rms_norm: rows of {d} elements; the kernel takes at most {MAX_WIDTH}")
    return tpr, max(ROW_BLOCK, tpr)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def bwd_plan(d: int, vector: bool, esize: int, gated: bool) -> Tuple[int, int, int]:
    """(units a thread NU, threads a row tpr, threads a block) of the one-pass
    adjoint for rows of ``d`` elements: NU the least of ``BWD_NU`` from 1
    (gated) or 2 (plain) whose threads hold the row within ``BWD_MAX_TPR``
    (``SCALAR_NU`` elements on the scalar route); tpr the units over NU, a
    power of two up to 32, else a multiple of 32; the block
    ``BWD_ROW_BLOCK // tpr`` rows where tpr < ``BWD_ROW_BLOCK``, else one."""
    v = 16 // esize if vector else 1
    units = -(-d // v)
    if vector:
        nus = [n for n in BWD_NU if n >= (1 if gated else 2)]
        nu = next((n for n in nus if -(-units // n) <= BWD_MAX_TPR), nus[-1])
    else:
        nu = SCALAR_NU
    need = -(-units // nu)
    if need > BWD_MAX_TPR:
        raise ValueError(f"rms_norm: rows of {d} elements; the adjoint takes at most "
                         f"{BWD_MAX_TPR * nu * v}")
    tpr = 1 << (need - 1).bit_length() if need <= 32 else -(-need // 32) * 32
    return nu, tpr, tpr if tpr >= BWD_ROW_BLOCK else BWD_ROW_BLOCK // tpr * tpr


def bwd_blocks(rows: int, groups: int, sms: int, per_sm: int) -> int:
    """The one-pass adjoint's grid: a persistent wave, ``sms · per_sm``
    blocks (what the card holds at once), no more than the row groups of
    ``groups`` rows; each block writes one partial row."""
    return max(1, min(-(-rows // groups), sms * per_sm))


@functools.lru_cache(maxsize=None)
def _bwd_residency(device: int, mode: int, nu: int, tpr: int, d: int) -> int:
    """Blocks of the one-pass adjoint an SM of ``device`` holds at once for
    this plan (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for the
    built kernel and its shared memory)."""
    n = _lib().rms_norm_bwd_residency(mode, nu, tpr, d)
    if n <= 0:
        _raise("rms_norm_bwd_residency", -n if n else 1)
    return n


def bwd_attributes(dtype: torch.dtype, gated: bool, device: int, vector: bool = True,
                   nu: int = 0) -> dict:
    """The adjoint kernel's registers a thread and local memory (its stack
    frame, spills included) as the runtime reports them, for ``nu`` units a
    thread."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    mode = _mode(vector, dtype, device, gated=gated)
    err = _lib().rms_norm_bwd_attributes(mode, nu, ctypes.byref(regs), ctypes.byref(local))
    if err:
        _raise("rms_norm_bwd_attributes", err)
    return {"registers": regs.value, "local_bytes": local.value}


def _bwd_grid(rows: int, d: int, vector: bool, esize: int, gated: bool, mode: int,
              device: int) -> Tuple[int, int, int]:
    """(tpr, nu, blocks) of the adjoint: the one-pass plan on a persistent
    grid of the measured residency."""
    nu, tpr, block = bwd_plan(d, vector, esize, gated)
    per_sm = _bwd_residency(device, mode, nu, tpr, d)
    return tpr, nu, bwd_blocks(rows, block // tpr, _sm_count(device), per_sm)


def _row_stride(x: torch.Tensor) -> Optional[int]:
    """The stride between x's rows (all dims but the last, the last
    contiguous), or None where they are not evenly spaced."""
    if x.is_contiguous():
        return x.shape[-1]
    if x.stride(-1) != 1:
        return None
    stride = expect = None
    for size, st in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != expect:
            return None
        expect = st * size
    return x.shape[-1] if stride is None else stride


def norm_checks(x: torch.Tensor, scale: torch.Tensor, rs: Optional[int]):
    """The plain form's conditions as (ok, message) pairs, ``rs`` x's row
    stride (:func:`_row_stride`): x f32 or bf16 with its rows evenly spaced
    and the last dim contiguous, ``scale`` (d,) of x's dtype, contiguous,
    on the same card."""
    d = x.shape[-1]
    return ((rs is not None, "x's rows evenly spaced, the last dim contiguous"),
            (x.dtype in _DTYPES and scale.dtype == x.dtype,
             "x and scale of one dtype, f32 or bf16"),
            (scale.shape == (d,) and scale.is_contiguous(), "scale (d,) contiguous"),
            (0 < d <= MAX_WIDTH, "rows of 1..MAX_WIDTH elements"),
            (scale.get_device() == x.get_device(), "x and scale on one device"))


def gated_checks(y: torch.Tensor, xh: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                 scale: torch.Tensor):
    """The gated form's layout conditions as (ok, message) pairs: y and xh
    (B, S, H, P), z (B, S, H·P), the last dims contiguous, xh's heads
    adjacent in a row; D (H,) f32 and ``scale`` (H·P,) contiguous; one card."""
    if xh.dim() != 4:
        return ((False, "xh (B, S, H, P)"),)
    (b, s, h, p), d, dev = xh.shape, z.shape[-1], z.get_device()
    return ((y.shape == xh.shape and z.shape == (b, s, d) and d == h * p,
             "y, xh (B, S, H, P) and z (B, S, H*P)"),
            (y.stride(-1) == 1 and xh.stride(-1) == 1 and xh.stride(-2) == p
             and z.stride(-1) == 1, "the last dims contiguous, xh's heads adjacent in a row"),
            (D.shape == (h,) and D.dtype == _F32 and D.is_contiguous(), "D (H,) f32 contiguous"),
            (scale.shape == (d,) and scale.is_contiguous(), "scale (H*P,) contiguous"),
            (0 < d <= MAX_WIDTH, "rows of 1..MAX_WIDTH elements"),
            (y.get_device() == xh.get_device() == D.get_device() == scale.get_device() == dev,
             "one device"))


def _mode(vector: bool, dtype: torch.dtype, device: int, gated: bool = False,
          y_f32: bool = False) -> int:
    return (int(vector) | (_MODE_DTYPE if dtype == torch.bfloat16 else 0)
            | (_MODE_GATED if gated else 0) | (_MODE_Y_F32 if y_f32 else 0)
            | device << _MODE_DEVICE_SHIFT)


def _strides(*vals: int):
    return (_LL * len(vals))(*vals)


# the plain forward's layouts that passed its checks, keyed by x's and
# scale's (shape, strides, dtype, device): (rows, d, row stride, whether the
# shape takes 16-byte units, tpr and mode bits of each route, the device)
_FWD_LAYOUTS: dict = {}


def _fwd_layout(x: torch.Tensor, scale: torch.Tensor) -> tuple:
    """The plain forward's checks (:func:`norm_checks`, raising on a refusal)
    and plan for x's and scale's layout, made once a layout."""
    key = (x.shape, x.stride(), x.dtype, x.device, scale.shape, scale.stride(), scale.dtype,
           scale.device)
    lay = _FWD_LAYOUTS.get(key)
    if lay is None:
        rs = _row_stride(x)
        require("rms_norm_fwd", norm_checks(x, scale, rs), x, scale)
        d, dev, es = x.shape[-1], x.get_device(), x.element_size()
        vector = d * es % 16 == 0 and rs * es % 16 == 0
        lay = (x.numel() // d, d, rs, vector, plan(d, True, es)[0] if vector else 0,
               plan(d, False, es)[0], _mode(True, x.dtype, dev), _mode(False, x.dtype, dev), dev)
        if len(_FWD_LAYOUTS) >= 4096:
            _FWD_LAYOUTS.clear()
        _FWD_LAYOUTS[key] = lay
    return lay


def rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                 keep_rstd: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the plain form's output, rows' f32 rstd or None): on the card one
    launch of the forward kernel on the current stream (x f32 or bf16 with
    its rows evenly spaced and the last dim contiguous, ``scale`` (d,) of
    x's dtype, contiguous, on the same card); on the CPU the plain
    version. The checks (:func:`norm_checks`) and the plan are made once a
    layout (:func:`_fwd_layout`); a call reads its pointers' alignment."""
    if not x.is_cuda:
        return rms_norm_fwd_plain(x, scale, eps, keep_rstd)
    rows, d, rs, shape_vector, tpr_v, tpr_s, mode_v, mode_s, dev = _fwd_layout(x, scale)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rstd = torch.empty(x.shape[:-1], dtype=_F32, device=x.device) if keep_rstd else None
    xp, sp, op = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    vector = shape_vector and (xp | sp | op) % 16 == 0
    err = _lib().rms_norm_fwd(mode_v if vector else mode_s, xp, None, None, None, None, sp, op,
                              None if rstd is None else rstd.data_ptr(), rows, d, rs, 0, 0, None,
                              eps, tpr_v if vector else tpr_s,
                              torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise("rms_norm_fwd", err)
    _count(rms_norm_fwd, "vector" if vector else "scalar")
    return out, rstd


rms_norm_fwd.launches = 0
rms_norm_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def gated_rms_norm_fwd(y: torch.Tensor, xh: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                       scale: torch.Tensor, eps: float = 1e-5, keep_rstd: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the gated form's output (B, S, H·P) in z's dtype, the rows' f32 rstd
    (B, S) or None): on the card one launch of the forward kernel (xh, z and
    scale of one dtype, f32 or bf16; y of it or f32; each read where it
    lies, at its strides); on the CPU the plain version."""
    if not z.is_cuda:
        return gated_rms_norm_fwd_plain(y, xh, D, z, scale, eps, keep_rstd)
    dtype, dev = z.dtype, z.get_device()
    require("gated_rms_norm_fwd", gated_checks(y, xh, D, z, scale) + (
        (dtype in _DTYPES and xh.dtype == scale.dtype == dtype,
         "xh, z and scale of one dtype, f32 or bf16"),
        (y.dtype == dtype or y.dtype == _F32, "y of z's dtype or f32")), y, xh, D, z, scale)
    (b, s, h, p), d = xh.shape, z.shape[-1]
    out = torch.empty((b, s, d), dtype=dtype, device=z.device)
    rstd = torch.empty((b, s), dtype=_F32, device=z.device) if keep_rstd else None
    es, ys = z.element_size(), y.element_size()
    (ysb, yss, ysh, _), (xsb, xss, _, _), (zsb, zss, _) = y.stride(), xh.stride(), z.stride()
    ptrs = (y.data_ptr(), xh.data_ptr(), z.data_ptr(), scale.data_ptr(), out.data_ptr())
    vector = (p * es % 16 == 0 and (ysb * ys | yss * ys | ysh * ys) % 16 == 0
              and (xsb * es | xss * es | zsb * es | zss * es) % 16 == 0
              and (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]) % 16 == 0)
    tpr, _ = plan(d, vector, es)
    mode = _mode(vector, dtype, dev, gated=True, y_f32=y.dtype != dtype)
    err = _lib().rms_norm_fwd(mode, None, ptrs[0], ptrs[1], ptrs[2], D.data_ptr(), ptrs[3],
                              ptrs[4], None if rstd is None else rstd.data_ptr(), b * s, d, 0, s,
                              p, _strides(ysb, yss, ysh, xsb, xss, zsb, zss), eps, tpr,
                              torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise("gated_rms_norm_fwd", err)
    _count(gated_rms_norm_fwd, "vector" if vector else "scalar")
    return out, rstd


gated_rms_norm_fwd.launches = 0
gated_rms_norm_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def _norm_bwd(name: str, g, x, scale, rstd):
    d, dev, dtype = x.shape[-1], x.get_device(), x.dtype
    rs = _row_stride(x)
    require(name, norm_checks(x, scale, rs) + (
        (g.shape == x.shape and g.dtype == dtype and g.is_contiguous(),
         "g shaped like x, of its dtype, contiguous"),
        (rstd.dtype == _F32 and rstd.is_contiguous() and rstd.numel() * d == x.numel(),
         "rstd f32, contiguous, one a row"),
        (g.get_device() == rstd.get_device() == dev, "one device")), x, scale, g, rstd)
    rows = x.numel() // d
    es = x.element_size()
    dx = torch.empty(x.shape, dtype=dtype, device=x.device)
    dscale = torch.empty_like(scale)
    xp, gp, dp, sp = x.data_ptr(), g.data_ptr(), dx.data_ptr(), scale.data_ptr()
    vector = d * es % 16 == 0 and rs * es % 16 == 0 and (xp | gp | dp | sp) % 16 == 0
    mode = _mode(vector, dtype, dev)
    tpr, nu, blocks = _bwd_grid(rows, d, vector, es, False, mode, dev)
    part = torch.empty((blocks, d), dtype=_F32, device=x.device)
    err = _lib().rms_norm_bwd(mode, xp, None, None, None, None, sp, gp, rstd.data_ptr(), dp,
                              None, None, None, None, dscale.data_ptr(), part.data_ptr(), None,
                              rows, d, rs, 0, 0, None, tpr, nu, blocks,
                              torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise(name, err)
    return "vector" if vector else "scalar", dx, dscale


def rms_norm_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                 rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's shape, contiguous; dscale) of :func:`rms_norm_bwd_plain`:
    on the card one launch of the one-pass adjoint kernel and its sum pass
    (g contiguous, shaped like x and of its dtype; rstd the forward's, f32,
    contiguous); on the CPU the plain version."""
    if not x.is_cuda:
        return rms_norm_bwd_plain(g, x, scale, rstd)
    route, dx, dscale = _norm_bwd("rms_norm_bwd", g, x, scale, rstd)
    _count(rms_norm_bwd, route)
    return dx, dscale


rms_norm_bwd.launches = 0
rms_norm_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def _like_strided(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor with t's strides where they are dense (a permuted
    contiguous tensor: the SSD kernel's output seen as (B, S, H, P)), else
    contiguous."""
    order = sorted(range(t.dim()), key=lambda i: t.stride(i))
    expect = 1
    for i in order:
        if t.shape[i] != 1 and t.stride(i) != expect:
            return torch.empty(t.shape, dtype=t.dtype, device=t.device)
        expect *= t.shape[i]
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)


def _gated_bwd(name: str, g, y, xh, D, z, scale, rstd):
    dtype, dev = z.dtype, z.get_device()
    require(name, gated_checks(y, xh, D, z, scale) + (
        (dtype in _DTYPES and y.dtype == xh.dtype == scale.dtype == g.dtype == dtype,
         "y, xh, z, scale and g of one dtype, f32 or bf16"),
        (g.shape == z.shape and g.is_contiguous(), "g shaped like z, contiguous"),
        (rstd.dtype == _F32 and rstd.is_contiguous() and rstd.shape == z.shape[:2],
         "rstd (B, S) f32 contiguous"),
        (g.get_device() == rstd.get_device() == dev, "one device")), y, xh, D, z, scale, g, rstd)
    (b, s, h, p), d = xh.shape, z.shape[-1]
    es = z.element_size()
    dy = _like_strided(y)
    dxh = torch.empty((b, s, h, p), dtype=dtype, device=z.device)
    dz = torch.empty((b, s, d), dtype=dtype, device=z.device)
    dD = torch.empty((h,), dtype=_F32, device=z.device)
    dscale = torch.empty_like(scale)
    strides = (*y.stride()[:3], *xh.stride()[:2], *z.stride()[:2], *dy.stride()[:3])
    ptrs = (y.data_ptr(), xh.data_ptr(), z.data_ptr(), scale.data_ptr(), g.data_ptr(),
            dy.data_ptr(), dxh.data_ptr(), dz.data_ptr())
    pa = 0
    for v in ptrs:
        pa |= v
    for v in strides:
        pa |= v * es
    vector = p * es % 16 == 0 and pa % 16 == 0
    mode = _mode(vector, dtype, dev, gated=True)
    tpr, nu, blocks = _bwd_grid(b * s, d, vector, es, True, mode, dev)
    part = torch.empty((blocks, d), dtype=_F32, device=z.device)
    part_d = torch.empty((blocks, h), dtype=_F32, device=z.device)     # dD's, one a head
    err = _lib().rms_norm_bwd(mode, None, ptrs[0], ptrs[1], ptrs[2], D.data_ptr(), ptrs[3],
                              ptrs[4], rstd.data_ptr(), None, ptrs[5], ptrs[6], ptrs[7],
                              dD.data_ptr(), dscale.data_ptr(), part.data_ptr(),
                              part_d.data_ptr(), b * s, d, 0, s, p, _strides(*strides), tpr, nu,
                              blocks, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _raise(name, err)
    return "vector" if vector else "scalar", (dy, dxh, dD, dz, dscale)


def gated_rms_norm_bwd(g: torch.Tensor, y: torch.Tensor, xh: torch.Tensor, D: torch.Tensor,
                       z: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor):
    """(dy at y's strides, dxh and dz contiguous, dD f32, dscale) of
    :func:`gated_rms_norm_bwd_plain`: on the card one launch of the one-pass
    adjoint kernel and its sum pass (y, xh, z and scale of one dtype, laid
    out as the forward takes them; g (B, S, H·P) contiguous of that dtype;
    rstd the forward's); on the CPU the plain version."""
    if not z.is_cuda:
        return gated_rms_norm_bwd_plain(g, y, xh, D, z, scale, rstd)
    route, grads = _gated_bwd("gated_rms_norm_bwd", g, y, xh, D, z, scale, rstd)
    _count(gated_rms_norm_bwd, route)
    return grads


gated_rms_norm_bwd.launches = 0
gated_rms_norm_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


class RmsNormFn(torch.autograd.Function):
    """:func:`rms_norm_fwd` (keeping rstd) with :func:`rms_norm_bwd` as the
    backward: x's and scale's gradients. On the CPU both take their plain
    versions."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out, rstd = rms_norm_fwd(x, scale, eps, keep_rstd=True)
        ctx.save_for_backward(x, scale, rstd)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(g.to(x.dtype).contiguous(), x, scale, rstd)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)


class GatedRmsNormFn(torch.autograd.Function):
    """:func:`gated_rms_norm_fwd` (keeping rstd) with
    :func:`gated_rms_norm_bwd` as the backward: the gradients of y, xh, D, z
    and scale (dy in y's layout). On the CPU both take their plain
    versions."""

    @staticmethod
    def forward(ctx, y, xh, D, z, scale, eps):
        out, rstd = gated_rms_norm_fwd(y, xh, D, z, scale, eps, keep_rstd=True)
        ctx.save_for_backward(y, xh, D, z, scale, rstd)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y, xh, D, z, scale, rstd = ctx.saved_tensors
        grads = gated_rms_norm_bwd(g.to(z.dtype).contiguous(), y, xh, D, z, scale, rstd)
        return (*(t if need else None for t, need in zip(grads, ctx.needs_input_grad)), None)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points' argument and result types on a built
    ``csrc/rms_norm.cu`` (or a variant of it, as the probes build)."""
    lib.rms_norm_fwd.argtypes = _FWD_ARGTYPES
    lib.rms_norm_fwd.restype = ctypes.c_int
    lib.rms_norm_bwd.argtypes = _BWD_ARGTYPES
    lib.rms_norm_bwd.restype = ctypes.c_int
    lib.rms_norm_bwd_residency.argtypes = [_I, _I, _I, _LL]
    lib.rms_norm_bwd_residency.restype = ctypes.c_int
    lib.rms_norm_bwd_attributes.argtypes = [_I, _I, _IP, _IP]
    lib.rms_norm_bwd_attributes.restype = ctypes.c_int
    lib.rms_norm_error_string.argtypes = [ctypes.c_int]
    lib.rms_norm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(load_library("rms_norm"))
