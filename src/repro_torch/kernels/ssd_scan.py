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

Layouts: the model's x (B, S, H, P), dt (B, S, H) f32 post-softplus, A
(B·H,) f32 negative (row ``b·H + h``), B and C (B, S, G, N), head h reading
group ``h // heads_per_group``, an optional ``initial_state`` (B, H, N, P)
f32; returns y (B, S, H, P) in x's dtype, a view of a contiguous (B, H, S,
P) (the layout the gated norm reads in place), and the final state (B, H,
N, P) f32. Or the flattened x (BH, S, P), dt (BH, S), A (BH,), B and C
(BH / heads_per_group, S, N), row ``i`` of x reading group row ``i //
heads_per_group`` (with ``heads_per_group=1`` the TPU kernel's per-head
interface), contiguous; returns y (BH, S, P) and the final state (BH, N,
P), with an optional ``initial_state`` (BH, N, P). The ``sm90`` kernels
read the model's layout in place at any strides a tensor map takes
(:mod:`.layout`; dt element by element at its strides) and write the
gradients at the strides of the tensors the wrapper allocates; the
``simt`` kernels and the plain versions take the flattened layout, and the
wrapper copies a (B, S, H, P) call to it and back (``layout_copies``
counts those tensors by route). ``S`` must be a multiple of ``chunk``. The
``sm90`` kernel rounds W, the state that C·state reads and the decayed X to
bf16 before their products; the plain version keeps them in f32.

A CPU tensor goes to :func:`ssd_scan_plain`; a CUDA tensor goes to a kernel
or raises. ``ssd_scan.launches`` counts kernel launches and
``ssd_scan.launches_by_route`` splits them by route, under a lock.

The gradient: :func:`ssd_scan_bwd`, the hand-written gradient of the scan
that replaces XLA's autodiff of the reference's ``ssd_chunked``, takes the
forward's routes (:func:`_route`): bf16 of a shape the ``sm90`` forward
takes → ``csrc/ssd_scan_bwd_sm90.cu`` (every product on ``wgmma``, tiles by
TMA, the chunks in parallel with the states carried by a separate pass, a
group's dG summed before its products); f32 and every other bf16 shape →
``csrc/ssd_scan_bwd.cu`` (``simt``: CUDA cores, f32 sums).
:func:`_ssd_scan_bwd_simt` reaches the ``simt`` backward at bf16, for timing
only. :func:`ssd_scan_bwd_plain` is the arithmetic in PyTorch.
:class:`SsdScanFn` puts the forward and the backward together for
autograd.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional, Tuple

import torch

from .build import load_library
from .layout import bshw_as_rows, count_copies, kernel_strides, rows_as_bshw, rows_to_bshw

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
    time, every row at once. A (B, S, H, P) call runs on its flattened
    copies and returns the kernels' layouts."""
    if x.dim() == 4:
        b, h = x.shape[0], x.shape[2]
        init = None if initial_state is None else initial_state.flatten(0, 1)
        y, state = ssd_scan_plain(bshw_as_rows(x), bshw_as_rows(dt), A, bshw_as_rows(Bm),
                                  bshw_as_rows(Cm), chunk=chunk, heads_per_group=heads_per_group,
                                  initial_state=init)
        return rows_as_bshw(y, h), state.unflatten(0, (b, h))
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


def ssd_scan_bwd_plain(
    x: torch.Tensor,                     # (BH, S, P)
    dt: torch.Tensor,                    # (BH, S)
    A: torch.Tensor,                     # (BH,)
    Bm: torch.Tensor,                    # (BH / heads_per_group, S, N)
    Cm: torch.Tensor,
    dy: torch.Tensor,                    # (BH, S, P), y's gradient
    dfinal: Optional[torch.Tensor] = None,   # (BH, N, P) f32, the final state's
    *,
    chunk: int = 128,
    heads_per_group: int = 1,
    initial_state: Optional[torch.Tensor] = None,
):
    """(dx, ddt, dA, dB, dC, d initial_state) of :func:`ssd_scan_plain`,
    written out by hand (no autograd): f32 throughout, every row at once.

    A forward pass recomputes the state entering each chunk; the reverse pass
    carries dS (N, P) from the last chunk to the first. Per chunk, with
    ``cum`` the within-chunk cumulative sum of dt·A (:func:`_cum`), ``T`` its last entry,
    ``L[i, j] = exp(cum_i - cum_j)`` for j ≤ i (selected to 0 above the
    diagonal, where it overflows), ``G = C Bᵀ``, ``W = G ∘ L ∘ dt_j`` and
    ``u = exp(T - cum) ∘ dt``::

        dX     = Wᵀ dY + diag(u) B dS_out
        dG     = (dY Xᵀ) ∘ L ∘ dt_j                 → dC += dG B, dB += dGᵀ C
        dC    += diag(exp(cum)) dY s_inᵀ
        dB    += diag(u) X dS_outᵀ
        dS_in  = exp(T) dS_out + Cᵀ diag(exp(cum)) dY

    and the gradient of ``cum`` (from L, exp(cum), u and exp(T)) folds back
    into ddt and dA through the within-chunk reverse cumulative sum. dx is in
    x's dtype, dB and dC in B's (summed over the ``heads_per_group`` rows
    that read each group row), ddt, dA and the initial state's gradient f32;
    the last is None when ``initial_state`` is. A (B, S, H, P) call runs on
    its flattened copies and returns contiguous gradients in its layouts."""
    if x.dim() == 4:
        b, h, grp = x.shape[0], x.shape[2], Bm.shape[2]
        flat = [None if t is None else t.flatten(0, 1) for t in (dfinal, initial_state)]
        dx, ddt, da, db, dc, dinit = ssd_scan_bwd_plain(
            *(bshw_as_rows(t) for t in (x, dt)), A, *(bshw_as_rows(t) for t in (Bm, Cm)),
            bshw_as_rows(dy), flat[0], chunk=chunk, heads_per_group=heads_per_group,
            initial_state=flat[1])
        return (rows_to_bshw(dx, h), rows_as_bshw(ddt, h), da, rows_to_bshw(db, grp),
                rows_to_bshw(dc, grp), None if dinit is None else dinit.unflatten(0, (b, h)))
    bh, s, p = x.shape
    n = Bm.shape[-1]
    g = heads_per_group
    bm = torch.repeat_interleave(Bm, g, dim=0).float()
    cm = torch.repeat_interleave(Cm, g, dim=0).float()
    a = A.float()[:, None]
    dev = x.device
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    state = (torch.zeros((bh, n, p), dtype=torch.float32, device=dev)
             if initial_state is None else initial_state.float())
    states = []                          # the state entering each chunk
    for t0 in range(0, s, chunk):
        states.append(state)
        dtq = dt[:, t0:t0 + chunk].float()
        cum = _cum(dtq * a)
        u = torch.exp(cum[:, -1:] - cum) * dtq
        xw = x[:, t0:t0 + chunk].float() * u[:, :, None]
        state = (torch.bmm(bm[:, t0:t0 + chunk].transpose(1, 2), xw)
                 + torch.exp(cum[:, -1:])[:, :, None] * state)
    ds = (torch.zeros((bh, n, p), dtype=torch.float32, device=dev)
          if dfinal is None else dfinal.float())
    dx = torch.empty((bh, s, p), dtype=torch.float32, device=dev)
    ddt = torch.empty((bh, s), dtype=torch.float32, device=dev)
    db = torch.empty((bh, s, n), dtype=torch.float32, device=dev)
    dc = torch.empty((bh, s, n), dtype=torch.float32, device=dev)
    da = torch.zeros((bh,), dtype=torch.float64, device=dev)
    for ci in reversed(range(s // chunk)):
        t0 = ci * chunk
        sl = slice(t0, t0 + chunk)
        xq, dyq, dtq = x[:, sl].float(), dy[:, sl].float(), dt[:, sl].float()
        bq, cq, s_in = bm[:, sl], cm[:, sl], states[ci]
        cum = _cum(dtq * a)                                    # (BH, Q)
        total = cum[:, -1:]
        ecum = torch.exp(cum)
        decay = torch.exp(total - cum)
        u = decay * dtq
        # select, never multiply: exp overflows to inf where j > i
        diff = torch.where(tri, cum[:, :, None] - cum[:, None, :], 0.0)
        L = torch.where(tri, torch.exp(diff), 0.0)
        GL = torch.bmm(cq, bq.transpose(1, 2)) * L             # (BH, Q, Q)
        W = GL * dtq[:, None, :]
        dW = torch.bmm(dyq, xq.transpose(1, 2))
        dG = dW * L * dtq[:, None, :]
        R = dW * W                                             # dL ∘ L
        M = torch.bmm(xq, ds.transpose(1, 2))                  # (BH, Q, N) = X dSᵀ
        dc_inter = ecum[:, :, None] * torch.bmm(dyq, s_in.transpose(1, 2))
        dx[:, sl] = torch.bmm(W.transpose(1, 2), dyq) + u[:, :, None] * torch.bmm(bq, ds)
        dc[:, sl] = torch.bmm(dG, bq) + dc_inter
        db[:, sl] = torch.bmm(dG.transpose(1, 2), cq) + u[:, :, None] * M
        v = (bq * M).sum(-1)                                   # u's gradient
        dcum = R.sum(2) - R.sum(1) + (cq * dc_inter).sum(-1) - u * v
        dcum[:, -1] += (u * v).sum(-1) + torch.exp(total[:, 0]) * (ds * s_in).sum((1, 2))
        # the reverse cumulative sum and dA in f64, as the kernel: the terms cancel
        rc = torch.flip(torch.cumsum(torch.flip(dcum.double(), (1,)), dim=1), (1,))
        ddt[:, sl] = (dW * GL).sum(1) + decay * v + a * rc.float()
        da += (dtq.double() * rc).sum(-1)
        ds = (torch.exp(total)[:, :, None] * ds
              + torch.bmm(cq.transpose(1, 2), ecum[:, :, None] * dyq))
    bg = bh // g
    return (dx.to(x.dtype), ddt, da.float(), db.view(bg, g, s, n).sum(1).to(Bm.dtype),
            dc.view(bg, g, s, n).sum(1).to(Cm.dtype),
            None if initial_state is None else ds)


def _cum(v: torch.Tensor) -> torch.Tensor:
    """The within-chunk cumulative sum of dt·A as the backward kernel forms
    it: summed in f64 and rounded once to f32, so that the order of the sum
    (sequential in the kernel, a parallel scan on the card here) does not
    show at f32. At |cum| of a few thousand (A to -16 over 128 steps) an f32
    sum's order alone moves ddt by ~1e-4 of its largest entry."""
    return torch.cumsum(v.double(), dim=-1).float()


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
    if x.dim() not in (3, 4) or Bm.dim() != x.dim() or Bm.shape != Cm.shape:
        raise ValueError(f"want x (BH,S,P), B = C (BG,S,N), or x (B,S,H,P), B = C "
                         f"(B,S,G,N); got {tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    n = Bm.shape[-1]
    if x.dim() == 3:
        bh, s, p = x.shape
        match = g >= 1 and bh == Bm.shape[0] * g and Bm.shape[1] == s
        want_dt, want_state = (bh, s), (bh, n, p)
    else:
        b, s, h, p = x.shape
        bh = b * h
        match = (g >= 1 and Bm.shape[0] == b and h == Bm.shape[2] * g and Bm.shape[1] == s)
        want_dt, want_state = (b, s, h), (b, h, n, p)
    if not match:
        raise ValueError(f"x {tuple(x.shape)} does not match B {tuple(Bm.shape)} "
                         f"with heads_per_group={g}")
    if tuple(dt.shape) != want_dt or tuple(A.shape) != (bh,):
        raise ValueError(f"want dt {want_dt} and A ({bh},); got {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    if initial_state is not None and (tuple(initial_state.shape) != want_state
                                      or initial_state.dtype != torch.float32):
        raise ValueError(f"initial_state must be float32 {want_state}; got "
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
    """Returns (y, final_state f32) in the layout of the call: (B, S, H, P)
    and (B, H, N, P), or (BH, S, P) and (BH, N, P).

    A tensor on the CPU or the card goes to :func:`_direct`; a meta tensor
    (the dry run, on each device's shards) to the custom op
    ``repro_torch::ssd_scan``, whose fake kernel gives the outputs' shapes
    and whose FLOP formula the dry run counts."""
    g = heads_per_group
    _check(x, dt, A, Bm, Cm, chunk, g, initial_state)
    if x.device.type != "meta":
        return _direct(x, dt, A, Bm, Cm, chunk, g, initial_state)
    return torch.ops.repro_torch.ssd_scan(x, dt, A, Bm, Cm, chunk, g, initial_state)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk: int, g: int,
                 initial_state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 as a custom op, for the meta device: :func:`_ssd_scan_fake` there;
    elsewhere :func:`_direct`, which :func:`ssd_scan` calls itself without
    the dispatcher."""
    return _direct(x, dt, A, Bm, Cm, chunk, g, initial_state)


def _direct(x, dt, A, Bm, Cm, chunk, g, initial_state):
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, heads_per_group=g,
                              initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    route = _route(x.dtype, x.shape[-1], Bm.shape[-1], chunk)
    return _launch(route, x, dt, A, Bm, Cm, chunk, g, initial_state)


@_ssd_scan_op.register_fake
def _ssd_scan_fake(x, dt, A, Bm, Cm, chunk, g, initial_state):
    if x.dim() == 3:
        bh, _, p = x.shape
        return x.new_empty(x.shape), x.new_empty((bh, Bm.shape[2], p), dtype=torch.float32)
    b, s, h, p = x.shape
    return (x.new_empty((b, h, s, p)).transpose(1, 2),
            x.new_empty((b, h, Bm.shape[3], p), dtype=torch.float32))


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


def _check_contiguous(**tensors: Optional[torch.Tensor]) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bh(x: torch.Tensor, g: int) -> Tuple[int, int]:
    """(B, H) of x in either layout: a flattened (BH, S, P) call is the
    (BH / g, S, g, P) layout, one group a batch."""
    return (x.shape[0], x.shape[2]) if x.dim() == 4 else (x.shape[0] // g, g)


def _launch(route: str, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, chunk: int, g: int,
            initial_state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Checks what the kernel of ``route`` takes, then launches it on x's
    stream. The ``sm90`` kernel reads a (B, S, H, P) call at its strides; a
    flattened call must be contiguous. The ``simt`` kernel takes the
    flattened layout only: a (B, S, H, P) call is copied to it (y and the
    state come back as views)."""
    p, n = x.shape[-1], Bm.shape[-1]
    if route == "sm90":
        if x.dtype != torch.bfloat16 or _route(x.dtype, p, n, chunk) != "sm90":
            raise ValueError(f"the sm90 kernel takes bf16 with N and P multiples of 8 and "
                             f"P up to {SM90_MAX_WIDTH}; got {x.dtype}, N {n}, P {p}")
    elif chunk > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"chunk {chunk} and state size {n} must be at most "
                         f"{MAX_CHUNK} and {MAX_STATE}")
    four = x.dim() == 4
    if route == "simt" and four:
        b, h = x.shape[0], x.shape[2]
        init = None if initial_state is None else initial_state.flatten(0, 1)
        ins = (x, dt, Bm, Cm)
        rows = [bshw_as_rows(t) for t in ins]
        y, state = _launch(route, rows[0], rows[1], A, rows[2], rows[3], chunk, g, init)
        count_copies(ssd_scan, route, zip(rows, ins))
        return rows_as_bshw(y, h), state.unflatten(0, (b, h))
    if four:
        _check_contiguous(A=A, initial_state=initial_state)
    else:
        _check_contiguous(x=x, dt=dt, A=A, B=Bm, C=Cm, initial_state=initial_state)
    (b, h), s = _bh(x, g), x.shape[1]
    if route == "sm90":                  # TMA reads x, B and C; raises before any load
        strides = kernel_strides((("x", x, g, True), ("B", Bm, 1, True), ("C", Cm, 1, True),
                                  ("dt", dt, g, False)))
    y = x.new_empty((b * h, s, p))
    state = torch.empty((b * h, n, p), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), state.data_ptr())
    tail = (s, p, n, chunk, g, torch.cuda.current_stream(x.device).cuda_stream)
    if route == "sm90":
        lib = _lib_sm90()
        err = lib.ssd_scan_sm90_fwd(*args, strides, b, h, *tail)
        error_string = lib.ssd_scan_sm90_error_string
    else:
        lib = _lib()
        err = lib.ssd_scan_fwd(*args, _DTYPE_CODE[x.dtype], b * h, *tail)
        error_string = lib.ssd_scan_error_string
    if err != 0:
        raise RuntimeError(f"ssd_scan {route} kernel launch failed: "
                           f"{error_string(err).decode()} ({err})")
    _count_launch(route)
    if four:
        return y.view(b, h, s, p).transpose(1, 2), state.view(b, h, n, p)
    return y, state


ssd_scan.launches = 0
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
ssd_scan.layout_copies = dict.fromkeys(ROUTES, 0)


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
    lib.ssd_scan_sm90_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                                      + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.ssd_scan_sm90_fwd.restype = ctypes.c_int
    lib.ssd_scan_sm90_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_sm90_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def ssd_scan_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    dy: torch.Tensor,
    dfinal: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    heads_per_group: int = 1,
    initial_state: Optional[torch.Tensor] = None,
):
    """(dx, ddt, dA, dB, dC, d initial_state) of :func:`ssd_scan` from its
    inputs, y's gradient ``dy`` and the final state's ``dfinal`` (None: zero).

    A CPU tensor goes to :func:`ssd_scan_bwd_plain`; a CUDA tensor launches
    the backward of :func:`_route`'s route (``sm90``:
    ``csrc/ssd_scan_bwd_sm90.cu``; ``simt``: ``csrc/ssd_scan_bwd.cu``) or
    raises; a meta tensor goes to the custom op ``repro_torch::ssd_scan_bwd``.
    ``ssd_scan_bwd.launches`` and ``.launches_by_route`` count calls that
    launched (each route's kernels of one call count as one launch), under
    the forward's lock."""
    g = heads_per_group
    _check_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state)
    if x.device.type != "meta":
        return _direct_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state)
    grads = torch.ops.repro_torch.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk, g,
                                               initial_state)
    return (*grads[:5], grads[5] if len(grads) == 6 else None)


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _ssd_scan_bwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                     Cm: torch.Tensor, dy: torch.Tensor, dfinal: Optional[torch.Tensor],
                     chunk: int, g: int, initial_state: Optional[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """K3's backward as a custom op, for the meta device, as :func:`_ssd_scan_op`:
    the gradients as a list, the initial state's last where there is one."""
    return [t for t in _direct_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state)
            if t is not None]


def _direct_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state):
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk, heads_per_group=g,
                                  initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    route = _route(x.dtype, x.shape[-1], Bm.shape[-1], chunk)
    return _launch_bwd(route, x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state)


@_ssd_scan_bwd_op.register_fake
def _ssd_scan_bwd_fake(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state):
    return [t.new_empty(t.shape) for t in (x, dt, A, Bm, Cm, initial_state) if t is not None]


def _ssd_scan_bwd_simt(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    dy: torch.Tensor,
    dfinal: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    heads_per_group: int = 1,
    initial_state: Optional[torch.Tensor] = None,
):
    """The CUDA-core backward at either dtype, bf16 included; for timing only."""
    _check_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk, heads_per_group, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"the simt kernel needs a CUDA tensor, got {x.device}")
    return _launch_bwd("simt", x, dt, A, Bm, Cm, dy, dfinal, chunk, heads_per_group,
                       initial_state)


def _check_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk: int, g: int, initial_state) -> None:
    _check(x, dt, A, Bm, Cm, chunk, g, initial_state)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x {tuple(x.shape)} {x.dtype}; got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    want = ((x.shape[0], Bm.shape[2], x.shape[2]) if x.dim() == 3
            else (x.shape[0], x.shape[2], Bm.shape[3], x.shape[3]))
    if dfinal is not None and (tuple(dfinal.shape) != want or dfinal.dtype != torch.float32
                               or dfinal.device != x.device):
        raise ValueError(f"dfinal must be float32 {want} on {x.device}; got {dfinal.dtype} "
                         f"{tuple(dfinal.shape)} on {dfinal.device}")


def bwd_heads_per_block(g: int) -> int:
    """Heads of one group that a block of the ``sm90`` backward takes: the
    largest of 8, 4, 2, 1 that divides the group. C·Bᵀ is formed once for
    them and their dG summed before its two products; dB and dC leave one
    f32 partial per such block."""
    return next(hb for hb in (8, 4, 2, 1) if g % hb == 0)


def _launch_bwd(route: str, x, dt, A, Bm, Cm, dy, dfinal, chunk: int, g: int, initial_state):
    """Checks what the backward kernel of ``route`` takes, then launches its
    kernels on x's stream. As :func:`_launch`: the ``sm90`` kernels read a
    (B, S, H, P) call (dy included) at its strides and write contiguous
    gradients in its layouts; the ``simt`` kernels take the flattened
    layout, copied to and back."""
    p, n = x.shape[-1], Bm.shape[-1]
    if route == "sm90":
        if x.dtype != torch.bfloat16 or _route(x.dtype, p, n, chunk) != "sm90":
            raise ValueError(f"the sm90 kernel takes bf16 with N and P multiples of 8 and "
                             f"P up to {SM90_MAX_WIDTH}; got {x.dtype}, N {n}, P {p}")
    else:
        _route(x.dtype, p, n, chunk)     # chunk and N in range, the dtype known
    four = x.dim() == 4
    if route == "simt" and four:
        b, h, grp = x.shape[0], x.shape[2], Bm.shape[2]
        flat = [None if t is None else t.flatten(0, 1) for t in (dfinal, initial_state)]
        ins = (x, dt, Bm, Cm, dy)
        rows = [bshw_as_rows(t) for t in ins]
        dx, ddt, dA, dB, dC, dinit = _launch_bwd(route, rows[0], rows[1], A, *rows[2:],
                                                 flat[0], chunk, g, flat[1])
        outs = [rows_to_bshw(t, n) for t, n in ((dx, h), (dB, grp), (dC, grp))]
        count_copies(ssd_scan_bwd, route, [*zip(rows, ins), *zip(outs, (dx, dB, dC))])
        return (outs[0], rows_as_bshw(ddt, h), dA, outs[1], outs[2],
                None if dinit is None else dinit.unflatten(0, (b, h)))
    if four:
        _check_contiguous(A=A, dfinal=dfinal, initial_state=initial_state)
    else:
        _check_contiguous(x=x, dt=dt, A=A, B=Bm, C=Cm, dy=dy, dfinal=dfinal,
                          initial_state=initial_state)
    dx, dB, dC = (t.new_empty(t.shape) for t in (x, Bm, Cm))
    # ddt (B, S, H) over (B, H, S) memory, the layout autograd gave it from
    # the flattened (B·H, S) one: softplus's adjoint and dt_bias's sum after
    # it then see the strides they saw before, and sum in the same order
    ddt = (dt.new_empty((x.shape[0], x.shape[2], x.shape[1])).transpose(1, 2) if four
           else dt.new_empty(dt.shape))
    dA = torch.empty_like(A)
    dinit = None if initial_state is None else torch.empty_like(initial_state)
    if route == "sm90":
        strides = kernel_strides((
            ("x", x, g, True), ("dy", dy, g, True), ("B", Bm, 1, True), ("C", Cm, 1, True),
            ("dt", dt, g, False), ("dx", dx, g, True), ("ddt", ddt, g, False),
            ("dB", dB, 1, True), ("dC", dC, 1, True)))
        b, h = _bh(x, g)
        _launch_bwd_sm90(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state,
                         dx, ddt, dA, dB, dC, dinit, strides, b, h)
    else:
        _launch_bwd_simt(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state,
                         dx, ddt, dA, dB, dC, dinit)
    with _LAUNCH_LOCK:
        ssd_scan_bwd.launches += 1
        ssd_scan_bwd.launches_by_route[route] += 1
    return dx, ddt, dA, dB, dC, dinit


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_bwd_simt(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state,
                     dx, ddt, dA, dB, dC, dinit) -> None:
    bh, s, p = x.shape
    n = Bm.shape[-1]
    dev = x.device
    lib = _lib_bwd()
    p_tile = lib.ssd_scan_bwd_p_tile()
    tiles = -(-p // p_tile)
    # f32 scratch: the state entering each chunk, then per (row, P-tile)
    # partials of dB, dC, ddt and dA that the second pass sums in a fixed order
    states = torch.empty((bh, tiles, s // chunk, n, p_tile), dtype=torch.float32, device=dev)
    part_bc = torch.empty((2, bh, tiles, s, n), dtype=torch.float32, device=dev)
    part_dt = torch.empty((bh, tiles, s + 1), dtype=torch.float32, device=dev)
    err = lib.ssd_scan_bwd(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm), _ptr(initial_state), _ptr(dy),
        _ptr(dfinal), _ptr(dx), _ptr(ddt), _ptr(dA), _ptr(dB), _ptr(dC), _ptr(dinit),
        _ptr(states), _ptr(part_bc), _ptr(part_dt), _DTYPE_CODE[x.dtype], bh, s, p, n, chunk, g,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd simt kernel launch failed: "
                           f"{lib.ssd_scan_bwd_error_string(err).decode()} ({err})")


def _launch_bwd_sm90(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state,
                     dx, ddt, dA, dB, dC, dinit, strides, b: int, h: int) -> None:
    bh, s, p = b * h, x.shape[1], x.shape[-1]
    n = Bm.shape[-1]
    nc = s // chunk
    hb = bwd_heads_per_block(g)
    dev = x.device
    lib = _lib_bwd_sm90()
    # scratch: each chunk's B^T diag(u) X, which the state pass turns into the
    # state entering the chunk in place, and C^T diag(exp(cum)) dY (f32); the
    # entering state and dS leaving each chunk in bf16 for the products;
    # exp(total) per (row, chunk); the partial sums of dS ∘ state per state
    # block; dB and dC per block of hb heads; dA per (row, chunk) in f64
    f32 = torch.float32
    states = torch.empty((2, bh, nc, n, p), dtype=f32, device=dev)
    states16 = torch.empty((2, bh, nc, n, p), dtype=torch.bfloat16, device=dev)
    decay = torch.empty((bh, nc), dtype=f32, device=dev)
    ts_part = torch.empty((bh, lib.ssd_scan_bwd_sm90_state_blocks(n, p), nc), dtype=f32,
                          device=dev)
    part_bc = torch.empty((2, bh // hb, s, n), dtype=f32, device=dev)
    part_da = torch.empty((bh, nc), dtype=torch.float64, device=dev)
    err = lib.ssd_scan_bwd_sm90(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm), _ptr(initial_state), _ptr(dy),
        _ptr(dfinal), _ptr(dx), _ptr(ddt), _ptr(dA), _ptr(dB), _ptr(dC), _ptr(dinit),
        _ptr(states), _ptr(states16), _ptr(decay), _ptr(ts_part), _ptr(part_bc),
        _ptr(part_da), strides, b, h, s, p, n, chunk, g, hb,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd sm90 kernel launch failed: "
                           f"{lib.ssd_scan_bwd_sm90_error_string(err).decode()} ({err})")


ssd_scan_bwd.launches = 0
ssd_scan_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
ssd_scan_bwd.layout_copies = dict.fromkeys(ROUTES, 0)


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    lib = load_library("ssd_scan_bwd")
    lib.ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_bwd_p_tile.argtypes = []
    lib.ssd_scan_bwd_p_tile.restype = ctypes.c_int
    lib.ssd_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd_sm90() -> ctypes.CDLL:
    lib = load_library("ssd_scan_bwd_sm90")
    lib.ssd_scan_bwd_sm90.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.POINTER(ctypes.c_longlong)]
                                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.ssd_scan_bwd_sm90.restype = ctypes.c_int
    lib.ssd_scan_bwd_sm90_state_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ssd_scan_bwd_sm90_state_blocks.restype = ctypes.c_int
    lib.ssd_scan_bwd_sm90_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_bwd_sm90_error_string.restype = ctypes.c_char_p
    return lib


class SsdScanFn(torch.autograd.Function):
    """:func:`ssd_scan` for autograd: the forward is K3 on its route, the
    backward :func:`ssd_scan_bwd`, which saves nothing but the inputs and
    recomputes the states. Gradients are not materialised, so an unused
    final state costs nothing. On the CPU both directions take their plain
    versions inside this same Function. In the model's (B, S, H, P) layout dy
    is read as it comes (y's layout) and the gradients leave contiguous in
    that layout; the flattened layout keeps its contiguous dy."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int, heads_per_group: int,
                initial_state: Optional[torch.Tensor]):
        y, state = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, heads_per_group=heads_per_group,
                            initial_state=initial_state)
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.opts = dict(chunk=chunk, heads_per_group=heads_per_group)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, initial_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        elif dy.dim() == 3:
            dy = dy.contiguous()
        dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd(
            x, dt, A, Bm, Cm, dy, None if dstate is None else dstate.contiguous(),
            initial_state=initial_state, **ctx.opts)
        return dx, ddt, dA, dB, dC, None, None, dinit


# ---------------------------------------------------------------------------
# what the dry run reads: the work of a call
# ---------------------------------------------------------------------------

def register_flop_formulas() -> None:
    """K3's FLOP formulas for ``torch.utils.flop_counter``. Forward, per
    head and chunk of L steps: C·Bᵀ (2·L²·N), its masked product with X
    (2·L²·P), C·state and the state's update (2·L·N·P each); backward:
    :func:`bwd_flops_per_chunk`."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    if torch.ops.repro_torch.ssd_scan in flop_registry:
        return

    @register_flop_formula(torch.ops.repro_torch.ssd_scan)
    def _flops(x, dt, A, Bm, Cm, chunk, g, initial_state, *args, **kwargs) -> int:
        bh, s, p = _rows_seq_width(x)
        n = Bm[-1]
        return bh * (s // chunk) * (2 * chunk * chunk * (n + p) + 4 * chunk * n * p)

    @register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
    def _bwd_flops(x, dt, A, Bm, Cm, dy, dfinal, chunk, g, initial_state, *args,
                   **kwargs) -> int:
        bh, s, p = _rows_seq_width(x)
        n = Bm[-1]
        return bh * (s // chunk) * bwd_flops_per_chunk(chunk, n, p)


def _rows_seq_width(x_shape) -> Tuple[int, int, int]:
    """(B·H, S, P) of x's shape in either layout."""
    if len(x_shape) == 3:
        return tuple(x_shape)
    b, s, h, p = x_shape
    return b * h, s, p


def bwd_flops_per_chunk(q: int, n: int, p: int) -> int:
    """The backward's products per row and chunk of q steps: C·Bᵀ again,
    dY·Xᵀ, Wᵀ·dY, dG·B and dGᵀ·C (2·q²·(3N + 2P)); the recomputed state
    update, B·dS, X·dSᵀ, dY·s_inᵀ and the carried Cᵀ·dY (2·q·N·P each)."""
    return 2 * q * q * (3 * n + 2 * p) + 10 * q * n * p


def bwd_least_work(bh: int, s: int, p: int, n: int, chunk: int, g: int, with_state: bool,
                   itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) that K3's backward needs at least: what its bound
    on the card is computed from (not :func:`bwd_flops_per_chunk`, the dry
    run's count, which takes every Q×Q product in full and once per head).

    Per row and chunk: dY·Xᵀ and Wᵀ·dY over the Q(Q+1)/2 pairs j ≤ i that the
    mask keeps, and five Q·N·P products (the chunk's state term Bᵀ·diag(u)·X,
    B·dS, X·dSᵀ, dY·s_inᵀ, Cᵀ·dY). Per group row and chunk, over the kept
    pairs: C·Bᵀ, and dG·B and dGᵀ·C on the dG summed over the group's heads,
    since those heads read the same B and C. Bytes: x, dy, dx and B, C, dB,
    dC (once per group) in ``itemsize``; dt, ddt, A and dA in f32; a given
    initial state, final-state gradient and initial-state gradient in f32."""
    kept = chunk * (chunk + 1) // 2
    flops = (s // chunk) * (bh * (2 * kept * 2 * p + 10 * chunk * n * p)
                            + (bh // g) * 3 * 2 * kept * n)
    nbytes = (itemsize * (3 * bh * s * p + 4 * (bh // g) * s * n) + 4 * 2 * (bh * s + bh)
              + 4 * bh * n * p * (3 if with_state else 0))
    return flops, nbytes
