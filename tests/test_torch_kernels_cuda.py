"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
Without a card every case skips.
"""
import threading

import numpy as np
import pytest
import torch
from _quant_inputs import quant_input

from repro_torch.kernels import flash_attention_plain, ssd_scan_plain
from repro_torch.kernels.flash_attention import (ROUTES, _flash_attention_simt, _route,
                                                 flash_attention)
from repro_torch.kernels.int8_quant import ROUTES as QUANT_ROUTES
from repro_torch.kernels.int8_quant import _route as _quant_route
from repro_torch.kernels.int8_quant import quantize_int8, quantize_int8_plain
from repro_torch.kernels.ssd_scan import ROUTES as SSD_ROUTES
from repro_torch.kernels.ssd_scan import _route as _ssd_route
from repro_torch.kernels.ssd_scan import _ssd_scan_simt, ssd_scan

# (bh, sq, sk, hd, g): the shapes of tests/test_kernels.py
SHAPES = [
    (2, 128, 128, 64, 1),
    (4, 256, 256, 128, 2),
    (2, 100, 100, 64, 1),
    (3, 64, 192, 32, 3),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CASES = [(dt, s, s[1] == s[2], None, 0) for dt in DTYPES for s in SHAPES] + [
    ("float32", (2, 256, 256, 64, 1), True, 64, 0),      # sliding window
    ("bfloat16", (2, 256, 256, 64, 1), True, 64, 0),
    ("float32", (1, 32, 128, 64, 1), True, None, 96),    # q_offset continuation
    ("float32", (2, 16, 40, 32, 1), True, None, -8),     # fully masked rows
    ("bfloat16", (4, 130, 300, 128, 4), False, 100, 170),  # window, no causal, ragged
    ("bfloat16", (4, 130, 300, 64, 4), False, 100, 170),
    ("bfloat16", (1, 32, 128, 64, 1), True, None, 96),    # the sm90 route's own edges
    ("bfloat16", (2, 16, 40, 64, 1), True, None, -8),
    ("bfloat16", (2, 16, 40, 128, 1), True, None, -8),
    ("bfloat16", (10, 384, 384, 128, 5), True, None, 0),  # GQA 5, several q and kv tiles
    # head_dim 112 (kimi-k2, GQA 8): a partial second 64-column panel
    ("bfloat16", (16, 256, 256, 112, 8), True, None, 0),
    ("float32", (16, 256, 256, 112, 8), True, None, 0),
    ("bfloat16", (8, 130, 300, 112, 8), False, 100, 170),
    ("bfloat16", (2, 16, 40, 112, 1), True, None, -8),
    ("float32", (8, 100, 100, 112, 8), True, 48, 0),
    # the shapes the served model families give K2 at batch 4 (1024-token prompts)
    ("bfloat16", (64, 1024, 1024, 128, 1), True, None, 0),     # olmoe-1b-7b
    ("bfloat16", (256, 1024, 1024, 112, 8), True, None, 0),    # kimi-k2, hd 112
    ("bfloat16", (64, 1500, 1500, 64, 1), False, None, 0),     # whisper's encoder
    ("bfloat16", (64, 1024, 1500, 64, 1), False, None, 0),     # whisper's cross-attention
    ("bfloat16", (128, 1024, 6404, 128, 4), False, None, 0),   # llama-3.2-vision's cross layers
]


def _tol(name):
    # bf16 output rounding; f32 differs only in summation order
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,causal,window,q_offset", CASES)
def test_flash_kernel_matches_plain(dtype, shape, causal, window, q_offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bh, sq, sk, hd, g = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to("cuda", DTYPES[dtype])
               for s in ((bh, sq, hd), (bh // g, sk, hd), (bh // g, sk, hd)))
    kw = dict(q_heads_per_kv=g, causal=causal, window=window, q_offset=q_offset)
    before = flash_attention.launches
    route = _route(DTYPES[dtype], hd)
    before_route = flash_attention.launches_by_route[route]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_route[route] == before_route + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.cuda
def test_flash_routes_are_counted_by_dtype():
    """bf16 launches count on the sm90 route, f32 launches on the simt route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "simt")):
        q = torch.randn(2, 64, 64, device="cuda").to(dtype)
        before = dict(flash_attention.launches_by_route)
        flash_attention(q, q, q)
        assert flash_attention.launches_by_route == {
            r: before[r] + (r == route) for r in ROUTES}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 256, 128, 2), (2, 100, 100, 64, 1),
                                   (16, 256, 256, 112, 8)])
def test_simt_kernel_at_bf16_matches_plain(shape):
    """The CUDA-core kernel still takes bf16 when asked directly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bh, sq, sk, hd, g = shape
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to("cuda", torch.bfloat16)
               for s in ((bh, sq, hd), (bh // g, sk, hd), (bh // g, sk, hd)))
    before = flash_attention.launches_by_route["simt"]
    got = _flash_attention_simt(q, k, v, q_heads_per_kv=g)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route["simt"] == before + 1
    want = flash_attention_plain(q, k, v, q_heads_per_kv=g)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **_tol("bfloat16"))


# (bh, s, p, n, chunk, heads_per_group, initial state): the shapes of
# tests/test_kernels.py, a chunk that is no power of two, the warm-up's
# chunk 16 at the serving widths, groups, a carried-in state, and for the
# sm90 route chunks 1 and 64 and a carried-in state at the serving widths
# (64 heads a group) and P 96 with N 24; then bf16 at P 100 with N 24,
# which the sm90 kernel cannot take and the simt kernel does by its route;
# last, jamba's serving shape (4 requests x 256 heads of one group)
SSD_SHAPES = [(2, 64, 32, 16, 16, 1, False), (4, 128, 64, 32, 32, 1, False),
              (2, 128, 64, 128, 64, 1, False)]
SSD_CASES = [(dt, s) for dt in DTYPES for s in SSD_SHAPES] + [
    ("float32", (2, 200, 64, 128, 100, 1, False)),
    ("bfloat16", (3, 100, 40, 24, 100, 1, False)),
    ("bfloat16", (8, 16, 64, 128, 16, 1, False)),
    ("float32", (8, 96, 64, 32, 32, 4, False)),
    ("bfloat16", (8, 96, 96, 16, 48, 4, False)),
    ("float32", (4, 64, 64, 128, 32, 2, True)),
    ("bfloat16", (2, 256, 64, 128, 128, 1, True)),
    ("bfloat16", (64, 32, 64, 128, 1, 64, False)),
    ("bfloat16", (64, 128, 64, 128, 64, 64, False)),
    ("bfloat16", (64, 256, 64, 128, 128, 64, True)),
    ("bfloat16", (4, 128, 96, 24, 64, 2, False)),
    ("bfloat16", (4, 128, 100, 24, 64, 2, False)),
    ("bfloat16", (1024, 1024, 64, 128, 128, 256, False)),   # jamba: 256 heads a group
]


def _ssd_tol(name):
    # the tolerances of tests/test_kernels.py's SSD cases
    return dict(rtol=3e-2, atol=3e-2) if name == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _ssd_inputs(dtype, shape, seed=0):
    bh, s, p, n, chunk, g, with_state = shape
    rng = np.random.default_rng(seed)

    def cuda(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    x = cuda(rng.standard_normal((bh, s, p)), DTYPES[dtype])
    dtv = cuda(np.log1p(np.exp(rng.standard_normal((bh, s)))))
    A = cuda(-np.exp(rng.standard_normal(bh) * 0.3))
    Bm = cuda(rng.standard_normal((bh // g, s, n)) * 0.3, DTYPES[dtype])
    Cm = cuda(rng.standard_normal((bh // g, s, n)) * 0.3, DTYPES[dtype])
    init = cuda(rng.standard_normal((bh, n, p))) if with_state else None
    return (x, dtv, A, Bm, Cm), dict(chunk=chunk, heads_per_group=g, initial_state=init)


def _assert_ssd_close(dtype, got, want):
    (y, st), (want_y, want_st) = got, want
    np.testing.assert_allclose(y.float().cpu().numpy(), want_y.float().cpu().numpy(),
                               **_ssd_tol(dtype))
    np.testing.assert_allclose(st.cpu().numpy(), want_st.cpu().numpy(), **_ssd_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", SSD_CASES)
def test_ssd_kernel_matches_plain(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bh, s, p, n, chunk, g, with_state = shape
    args, kw = _ssd_inputs(dtype, shape)
    before = ssd_scan.launches
    route = _ssd_route(DTYPES[dtype], p, n, chunk)
    before_route = ssd_scan.launches_by_route[route]
    y, st = ssd_scan(*args, **kw)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert ssd_scan.launches_by_route[route] == before_route + 1
    assert y.dtype == args[0].dtype and y.shape == args[0].shape and st.shape == (bh, n, p)
    _assert_ssd_close(dtype, (y, st), ssd_scan_plain(*args, **kw))


@pytest.mark.cuda
def test_ssd_routes_are_counted_by_dtype():
    """bf16 launches count on the sm90 route, f32 launches on the simt route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype, route in (("bfloat16", "sm90"), ("float32", "simt")):
        args, kw = _ssd_inputs(dtype, (2, 64, 32, 16, 16, 1, False))
        before = dict(ssd_scan.launches_by_route)
        ssd_scan(*args, **kw)
        assert ssd_scan.launches_by_route == {
            r: before[r] + (r == route) for r in SSD_ROUTES}


@pytest.mark.cuda
def test_ssd_simt_kernel_at_bf16_matches_plain():
    """The CUDA-core kernel still takes bf16 when asked directly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = _ssd_inputs("bfloat16", (8, 96, 96, 16, 48, 4, False), seed=1)
    before = ssd_scan.launches_by_route["simt"]
    got = _ssd_scan_simt(*args, **kw)
    torch.cuda.synchronize()
    assert ssd_scan.launches_by_route["simt"] == before + 1
    _assert_ssd_close("bfloat16", got, ssd_scan_plain(*args, **kw))


# (dtype, (rows, cols), values): chip_smoke.py's K1 shapes: the shapes of
# tests/test_kernels.py, a ragged shape (the simt route), rows of zeros and
# below the 1e-8 scale floor, exact .5 steps, rows with a NaN or an inf (a
# block per row and a warp per row, on each route), the runtime's boundary
# shape, rows of one whole stage (48 KB), and many rows, so that a tile holds
# several (a warp per row and a block per row)
QUANT_CASES = [("float32", s, "randn") for s in ((16, 64), (100, 128), (256, 32))] + [
    ("float32", (1000, 333), "randn"), ("bfloat16", (1000, 333), "randn"),
    ("float32", (64, 128), "zeros"), ("bfloat16", (64, 128), "zeros"),
    ("float32", (96, 4096), "ties"), ("bfloat16", (96, 4096), "ties"),
    ("float32", (64, 4096), "nonfinite"), ("bfloat16", (100, 333), "nonfinite"),
    ("bfloat16", (100, 336), "nonfinite"), ("bfloat16", (96, 4096), "nonfinite"),
    ("float32", (640, 5120), "randn"), ("bfloat16", (640, 5120), "randn"),
    ("float32", (8, 12288), "randn"), ("bfloat16", (8, 24576), "ties"),
    ("bfloat16", (20000, 512), "randn"), ("bfloat16", (8000, 2048), "randn"),
]
OUT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _assert_quant_equal(q, scale, want_q, want_scale):
    """scale equal bit for bit where finite and NaN or inf where the plain
    version's is; q equal on the rows whose scale is finite."""
    assert torch.equal(torch.isnan(scale), torch.isnan(want_scale))
    assert torch.equal(torch.isinf(scale), torch.isinf(want_scale))
    fin = torch.isfinite(scale)
    assert torch.equal(scale[fin].view(torch.int32), want_scale[fin].view(torch.int32))
    assert torch.equal(q[fin], want_q[fin])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,values", QUANT_CASES)
def test_quant_kernel_matches_plain(dtype, shape, values):
    """q equal and scale equal bit for bit: a max and one IEEE division."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(quant_input(shape, values)).to("cuda", DTYPES[dtype])
    route = _quant_route(x)
    before = (quantize_int8.launches, dict(quantize_int8.launches_by_route))
    q, scale = quantize_int8(x)
    torch.cuda.synchronize()
    assert quantize_int8.launches == before[0] + 1
    assert quantize_int8.launches_by_route == {r: before[1][r] + (r == route)
                                               for r in QUANT_ROUTES}
    assert q.dtype == torch.int8 and q.shape == x.shape and scale.shape == (shape[0],)
    _assert_quant_equal(q, scale, *quantize_int8_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", list(OUT_DTYPES))
@pytest.mark.parametrize("dtype,shape,values", QUANT_CASES)
def test_quant_kernel_out_matches_plain(dtype, shape, values, out_dtype):
    """With ``out``: q and scale as without it, and ``out`` equal bit for bit
    to the plain version's ``q * scale`` on the rows whose scale is finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(quant_input(shape, values)).to("cuda", DTYPES[dtype])
    out = torch.full(shape, 7.0, device="cuda", dtype=OUT_DTYPES[out_dtype])
    route = _quant_route(x, out)
    before = dict(quantize_int8.launches_by_route)
    q, scale = quantize_int8(x, out)
    torch.cuda.synchronize()
    assert quantize_int8.launches_by_route == {r: before[r] + (r == route) for r in QUANT_ROUTES}
    want_out = torch.empty_like(out)
    want_q, want_scale = quantize_int8_plain(x, want_out)
    _assert_quant_equal(q, scale, want_q, want_scale)
    fin = torch.isfinite(want_scale)
    assert torch.equal(out[fin].float().view(torch.int32), want_out[fin].float().view(torch.int32))


@pytest.mark.cuda
def test_quant_routes_at_the_boundary_and_off_it():
    """The runtime's boundary rows take sm90; a ragged row and an out that
    is not 16-byte aligned take simt, and are right there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(quant_input((640, 5120), "randn", seed=3)).to("cuda", torch.bfloat16)
    flat = torch.empty(640 * 5120 + 8, device="cuda", dtype=torch.bfloat16)
    cases = [(x, torch.empty_like(x), "sm90"), (x, flat[4:4 + x.numel()].view(x.shape), "simt"),
             (x[:, :333].contiguous(), torch.empty(640, 333, device="cuda"), "simt")]
    for xi, out, route in cases:
        assert _quant_route(xi, out) == route
        before = dict(quantize_int8.launches_by_route)
        q, scale = quantize_int8(xi, out)
        torch.cuda.synchronize()
        assert quantize_int8.launches_by_route == {r: before[r] + (r == route)
                                                   for r in QUANT_ROUTES}
        want_out = torch.empty_like(out)
        _assert_quant_equal(q, scale, *quantize_int8_plain(xi, want_out))
        assert torch.equal(out.float().view(torch.int32), want_out.float().view(torch.int32))


@pytest.mark.cuda
def test_quant_kernel_from_threads():
    """Three threads on streams of their own, as the runtime's Workers stage
    int8 inputs: every launch counted, every result right."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs = [torch.from_numpy(quant_input((640, 5120), "randn", seed=i)).to("cuda", torch.bfloat16)
          for i in range(3)]
    each, got = 50, [None] * 3
    before = quantize_int8.launches

    def stage(i):
        with torch.cuda.stream(torch.cuda.Stream()):
            for _ in range(each):
                got[i] = quantize_int8(xs[i])
            torch.cuda.current_stream().synchronize()

    pool = [threading.Thread(target=stage, args=(i,)) for i in range(3)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    assert quantize_int8.launches == before + 3 * each
    for x, (q, scale) in zip(xs, got):
        _assert_quant_equal(q, scale, *quantize_int8_plain(x))
