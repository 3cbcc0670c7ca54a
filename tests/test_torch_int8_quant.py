"""The port's int8 row quantizer (K1) against the JAX package's, on the CPU.

The port's ``ops.quantize_rows`` on a CPU tensor is the kernel's plain
version; the JAX side runs the Pallas kernel in interpret mode. Inputs are
made from a seed with numpy and handed to both.

The port computes scale as one IEEE division of the absmax by 127. XLA on
the CPU turns the JAX kernel's ``/ 127.0`` into a multiplication by the
rounded reciprocal, one ulp off the quotient for some rows; its q is the
IEEE ``round(x / scale)`` of that scale. So: the port's scale equals the
IEEE quotient bit for bit and JAX's at rtol 1e-6 (the reference's own
tolerance, ``tests/test_kernels.py``); q equals JAX's exactly on every row
whose two scales agree bit for bit, and everywhere equals
``round(x / scale)`` (half to even) of the port's scale.
"""
import sys
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _quant_inputs import quant_input
from repro.kernels import dequantize_int8, quantize_int8
from repro_torch.kernels import dequantize_rows, int8_quant, quantize_rows


def _both(x, dtype, block_rows=256):
    """(port q, port scale, jax q, jax scale) as numpy, same input values."""
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(xt.float().numpy().astype(ml_dtypes.bfloat16))
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    q, s = quantize_rows(xt)
    qj, sj = quantize_int8(xj, block_rows=block_rows, interpret=True)
    return q.numpy(), s.numpy(), np.asarray(qj), np.asarray(sj)


CASES = [
    ((16, 64), "float32", "randn", 64),
    ((100, 128), "float32", "randn", 64),
    ((256, 32), "float32", "randn", 64),
    ((300, 77), "float32", "randn", 64),        # ragged: 300 rows over 64-row blocks
    ((300, 77), "bfloat16", "randn", 64),
    ((64, 128), "bfloat16", "randn", 256),
    ((64, 128), "float32", "zeros", 256),
    ((64, 128), "bfloat16", "zeros", 256),
    ((48, 96), "float32", "ties", 256),
    ((48, 96), "bfloat16", "ties", 256),
]


@pytest.mark.parametrize("shape,dtype,values,block_rows", CASES)
def test_quantize_rows_matches_jax(shape, dtype, values, block_rows):
    x = quant_input(shape, values)
    q, s, qj, sj = _both(x, dtype, block_rows)
    assert q.dtype == np.int8 and s.dtype == np.float32
    xf = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    ieee = np.maximum(np.abs(xf).max(axis=1), np.float32(1e-8)) / np.float32(127.0)
    np.testing.assert_array_equal(s.view(np.int32), ieee.view(np.int32))
    np.testing.assert_allclose(s, sj, rtol=1e-6, atol=0)
    same = s.view(np.int32) == sj.view(np.int32)
    np.testing.assert_array_equal(q[same], qj[same])
    np.testing.assert_array_equal(q, np.clip(np.round(xf / s[:, None]), -127, 127))


def test_ties_round_half_to_even():
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]], np.float32)
    q, s = quantize_rows(torch.from_numpy(x))
    assert float(s[0]) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 126]]


def test_zero_rows_take_the_scale_floor():
    q, s = quantize_rows(torch.zeros(3, 5))
    np.testing.assert_array_equal(s.numpy(), np.float32(np.float32(1e-8) / np.float32(127.0)))
    assert not q.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_oracle(dtype):
    """Rows that hold a NaN or an inf: the scale is NaN or inf where the JAX
    kernel's is; q is compared on the rows whose scale is finite (elsewhere
    both cast a NaN to int8, which neither defines)."""
    x = quant_input((100, 77), "nonfinite", seed=3)
    q, s, qj, sj = _both(x, dtype, block_rows=64)
    np.testing.assert_array_equal(np.isnan(s), np.isnan(sj))
    np.testing.assert_array_equal(np.isinf(s), np.isinf(sj))
    fin = np.isfinite(s)
    assert np.isnan(s).sum() == 25 and np.isinf(s).sum() == 25
    np.testing.assert_allclose(s[fin], sj[fin], rtol=1e-6, atol=0)
    same = fin & (s.view(np.int32) == sj.view(np.int32))
    np.testing.assert_array_equal(q[same], qj[same])


def test_launch_count_is_exact_across_threads():
    """Several Workers' staging threads launch the kernels at once; the
    count loses none of their launches, and the routes add up to it."""
    threads, each = 8, 5000
    k1 = int8_quant.quantize_int8
    before, by_route = k1.launches, dict(k1.launches_by_route)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=lambda r=int8_quant.ROUTES[i % 2]: [
                    int8_quant._count_launch(r) for _ in range(each)])
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert k1.launches == before + threads * each
    assert k1.launches_by_route == {r: by_route[r] + threads // 2 * each
                                    for r in int8_quant.ROUTES}
    k1.launches, k1.launches_by_route = before, by_route


def test_dequantize_rows_matches_jax():
    x = quant_input((100, 128), "randn", seed=1)
    q, s = quantize_rows(torch.from_numpy(x))
    got = dequantize_rows(q, s).numpy()
    want = np.asarray(dequantize_int8(jnp.asarray(q.numpy()), jnp.asarray(s.numpy())))
    np.testing.assert_array_equal(got, want)
    out = torch.empty(100, 128, dtype=torch.bfloat16)
    assert dequantize_rows(q, s, out=out) is out
    np.testing.assert_array_equal(out.float().numpy(),
                                  torch.tensor(want).to(torch.bfloat16).float().numpy())


OUT_CASES = [
    ((100, 128), "float32", "randn"),
    ((300, 77), "bfloat16", "randn"),           # ragged rows: the simt route's shape
    ((64, 128), "bfloat16", "zeros"),
    ((48, 96), "float32", "ties"),
    ((48, 96), "bfloat16", "ties"),
    ((100, 77), "bfloat16", "nonfinite"),
]


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,dtype,values", OUT_CASES)
def test_quantize_rows_out_is_the_roundtrip(shape, dtype, values, out_dtype):
    """``out`` holds ``dequantize_rows(*quantize_rows(x))`` bit for bit on
    every row whose scale is finite, and JAX's ``dequantize_int8`` of its
    own kernel's q and scale on every row whose two scales agree."""
    x = quant_input(shape, values, seed=5)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = torch.full(shape, 7.0, dtype=getattr(torch, out_dtype))
    q, s = quantize_rows(xt, out=out)
    want_q, want_s = quantize_rows(xt)
    assert torch.equal(q, want_q) and torch.equal(s.view(torch.int32), want_s.view(torch.int32))
    want = dequantize_rows(want_q, want_s, out=torch.empty_like(out))
    fin = torch.isfinite(s)
    assert int((~fin).sum()) == (shape[0] // 2 if values == "nonfinite" else 0)
    assert torch.equal(out[fin].float().view(torch.int32), want[fin].float().view(torch.int32))
    _, _, qj, sj = _both(x, dtype, block_rows=64)
    wj = np.array(dequantize_int8(jnp.asarray(qj), jnp.asarray(sj)))
    wj = torch.from_numpy(wj).to(getattr(torch, out_dtype))
    same = fin & (s.view(torch.int32) == torch.tensor(sj).view(torch.int32))
    assert int(same.sum()) >= shape[0] // 4
    assert torch.equal(out[same].float().view(torch.int32), wj[same].float().view(torch.int32))


def test_roundtrip_error_bounded():
    x = quant_input((64, 128), "randn", seed=2) * (5.0 / 3.0)
    q, s = quantize_rows(torch.from_numpy(x))
    back = dequantize_rows(q, s).numpy()
    assert np.abs(back - x).max() <= float(s.max())     # within one step


def test_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        quantize_rows(torch.zeros(4, 4, dtype=torch.float16))
    with pytest.raises(ValueError):
        quantize_rows(torch.zeros(4, 4, 4))
    with pytest.raises(ValueError):
        quantize_rows(torch.zeros(0, 4))


@pytest.fixture
def no_library(monkeypatch):
    """Any library load fails the test."""
    def refuse():
        raise AssertionError("a library was loaded")
    monkeypatch.setattr(int8_quant, "_lib", refuse)
    monkeypatch.setattr(int8_quant, "_lib_sm90", refuse)


def _offset(t, nbytes):
    """``t``'s shape and dtype, ``nbytes`` past a 16-byte aligned base."""
    flat = torch.empty(t.numel() * t.element_size() + 64, dtype=torch.uint8)
    view = flat[nbytes:nbytes + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    assert view.data_ptr() % 16 == nbytes % 16
    return view


# (dtype, (rows, cols), route): sm90 takes rows of whole 16-byte pieces up to
# 48 KB (the boundary shape, the CPU runtime tests' yolov8n boundary rows, the
# test shapes); simt takes ragged rows and rows over one stage
ROUTE_CASES = [
    ("bfloat16", (640, 5120), "sm90"), ("bfloat16", (8, 32), "sm90"),
    ("float32", (100, 128), "sm90"), ("float32", (256, 4), "sm90"),
    ("bfloat16", (4, 24576), "sm90"), ("float32", (4, 12288), "sm90"),
    ("bfloat16", (1000, 333), "simt"), ("float32", (16, 6), "simt"),
    ("bfloat16", (16, 12), "simt"),
    ("bfloat16", (4, 24584), "simt"), ("float32", (4, 12292), "simt"),
]


@pytest.mark.parametrize("dtype,shape,route", ROUTE_CASES)
def test_route_by_shape(no_library, dtype, shape, route):
    x = torch.zeros(shape, dtype=getattr(torch, dtype))
    assert int8_quant._route(x) == route
    out = torch.zeros(shape, dtype=torch.bfloat16)
    assert int8_quant._route(x, out) == route


@pytest.mark.parametrize("which", ["x", "out"])
def test_route_takes_misaligned_pointers_to_simt(no_library, which):
    x, out = torch.zeros(640, 5120, dtype=torch.bfloat16), torch.zeros(640, 5120)
    if which == "x":
        x = _offset(x, 8)
    else:
        out = _offset(out, 4)
    assert int8_quant._route(x, out) == "simt"
    assert int8_quant._route(x) == ("simt" if which == "x" else "sm90")


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16, torch.float32])
def test_cpu_call_takes_the_plain_version(no_library, out_dtype):
    x = torch.from_numpy(quant_input((64, 128), "randn", seed=6)).to(torch.bfloat16)
    k1 = int8_quant.quantize_int8
    before = (k1.launches, dict(k1.launches_by_route))
    out = None if out_dtype is None else torch.empty(64, 128, dtype=out_dtype)
    want_out = None if out_dtype is None else torch.empty(64, 128, dtype=out_dtype)
    q, s = k1(x, out)
    want_q, want_s = int8_quant.quantize_int8_plain(x, want_out)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert out is None or torch.equal(out, want_out)
    assert (k1.launches, k1.launches_by_route) == before


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrapper_checks_out(bad):
    x = torch.zeros(4, 8)
    out = torch.zeros(4, 8, dtype=torch.float16) if bad == "dtype" else torch.zeros(4, 9)
    with pytest.raises(TypeError if bad == "dtype" else ValueError, match="out"):
        quantize_rows(x, out=out)
