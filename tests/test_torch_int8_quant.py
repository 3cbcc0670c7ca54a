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
    """Several Workers' staging threads launch the kernel at once; the
    count loses none of their launches."""
    threads, each = 8, 5000
    before, interval = int8_quant.quantize_int8.launches, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=lambda: [int8_quant._count_launch()
                                                 for _ in range(each)])
                for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert int8_quant.quantize_int8.launches == before + threads * each
    int8_quant.quantize_int8.launches = before


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
