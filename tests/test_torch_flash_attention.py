"""The port's flash attention on the CPU (its plain version) against the
JAX Pallas kernel in interpret mode and the JAX oracle. The CUDA kernel's
own test is ``test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_ref as jax_attention_ref
from repro.kernels import flash_attention as jax_flash_attention
from repro.models import blockwise_attention as jax_blockwise_attention
from repro_torch.kernels import attention_ref, flash_attention_bshd, flash_attention_plain
from repro_torch.kernels.flash_attention import flash_attention

SHAPES = [
    (2, 128, 128, 64, 1),
    (4, 256, 256, 128, 2),
    (2, 100, 100, 64, 1),     # ragged: padding path
    (3, 64, 192, 32, 3),      # cross-length + GQA 3
]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(bh, sq, sk, hd, g, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, hd), dtype=np.float32)
    k = rng.standard_normal((bh // g, sk, hd), dtype=np.float32)
    v = rng.standard_normal((bh // g, sk, hd), dtype=np.float32)
    return q, k, v


def _torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def _np(t):
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bh,sq,sk,hd,g", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(bh, sq, sk, hd, g, dtype):
    tdt, jdt = DTYPES[dtype]
    arrs = _inputs(bh, sq, sk, hd, g)
    causal = sq == sk
    got = flash_attention_plain(*_torch(arrs, tdt), q_heads_per_kv=g, causal=causal)
    jq, jk, jv = _jax(arrs, jdt)
    want_kernel = jax_flash_attention(jq, jk, jv, q_heads_per_kv=g, causal=causal,
                                      block_q=64, block_k=64, interpret=True)
    want_ref = jax_attention_ref(jq, jk, jv, q_heads_per_kv=g, causal=causal)
    assert got.dtype == tdt and got.shape == (bh, sq, hd)
    np.testing.assert_allclose(_np(got), _np(want_kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(want_ref), **_tol(dtype))
    # the port's own oracle agrees with the JAX one
    ref = attention_ref(*_torch(arrs, tdt), q_heads_per_kv=g, causal=causal)
    np.testing.assert_allclose(_np(ref), _np(want_ref), **_tol(dtype))


# (bh, sq, sk, hd, g, window): kimi-k2's head_dim 112 with its GQA 8, causal,
# ragged over the kernel's blocks, and with a sliding window
HD112_CASES = [
    (16, 128, 128, 112, 8, None),
    (8, 100, 100, 112, 8, None),
    (16, 128, 128, 112, 8, 48),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bh,sq,sk,hd,g,window", HD112_CASES)
def test_plain_head_dim_112_matches_jax_kernel_and_oracle(bh, sq, sk, hd, g, window, dtype):
    tdt, jdt = DTYPES[dtype]
    arrs = _inputs(bh, sq, sk, hd, g, seed=7)
    kw = dict(q_heads_per_kv=g, causal=True, window=window)
    got = flash_attention_plain(*_torch(arrs, tdt), **kw)
    jq, jk, jv = _jax(arrs, jdt)
    want_kernel = jax_flash_attention(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw)
    want_ref = jax_attention_ref(jq, jk, jv, **kw)
    assert got.dtype == tdt and got.shape == (bh, sq, hd)
    np.testing.assert_allclose(_np(got), _np(want_kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(want_ref), **_tol(dtype))
    ref = attention_ref(*_torch(arrs, tdt), **kw)
    np.testing.assert_allclose(_np(ref), _np(want_ref), **_tol(dtype))


def test_plain_sliding_window():
    arrs = _inputs(2, 256, 256, 64, 1, seed=1)
    got = flash_attention_plain(*_torch(arrs, torch.float32), causal=True, window=64)
    want = jax_attention_ref(*_jax(arrs, jnp.float32), causal=True, window=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_plain_q_offset_continuation():
    q, k, v = _torch(_inputs(1, 128, 128, 64, 1, seed=2), torch.float32)
    full = flash_attention_plain(q, k, v, causal=True, block_k=32)
    tail = flash_attention_plain(q[:, 96:], k, v, causal=True, q_offset=96, block_k=32)
    np.testing.assert_allclose(_np(tail), _np(full[:, 96:]), rtol=2e-5, atol=2e-5)
    jq, jk, jv = _jax(_inputs(1, 128, 128, 64, 1, seed=2), jnp.float32)
    want = jax_attention_ref(jq[:, 96:], jk, jv, causal=True, q_offset=96)
    np.testing.assert_allclose(_np(tail), _np(want), rtol=2e-5, atol=2e-5)


def test_plain_fully_masked_rows_match_oracle():
    """A query with no unmasked key averages V over every key (-1e30 is
    finite), as the oracle does."""
    arrs = _inputs(2, 16, 40, 32, 1, seed=3)
    got = flash_attention_plain(*_torch(arrs, torch.float32), causal=True, q_offset=-8,
                                block_k=16)
    want = jax_attention_ref(*_jax(arrs, jnp.float32), causal=True, q_offset=-8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_bshd_wrapper_matches_jax_model_path():
    rng = np.random.default_rng(4)
    b, s, h, kv, hd = 2, 128, 8, 2, 64
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    got = flash_attention_bshd(*_torch([q, k, v], torch.float32), causal=True)
    want = jax_blockwise_attention(*_jax([q, k, v], jnp.float32), causal=True)
    assert got.shape == (b, s, h, hd)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_wrapper_on_cpu_uses_plain_and_counts_no_launch():
    arrs = _torch(_inputs(2, 64, 64, 32, 2), torch.float32)
    before = flash_attention.launches
    got = flash_attention(*arrs, q_heads_per_kv=2)
    assert flash_attention.launches == before
    np.testing.assert_array_equal(_np(got), _np(flash_attention_plain(*arrs, q_heads_per_kv=2)))


@pytest.mark.parametrize("bad", ["dtype", "shape", "group"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = _torch(_inputs(4, 32, 32, 32, 2), torch.float32)
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        k = k[:, :, :16]
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v, q_heads_per_kv=3 if bad == "group" else 2)
