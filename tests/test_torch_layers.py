"""The port's layers and attention pieces against the JAX reference, f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro_torch.models import attention, layers

TOL = dict(rtol=2e-5, atol=2e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm():
    rng = _rng(0)
    x, scale = _normal(rng, 2, 7, 96), _normal(rng, 96)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    want = jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_casts_before_scaling_in_bf16():
    rng = _rng(1)
    x, scale = _normal(rng, 3, 64), _normal(rng, 64)
    got = layers.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale).bfloat16())
    want = jax_layers.rms_norm(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(scale).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_apply_rope(theta):
    rng = _rng(2)
    x = _normal(rng, 2, 9, 3, 32)
    pos = np.broadcast_to(np.arange(9) + 5, (2, 9)).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(layers.rope_frequencies(32, theta).numpy(),
                               np.asarray(jax_layers.rope_frequencies(32, theta)), **TOL)


def test_swiglu():
    rng = _rng(3)
    x = _normal(rng, 2, 5, 48)
    w = [_normal(rng, 48, 80, scale=0.1), _normal(rng, 48, 80, scale=0.1),
         _normal(rng, 80, 48, scale=0.1)]
    got = layers.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w))
    want = jax_layers.swiglu(jnp.asarray(x), *map(jnp.asarray, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _attn_params(rng, d, h, kv, hd, bias):
    p = {"wq": _normal(rng, d, h, hd, scale=d ** -0.5),
         "wk": _normal(rng, d, kv, hd, scale=d ** -0.5),
         "wv": _normal(rng, d, kv, hd, scale=d ** -0.5),
         "wo": _normal(rng, h, hd, d, scale=h ** -0.5),
         "q_norm": 1.0 + _normal(rng, hd, scale=0.1),
         "k_norm": 1.0 + _normal(rng, hd, scale=0.1)}
    if bias:
        p.update(bq=_normal(rng, h, hd), bk=_normal(rng, kv, hd), bv=_normal(rng, kv, hd))
    return p


@pytest.mark.parametrize("bias", [False, True])
def test_project_qkv_with_qk_norm_and_output(bias):
    rng = _rng(4)
    b, s, d, h, kv, hd = 2, 6, 64, 4, 2, 16
    p = _attn_params(rng, d, h, kv, hd, bias)
    x = _normal(rng, b, s, d)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    got = attention.project_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), torch.from_numpy(pos),
                                rope_theta=1e6, qk_norm=True)
    want = jax_attention.project_qkv({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x), jnp.asarray(pos),
                                     rope_theta=1e6, qk_norm=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    out = attention.attention_output({"wo": torch.from_numpy(p["wo"])}, got[0])
    out_want = jax_attention.attention_output({"wo": jnp.asarray(p["wo"])}, want[0])
    np.testing.assert_allclose(out.numpy(), np.asarray(out_want), **TOL)


@pytest.mark.parametrize("cache_len,window", [(1, None), (7, None), (12, None), (9, 4)])
def test_decode_attention(cache_len, window):
    rng = _rng(5)
    b, s, h, kv, hd = 2, 12, 6, 2, 16
    q = _normal(rng, b, 1, h, hd)
    ck, cv = _normal(rng, b, s, kv, hd), _normal(rng, b, s, kv, hd)
    got = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                     torch.from_numpy(cv), cache_len, window=window)
    want = jax_attention.decode_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                          jnp.int32(cache_len), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_mlp_uses_the_tanh_approximation():
    rng = _rng(6)
    x = _normal(rng, 2, 5, 48, scale=2.0)
    w = [_normal(rng, 48, 80, scale=0.3), _normal(rng, 80), _normal(rng, 80, 48, scale=0.1),
         _normal(rng, 48)]
    got = layers.gelu_mlp(torch.from_numpy(x), *map(torch.from_numpy, w))
    want = jax_layers.gelu_mlp(jnp.asarray(x), *map(jnp.asarray, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_attention_gated_follows_reference():
    import jax
    gen = torch.Generator().manual_seed(0)
    got = layers.init_attention(gen, 64, 4, 2, 16, qk_norm=True, gated=True)
    want = jax_layers.init_attention(jax.random.PRNGKey(0), 64, 4, 2, 16, qk_norm=True,
                                     gated=True)
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
    np.testing.assert_array_equal(got["attn_gate"].numpy(), np.asarray(want["attn_gate"]))
    assert float(got["attn_gate"][0]) == 0.0
    assert "attn_gate" not in layers.init_attention(gen, 64, 4, 2, 16)


@pytest.mark.parametrize("qk_norm,gate", [(False, None), (True, 2.0), (False, -0.5)])
def test_cross_attention(qk_norm, gate):
    """Non-causal, Sq ≠ Sk, GQA; no RoPE on the keys; tanh(gate) on the output."""
    rng = _rng(7)
    b, s, t, d, h, kv, hd = 2, 6, 11, 64, 4, 2, 16
    p = _attn_params(rng, d, h, kv, hd, bias=False)
    if gate is not None:
        p["attn_gate"] = np.array([gate], np.float32)
    x, src = _normal(rng, b, s, d), _normal(rng, b, t, d)
    got = attention.cross_attention({k: torch.from_numpy(v) for k, v in p.items()},
                                    torch.from_numpy(x), torch.from_numpy(src), 1e-5, qk_norm)
    want = jax_attention.cross_attention({k: jnp.asarray(v) for k, v in p.items()},
                                         jnp.asarray(x), jnp.asarray(src), 1e-5, qk_norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
