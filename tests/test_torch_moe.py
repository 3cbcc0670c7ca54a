"""The port's MoE layer against the JAX package's ``repro.models.moe``.

The same weights (the reference's ``init_moe``, as numpy) and inputs go
through both. f32 agrees to 1e-5, at the default capacity too, where
tokens are dropped: that pins which assignments overflow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(0)


def _params(d, e, ff, dtype=jnp.float32, key=KEY):
    jp = jax_moe.init_moe(key, d, e, ff, dtype=dtype)
    return jp, {k: _torch(v) for k, v in jp.items()}


def _torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _overflowing(idx, t, k, e, cf):
    """Assignments past their expert's capacity."""
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=e)
    return int(np.maximum(counts - moe.capacity(t, k, e, cf), 0).sum())


def test_router_topk_and_load_balance_loss():
    x = _x((24, 32), 0)
    jp, tp = _params(32, 8, 16)
    gates, idx, probs = moe.router_topk(torch.from_numpy(x), tp["router"], 3)
    jgates, jidx, jprobs = jax_moe.router_topk(jnp.asarray(x), jp["router"], 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    loss = moe.load_balance_loss(probs, idx, 8)
    jloss = jax_moe.load_balance_loss(jprobs, jidx, 8)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


@pytest.mark.parametrize("tokens,k,experts,cf,want", [
    (4, 8, 64, 1.25, 1),      # olmoe-1b-7b at decode, batch 4: 0.625 → 1
    (4, 8, 384, 1.25, 1),     # kimi-k2 at decode
    (4096, 8, 64, 1.25, 640),
    (4096, 8, 384, 1.25, 107),
    (4, 5, 8, 1.0, 2),        # 2.5 rounds half to even, as Python's round
    (12, 1, 8, 1.0, 2),       # 1.5 → 2
])
def test_capacity_rounds_as_the_reference(tokens, k, experts, cf, want):
    assert moe.capacity(tokens, k, experts, cf) == want
    assert want == int(max(1, round(tokens * k / experts * cf)))


@pytest.mark.parametrize("b,s,d,e,k,ff,seed", [
    (2, 16, 32, 8, 2, 64, 1),
    (1, 64, 16, 8, 2, 32, 2),
    (4, 1, 32, 8, 4, 16, 3),  # decode-like: capacity 1
])
def test_moe_ffn_matches_jax_at_default_capacity(b, s, d, e, k, ff, seed):
    jp, tp = _params(d, e, ff, key=jax.random.PRNGKey(seed))
    x = _x((b, s, d), seed)
    got, aux = moe.moe_ffn(tp, torch.from_numpy(x), e, k, return_aux=True)
    want, jaux = jax_moe.moe_ffn(jp, jnp.asarray(x), e, k, return_aux=True)
    _, idx, _ = jax_moe.router_topk(jnp.asarray(x).reshape(b * s, d), jp["router"], k)
    assert _overflowing(idx, b * s, k, e, 1.25) > 0        # the drops are exercised
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_moe_sort_dispatch_matches_dense_oracle():
    d, e, k, ff = 32, 8, 2, 64
    _, tp = _params(d, e, ff)
    x = torch.from_numpy(_x((2, 16, d), 4, scale=0.5))
    got = moe.moe_ffn(tp, x, e, k, capacity_factor=8.0)
    want = moe.moe_ffn_dense(tp, x, e, k)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    jp, _ = _params(d, e, ff)
    jwant = jax_moe.moe_ffn_dense(jp, jnp.asarray(x.numpy()), e, k)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), **TOL)


def test_moe_capacity_drops_are_bounded():
    d, e, k, ff = 16, 4, 2, 32
    _, tp = _params(d, e, ff)
    x = torch.from_numpy(_x((1, 64, d), 5))
    tight = moe.moe_ffn(tp, x, e, k, capacity_factor=0.5)
    loose = moe.moe_ffn(tp, x, e, k, capacity_factor=8.0)
    assert torch.isfinite(tight).all()
    assert not torch.allclose(tight, loose)


def test_moe_ffn_bf16_matches_jax():
    """bf16 weights and activations: the router in f32, the buffer in the
    weight dtype and the combine in bf16 on both sides. The expert products
    may round differently (a few bf16 ulps), so the bound is 2e-2 of the
    output's largest value, the bf16 bound of the kernel checks."""
    d, e, k, ff = 64, 8, 2, 128
    jp, tp = _params(d, e, ff, dtype=jnp.bfloat16)
    x = _x((2, 32, d), 6)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = moe.moe_ffn(tp, _torch(xb), e, k)
    want = np.asarray(jax_moe.moe_ffn(jp, xb, e, k), np.float32)
    assert got.dtype == torch.bfloat16
    bound = 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=bound)


def test_moe_ffn_gives_the_same_bits_twice():
    d, e, k, ff = 32, 8, 2, 64
    _, tp = _params(d, e, ff, dtype=jnp.bfloat16)
    x = torch.from_numpy(_x((2, 24, d), 7)).bfloat16()
    first = moe.moe_ffn(tp, x, e, k)
    assert torch.equal(first.view(torch.int16), moe.moe_ffn(tp, x, e, k).view(torch.int16))


def test_init_moe_follows_reference():
    """Shapes, dtypes and the scales: the router f32 at D^-0.5, the expert
    tensors at E^-0.5 (fan_in is their first axis, E)."""
    d, e, ff = 64, 16, 96
    jp, _ = _params(d, e, ff, dtype=jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    tp = moe.init_moe(gen, d, e, ff, dtype=torch.bfloat16)
    for name, want in jp.items():
        got = tp[name]
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        std, jstd = float(got.float().std()), float(np.asarray(want, np.float32).std())
        assert abs(std - jstd) < 0.05 * jstd, name
    assert abs(float(tp["w_gate"].float().std()) - e ** -0.5) < 0.05 * e ** -0.5
