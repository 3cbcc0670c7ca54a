"""The port's Mamba2 pieces against ``repro.models.ssm`` on the mamba2 smoke
config (f32), with JAX-initialised weights carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm

TOL = dict(rtol=2e-4, atol=2e-4)
B = 2


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("mamba2-1.3b")
    jcfg = jax_smoke_config("mamba2-1.3b")
    jparams = jax_ssm.init_mamba2(jax.random.PRNGKey(0), jcfg.d_model, jcfg.d_inner,
                                  jcfg.ssm_state, jcfg.ssm_heads, jcfg.ssm_groups,
                                  jcfg.ssm_conv_width)
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    return cfg, jcfg, params, jparams


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(setup, with_state):
    _, _, params, jparams = setup
    c = params["conv_w"].shape[1]
    x = _x(B, 7, c, seed=1)
    state = _x(B, 3, c, seed=2) if with_state else None
    y, st = ssm.causal_conv1d(torch.from_numpy(x), params["conv_w"], params["conv_b"],
                              None if state is None else torch.from_numpy(state))
    jy, jst = jax_ssm.causal_conv1d(jnp.asarray(x), jparams["conv_w"], jparams["conv_b"],
                                    None if state is None else jnp.asarray(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def test_segsum():
    x = _x(2, 3, 9, seed=3)
    got = ssm.segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_ssm.segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


def test_init_mamba2_follows_reference(setup):
    cfg, _, params, _ = setup
    gen = torch.Generator().manual_seed(0)
    got = ssm.init_mamba2(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                          cfg.ssm_groups, cfg.ssm_conv_width, dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    for k in ("A_log", "dt_bias", "D"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), params[k].numpy(), rtol=1e-6)
    assert got["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("s", [16, 32, 12])
def test_mixer_with_state(setup, s):
    cfg, jcfg, params, jparams = setup
    x = _x(B, s, cfg.d_model, seed=4)
    out, (conv, state) = ssm.mamba2_mixer(params, torch.from_numpy(x), cfg,
                                          return_state=True)
    jout, (jconv, jstate) = jax_ssm.mamba2_mixer(jparams, jnp.asarray(x), jcfg,
                                                 return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)
    assert torch.equal(ssm.mamba2_mixer(params, torch.from_numpy(x), cfg), out)


def test_mixer_continues_from_given_states(setup):
    cfg, jcfg, params, jparams = setup
    x = _x(B, 16, cfg.d_model, seed=5)
    conv = _x(B, cfg.ssm_conv_width - 1, params["conv_w"].shape[1], seed=6)
    state = _x(B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, seed=7, scale=0.1)
    out, (c2, s2) = ssm.mamba2_mixer(params, torch.from_numpy(x), cfg, torch.from_numpy(conv),
                                     torch.from_numpy(state), return_state=True)
    jout, (jc2, js2) = jax_ssm.mamba2_mixer(jparams, jnp.asarray(x), jcfg, jnp.asarray(conv),
                                            jnp.asarray(state), return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **TOL)


def test_decode_step(setup):
    cfg, jcfg, params, jparams = setup
    x = _x(B, 1, cfg.d_model, seed=8)
    conv = _x(B, cfg.ssm_conv_width - 1, params["conv_w"].shape[1], seed=9)
    state = _x(B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, seed=10, scale=0.1)
    out, (c2, s2) = ssm.mamba2_decode_step(params, torch.from_numpy(x), cfg,
                                           torch.from_numpy(conv), torch.from_numpy(state))
    jout, (jc2, js2) = jax_ssm.mamba2_decode_step(jparams, jnp.asarray(x), jcfg,
                                                  jnp.asarray(conv), jnp.asarray(state))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **TOL)


def test_decode_steps_continue_the_mixer(setup):
    """Mixer over 12 tokens, then 4 decode steps, equals the last 4 outputs
    of the mixer over all 16 tokens."""
    cfg, _, params, _ = setup
    x = torch.from_numpy(_x(B, 16, cfg.d_model, seed=11))
    full = ssm.mamba2_mixer(params, x, cfg)
    _, (conv, state) = ssm.mamba2_mixer(params, x[:, :12], cfg, return_state=True)
    for t in range(12, 16):
        out, (conv, state) = ssm.mamba2_decode_step(params, x[:, t:t + 1], cfg, conv, state)
        np.testing.assert_allclose(out.numpy(), full[:, t:t + 1].numpy(), rtol=1e-3, atol=1e-3)
