"""The port's serve path against the JAX package on the qwen3 smoke config
(f32): the same JAX-initialised weights go through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch import resolve_device
from repro_torch.configs import ALIASES, get_config, get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import generate
from repro_torch.models import (
    check_supported,
    forward_decode,
    forward_prefill,
    init_cache,
    init_params,
    params_from_jax,
)
from repro_torch.models.transformer import layer_kinds

TOL = dict(rtol=2e-4, atol=2e-4)
B, S, NEW = 2, 16, 8


@pytest.fixture(scope="module")
def pair():
    cfg = get_smoke_config("qwen3-14b")
    jcfg = jax_smoke_config("qwen3-14b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    model = params_from_jax(np_params, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + NEW), dtype=np.int32)
    return cfg, jcfg, jparams, model, tokens


def _stack(caches, key):
    return torch.stack([c[key] for c in caches]).numpy()


def test_prefill_logits_and_caches(pair):
    cfg, jcfg, jparams, model, tokens = pair
    max_len = S + NEW + 1
    logits, caches, clen = forward_prefill(model, torch.from_numpy(tokens[:, :S]).long(),
                                           max_len)
    jlogits, jcaches, jclen = jax_forward_prefill(jparams, jcfg, jnp.asarray(tokens[:, :S]),
                                                  max_len)
    assert clen == int(jclen) == S
    assert logits.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for key in ("k", "v"):
        assert _stack(caches, key).shape == jcaches[0][key].shape
        np.testing.assert_allclose(_stack(caches, key), np.asarray(jcaches[0][key]), **TOL)


def test_teacher_forced_decode(pair):
    cfg, jcfg, jparams, model, tokens = pair
    max_len = S + NEW + 1
    _, caches, clen = forward_prefill(model, torch.from_numpy(tokens[:, :S]).long(), max_len)
    _, jcaches, jclen = jax_forward_prefill(jparams, jcfg, jnp.asarray(tokens[:, :S]), max_len)
    for t in range(S, S + NEW):
        tok = tokens[:, t:t + 1]
        logits, caches, clen = forward_decode(model, torch.from_numpy(tok).long(), caches, clen)
        jlogits, jcaches, jclen = jax_forward_decode(jparams, jcfg, jnp.asarray(tok),
                                                     jcaches, jclen)
        assert clen == int(jclen)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(_stack(caches, "k"), np.asarray(jcaches[0]["k"]), **TOL)


def test_generate_matches_jax_greedy_loop(pair):
    cfg, jcfg, jparams, model, tokens = pair
    res = generate(model, torch.from_numpy(tokens[:, :S]).long(), NEW)
    jlogits, jcaches, jclen = jax_forward_prefill(jparams, jcfg, jnp.asarray(tokens[:, :S]),
                                                  S + NEW + 1)
    tok = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for _ in range(NEW):
        jlogits, jcaches, jclen = jax_forward_decode(jparams, jcfg, tok, jcaches, jclen)
        tok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        want.append(tok)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    assert res.ids.shape == (B, NEW + 1)
    np.testing.assert_array_equal(res.ids.numpy(), want)
    assert torch.isfinite(res.prefill_logits).all() and torch.isfinite(res.last_logits).all()


def test_decode_matches_prefill_over_longer_prompt(pair):
    """Decode logits at position t equal prefill's last logits over t+1 tokens."""
    cfg, _, _, model, tokens = pair
    tok = torch.from_numpy(tokens).long()
    prefix = S - 4
    _, caches, clen = forward_prefill(model, tok[:, :prefix], S + 1)
    for t in range(prefix, S):
        logits, caches, clen = forward_decode(model, tok[:, t:t + 1], caches, clen)
        full, _, _ = forward_prefill(model, tok[:, :t + 1], t + 1)
        np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_decode_from_empty_cache(pair):
    cfg, jcfg, jparams, model, tokens = pair
    caches = init_cache(cfg, B, 4, device="cpu")
    jcaches = jax_init_cache(jcfg, B, 4)
    assert _stack(caches, "k").shape == jcaches[0]["k"].shape
    clen, jclen = 0, jnp.int32(0)
    for t in range(3):
        tok = tokens[:, t:t + 1]
        logits, caches, clen = forward_decode(model, torch.from_numpy(tok).long(), caches, clen)
        jlogits, jcaches, jclen = jax_forward_decode(jparams, jcfg, jnp.asarray(tok),
                                                     jcaches, jclen)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_cpu_serve_path_launches_no_kernel(pair):
    cfg, _, _, model, tokens = pair
    before = flash_attention.launches
    generate(model, torch.from_numpy(tokens[:, :S]).long(), 2)
    assert flash_attention.launches == before


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    cfg = get_smoke_config("qwen3-14b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        init_params(cfg)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_every_config_is_supported(arch):
    """Every config of the repo is accepted, at full size too, and its
    smoke model builds: one block per layer, of the pattern's kinds."""
    check_supported(get_config(arch))
    cfg = get_smoke_config(arch)
    check_supported(cfg)
    model = init_params(cfg, device="cpu")
    assert [b.kind for b in model.blocks] == layer_kinds(cfg)
    assert (model.encoder is not None) == cfg.is_encoder_decoder


def test_init_params_shapes_follow_reference(pair):
    cfg, _, _, ref_model, _ = pair
    model = init_params(cfg, seed=0, device="cpu")
    want = {k: tuple(v.shape) for k, v in ref_model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    w = model.blocks[0].attn["wq"]
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
