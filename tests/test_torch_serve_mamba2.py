"""The port's serve path against the JAX package on the mamba2 smoke config
(f32, attention-free ``ssm`` blocks, tied embeddings): the same
JAX-initialised weights go through both."""
import dataclasses

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
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch.serve import generate
from repro_torch.models import (
    forward_decode,
    forward_prefill,
    init_cache,
    init_params,
    params_from_jax,
)

TOL = dict(rtol=2e-4, atol=2e-4)
B, S, NEW = 2, 16, 8


@pytest.fixture(scope="module")
def pair():
    cfg = get_smoke_config("mamba2-1.3b")
    jcfg = jax_smoke_config("mamba2-1.3b")
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
    assert set(caches[0]) == set(jcaches[0]) == {"conv", "state"}
    for key in ("conv", "state"):
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
    for key in ("conv", "state"):
        np.testing.assert_allclose(_stack(caches, key), np.asarray(jcaches[0][key]), **TOL)


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
    """Decode logits at position t equal prefill's last logits over t+1
    tokens (every prompt here is one chunk long or a multiple of it)."""
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
    for key in ("conv", "state"):
        assert _stack(caches, key).shape == jcaches[0][key].shape
        assert _stack(caches, key).dtype == np.asarray(jcaches[0][key]).dtype
    clen, jclen = 0, jnp.int32(0)
    for t in range(3):
        tok = tokens[:, t:t + 1]
        logits, caches, clen = forward_decode(model, torch.from_numpy(tok).long(), caches, clen)
        jlogits, jcaches, jclen = jax_forward_decode(jparams, jcfg, jnp.asarray(tok),
                                                     jcaches, jclen)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_prompt_not_a_multiple_of_the_chunk_raises(pair):
    """S = 20 with chunk 16: both packages refuse rather than pad."""
    cfg, jcfg, jparams, model, tokens = pair
    with pytest.raises(ValueError, match="chunk"):
        forward_prefill(model, torch.from_numpy(tokens[:, :20]).long(), 21)
    with pytest.raises(AssertionError):
        jax_forward_prefill(jparams, jcfg, jnp.asarray(tokens[:, :20]), 21)


def test_cpu_serve_path_launches_no_kernel(pair):
    cfg, _, _, model, tokens = pair
    before = (ssd_scan.launches, flash_attention.launches)
    generate(model, torch.from_numpy(tokens[:, :S]).long(), 2)
    assert (ssd_scan.launches, flash_attention.launches) == before


def test_init_params_follows_reference(pair):
    cfg, _, jparams, ref_model, _ = pair
    model = init_params(cfg, seed=0, device="cpu")
    want = {k: (tuple(v.shape), v.dtype) for k, v in ref_model.state_dict().items()}
    assert {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()} == want
    assert model.head is None                       # tied embeddings
    assert sum(p.numel() for p in model.parameters()) == \
        sum(np.size(leaf) for leaf in jax.tree.leaves(jparams))
    w = model.blocks[0].ssm["in_proj"]
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_bf16_model_keeps_ssm_scalars_in_f32():
    cfg = get_smoke_config("mamba2-1.3b")
    jcfg = jax_smoke_config("mamba2-1.3b")
    cfg, jcfg = (dataclasses.replace(c, dtype="bfloat16") for c in (cfg, jcfg))
    np_params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    for model in (params_from_jax(np_params, cfg, device="cpu"),
                  init_params(cfg, seed=0, device="cpu")):
        blk = model.blocks[0].ssm
        assert blk["in_proj"].dtype == torch.bfloat16
        assert {blk[k].dtype for k in ("A_log", "dt_bias", "D")} == {torch.float32}
        logits, caches, _ = forward_prefill(model, torch.zeros((1, 16), dtype=torch.long), 17)
        assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()
        assert caches[0]["conv"].dtype == torch.bfloat16
        assert caches[0]["state"].dtype == torch.float32
