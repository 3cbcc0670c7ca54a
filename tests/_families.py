"""Shared parity checks of the port's serve path against the JAX package on
the smoke configs (f32): the same JAX-initialised weights go through both
(``params_from_jax``), with the same numpy tokens and modality inputs.

Every ``attn_gate`` is set to 2.0 first and every QKV bias drawn from
N(0, 0.1²) (both are zero at init), so that a cross-attention block and
qwen2.5's biases change the logits. MoE configs run their decode
with ``capacity_factor=16``, as the reference's own decode test does: at
the default, decode's capacity is 1 and the dropped tokens are not those
of a longer prefill.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import forward_decode, forward_prefill, init_params, params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
B, S, NEW = 2, 16, 8
DECODE_CAPACITY = 16.0


def _opened(tree, rng):
    """Gates at 2.0 and QKV biases random, in every block."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "attn_gate":
                out[k] = np.full_like(v, 2.0)
            elif k in ("bq", "bk", "bv"):
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
            else:
                out[k] = _opened(v, rng)
        return out
    if isinstance(tree, tuple):
        return tuple(_opened(v, rng) for v in tree)
    return tree


def cross_len(cfg):
    if cfg.arch_type == "vlm":
        return cfg.num_image_tokens
    if cfg.is_encoder_decoder:
        return cfg.encoder_seq_len
    return 0


@functools.lru_cache(maxsize=4)
def make_pair(arch, capacity_factor=None, dtype=None):
    """(cfg, jcfg, jax params, port model, tokens (B, S+NEW), cross_src or None).

    ``dtype`` replaces the config's (the weights'); cross_src stays f32."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    changes = {k: v for k, v in (("capacity_factor", capacity_factor), ("dtype", dtype))
               if v is not None}
    cfg = dataclasses.replace(cfg, **changes)
    jcfg = dataclasses.replace(jcfg, **changes)
    np_params = _opened(jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0))),
                        np.random.default_rng(1))
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = params_from_jax(np_params, cfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + NEW), dtype=np.int32)
    length = cross_len(cfg)
    cross = (rng.standard_normal((B, length, cfg.d_model)) * 0.5).astype(np.float32) \
        if length else None
    return cfg, jcfg, jparams, model, tokens, cross


def decode_pair(arch):
    cfg = get_smoke_config(arch)
    return make_pair(arch, DECODE_CAPACITY if cfg.uses_moe else None)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def assert_caches_equal(cfg, caches, jcaches):
    """Port caches (one dict per layer) against the reference's (one dict
    per pattern position, stacked over repetitions), every tensor."""
    period = len(cfg.layout_pattern)
    assert len(jcaches) == period
    for j, jc in enumerate(jcaches):
        layers = range(j, cfg.num_layers, period)
        assert set(jc) == set(caches[j]), (j, set(jc), set(caches[j]))
        for key, want in jc.items():
            got = torch.stack([caches[layer][key] for layer in layers]).numpy()
            assert got.shape == want.shape, (j, key)
            np.testing.assert_allclose(got, np.asarray(want), err_msg=f"{j} {key}", **TOL)


def check_prefill(pair):
    cfg, jcfg, jparams, model, tokens, cross = pair
    max_len = S + NEW + 1
    logits, caches, clen = forward_prefill(model, _t(tokens[:, :S]).long(), max_len, _t(cross))
    jlogits, jcaches, jclen = jax_forward_prefill(jparams, jcfg, jnp.asarray(tokens[:, :S]),
                                                  max_len, _j(cross))
    assert clen == int(jclen) == S
    assert logits.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert_caches_equal(cfg, caches, jcaches)


def check_teacher_forced_decode(pair):
    cfg, jcfg, jparams, model, tokens, cross = pair
    max_len = S + NEW + 1
    _, caches, clen = forward_prefill(model, _t(tokens[:, :S]).long(), max_len, _t(cross))
    _, jcaches, jclen = jax_forward_prefill(jparams, jcfg, jnp.asarray(tokens[:, :S]), max_len,
                                            _j(cross))
    step = jax.jit(jax_forward_decode, static_argnums=1)
    for t in range(S, S + NEW):
        tok = tokens[:, t:t + 1]
        logits, caches, clen = forward_decode(model, _t(tok).long(), caches, clen)
        jlogits, jcaches, jclen = step(jparams, jcfg, jnp.asarray(tok), jcaches, jclen)
        assert clen == int(jclen)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), err_msg=f"step {t}",
                                   **TOL)
    assert_caches_equal(cfg, caches, jcaches)


def check_generate(pair):
    cfg, jcfg, jparams, model, tokens, cross = pair
    res = generate(model, _t(tokens[:, :S]).long(), NEW, _t(cross))
    jlogits, jcaches, jclen = jax_forward_prefill(jparams, jcfg, jnp.asarray(tokens[:, :S]),
                                                  S + NEW + 1, _j(cross))
    step = jax.jit(jax_forward_decode, static_argnums=1)
    tok = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for _ in range(NEW):
        jlogits, jcaches, jclen = step(jparams, jcfg, tok, jcaches, jclen)
        tok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        want.append(tok)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    assert res.ids.shape == (B, NEW + 1)
    np.testing.assert_array_equal(res.ids.numpy(), want)
    np.testing.assert_allclose(res.last_logits.numpy(), np.asarray(jlogits), **TOL)


def check_init_follows_reference(pair):
    """``init_params`` builds what ``params_from_jax`` builds: the same
    names, shapes and dtypes; constants (norms, biases, gates, A_log, D)
    equal; random tensors at the reference's std within 15%."""
    cfg, _, _, ref_model, _, _ = pair
    model = init_params(cfg, seed=0, device="cpu")
    got, want = model.state_dict(), ref_model.state_dict()
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.split(".")[-1] in ("attn_gate", "bq", "bk", "bv"):
            assert torch.equal(g, torch.zeros_like(g)), name   # opened only in the pair
            continue
        if torch.equal(g, w):
            continue
        gstd, wstd = float(g.float().std()), float(w.float().std())
        assert wstd > 0 and abs(gstd - wstd) < 0.15 * wstd, (name, gstd, wstd)


def check_decode_matches_prefill(pair):
    """The port against itself, as the reference's decode test: decode
    logits at position t equal the last logits of a prefill over t + 1
    tokens (the caches are right)."""
    cfg, _, _, model, tokens, cross = pair
    tok, src = torch.from_numpy(tokens).long(), _t(cross)
    prefix = S - 4
    _, caches, clen = forward_prefill(model, tok[:, :prefix], S + 1, src)
    for t in range(prefix, S):
        logits, caches, clen = forward_decode(model, tok[:, t:t + 1], caches, clen)
        full, _, _ = forward_prefill(model, tok[:, :t + 1], t + 1, src)
        np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)
