"""Serve-path parity with the JAX package for the cross-attending smoke
configs (f32, ``_families``): llama-3.2-vision (``cross`` blocks, gates
opened to 2.0) and whisper-medium (encoder-decoder). Also: the image path
changes the logits, whisper's encoder output equals the reference's, and
both at bf16 with the reference's f32 modality input."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _families as fam
from repro.models import forward_prefill as jax_forward_prefill
from repro.models.transformer import encode as jax_encode
from repro_torch.models import encode, forward_prefill

ARCHS = ["llama-3.2-vision-11b", "whisper-medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches(arch):
    fam.check_prefill(fam.make_pair(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode(arch):
    fam.check_teacher_forced_decode(fam.decode_pair(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_greedy_loop(arch):
    fam.check_generate(fam.decode_pair(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_reference(arch):
    fam.check_init_follows_reference(fam.make_pair(arch))


def _prefill(model, tokens, src):
    return forward_prefill(model, torch.from_numpy(tokens).long(), tokens.shape[1] + 1,
                           torch.from_numpy(src))[0]


def test_vlm_cross_attention_uses_image():
    """With the gate open, the image embeddings change the logits; with
    the gate at its init (0), the cross block adds nothing."""
    cfg, _, _, model, tokens, _ = fam.make_pair("llama-3.2-vision-11b")
    tokens = tokens[:1, :8]
    img1 = np.full((1, cfg.num_image_tokens, cfg.d_model), 0.1, np.float32)
    img1[0, ::3] *= -2.0
    img2 = -img1
    assert not torch.allclose(_prefill(model, tokens, img1), _prefill(model, tokens, img2))
    cross = next(b for b in model.blocks if b.xattn is not None)
    with torch.no_grad():
        cross.xattn["attn_gate"].zero_()
    try:
        assert torch.equal(_prefill(model, tokens, img1), _prefill(model, tokens, img2))
    finally:
        with torch.no_grad():
            cross.xattn["attn_gate"].fill_(2.0)


def test_whisper_encoder_decoder():
    cfg, jcfg, jparams, model, tokens, frames = fam.make_pair("whisper-medium")
    got = encode(model, torch.from_numpy(frames))
    want = jax_encode(jparams, jcfg, jnp.asarray(frames))
    assert got.shape == (fam.B, cfg.encoder_seq_len, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **fam.TOL)
    frames1 = np.full((1, cfg.encoder_seq_len, cfg.d_model), 0.1, np.float32)
    l1 = _prefill(model, tokens[:1, :8], frames1)
    l2 = _prefill(model, tokens[:1, :8], frames1 * -3.0)
    assert l1.shape == (1, 1, cfg.vocab_size)
    assert not torch.allclose(l1, l2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_over_longer_prompt(arch):
    fam.check_decode_matches_prefill(fam.decode_pair(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_with_f32_modality_input(arch):
    """bf16 weights, the modality input in f32 as the reference's serve
    stub makes it. The reference promotes: its encoder and every cross K/V
    run in f32 and its cross caches are f32. The port casts the input to
    the model's dtype first, so they run in bf16 (K2's ``sm90`` route on
    the card) and its cross caches are bf16. The logits agree within
    2e-2 of their largest value, the bf16 bound of the kernel checks."""
    cfg, jcfg, jparams, model, tokens, cross = fam.make_pair(arch, dtype="bfloat16")
    logits, caches, _ = forward_prefill(model, torch.from_numpy(tokens[:, :fam.S]).long(),
                                        fam.S + 1, torch.from_numpy(cross))
    jlogits, jcaches, _ = jax_forward_prefill(jparams, jcfg, jnp.asarray(tokens[:, :fam.S]),
                                              fam.S + 1, jnp.asarray(cross))
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
    assert {c["ck"].dtype for c in caches if "ck" in c} == {torch.bfloat16}
    assert {c["ck"].dtype for c in jcaches if "ck" in c} == {np.dtype("float32")}
    got, want = logits.float().numpy(), np.asarray(jlogits.astype(jnp.float32))
    assert np.isfinite(got).all()
    bound = 2e-2 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= bound
