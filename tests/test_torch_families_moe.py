"""Serve-path parity with the JAX package for the MoE and hybrid smoke
configs, olmoe-1b-7b, kimi-k2 and jamba (f32, ``_families``). Prefill runs
at the default capacity factor, where tokens are dropped; decode and
``generate`` at 16, as the reference's decode test does."""
import numpy as np
import pytest
import torch

import _families as fam
from repro_torch.models import forward_prefill

ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"]


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


@pytest.mark.parametrize("arch", ARCHS)
def test_two_prefills_give_the_same_bits(arch):
    cfg, _, _, model, tokens, _ = fam.make_pair(arch)
    tok = torch.from_numpy(tokens[:, :fam.S]).long()
    first = forward_prefill(model, tok, fam.S + 1)[0]
    second = forward_prefill(model, tok, fam.S + 1)[0]
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert np.isfinite(first.numpy()).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_over_longer_prompt(arch):
    fam.check_decode_matches_prefill(fam.decode_pair(arch))
