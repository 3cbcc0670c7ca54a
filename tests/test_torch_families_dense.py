"""Serve-path parity with the JAX package for the dense and Mamba2 smoke
configs (f32, ``_families``): prefill logits and every cache tensor,
teacher-forced decode, greedy ``generate``, and ``init_params`` against
the reference's initialisation. minitron-4b, phi4-mini-3.8b and
qwen2.5-32b (QKV bias) are held here."""
import pytest

import _families as fam

ARCHS = ["qwen3-14b", "mamba2-1.3b", "minitron-4b", "phi4-mini-3.8b", "qwen2.5-32b"]


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
def test_decode_matches_prefill_over_longer_prompt(arch):
    fam.check_decode_matches_prefill(fam.decode_pair(arch))
