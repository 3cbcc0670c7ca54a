"""Every full and smoke config of the port equals the JAX package's."""
import dataclasses

import pytest

from repro import configs as jax_configs
from repro_torch import configs

ARCHS = sorted(jax_configs.ALIASES)


def test_arch_tables_match():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert configs.ALIASES == jax_configs.ALIASES


@pytest.mark.parametrize("arch", ARCHS)
def test_full_and_smoke_configs_match(arch):
    for get, jax_get in ((configs.get_config, jax_configs.get_config),
                         (configs.get_smoke_config, jax_configs.get_smoke_config)):
        got, want = get(arch), jax_get(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.resolved_head_dim == want.resolved_head_dim


def test_qwen3_14b_full_width():
    cfg = configs.get_config("qwen3-14b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads) == (40, 5120, 40, 8)
    assert (cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == (128, 17408, 151936)
    assert cfg.param_count() == 14_768_291_840
