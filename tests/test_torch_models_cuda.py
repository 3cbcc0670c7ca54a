"""The served model families on the card, at their smoke widths in bf16:
the prefill through the kernels against the same prefill with the kernels'
plain versions (with the same expert choices), the launches the config gives, and an MoE model's prefill
equal bit for bit when run twice (the deterministic combine).

Imports no JAX: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_models_cuda.py``. Without a card every case skips.

The expert-choice pin (``routing``) and the launches a config gives
(``expected_launches``) are ``chip_smoke.py``'s own, so the two checks
cannot drift apart.
"""
import dataclasses
import importlib.util
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention_plain, ssd_scan_plain
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch.serve import stub_cross_src
from repro_torch.models import forward_prefill, init_params

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b", "whisper-medium",
         "llama-3.2-vision-11b"]
B, S = 2, 64


def _model(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    model = init_params(cfg, seed=0, device="cuda")
    for blk in model.blocks:
        if blk.xattn is not None:
            blk.xattn["attn_gate"].fill_(2.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    stub = stub_cross_src(cfg, B, torch.device("cuda"))
    cross = None if stub is None else torch.randn(stub.shape, generator=gen, device="cuda")
    return cfg, model, tokens, cross


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_through_kernels_matches_plain(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, model, tokens, cross = _model(arch)
    ops = importlib.import_module("repro_torch.kernels.ops")
    launches = chip_smoke.expected_launches(cfg)
    before = flash_attention.launches, ssd_scan.launches
    chosen = []
    with torch.inference_mode():
        with chip_smoke.routing("record", chosen):
            got = forward_prefill(model, tokens, S + 1, cross)[0].float()
        torch.cuda.synchronize()
        assert (flash_attention.launches - before[0], ssd_scan.launches - before[1]) == (
            launches["flash_attention"], launches["ssd_scan"])
        with mock.patch.object(ops, "flash_attention", flash_attention_plain), \
                mock.patch.object(ops, "ssd_scan", ssd_scan_plain), \
                chip_smoke.routing("replay", chosen):
            want = forward_prefill(model, tokens, S + 1, cross)[0].float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b"])
def test_moe_prefill_gives_the_same_bits_twice(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, model, tokens, cross = _model(arch)
    with torch.inference_mode():
        first, second = (forward_prefill(model, tokens, S + 1, cross)[0] for _ in range(2))
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
