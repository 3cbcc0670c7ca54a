"""``chip_smoke.py``'s depth_check decision for olmoe-1b-7b against an f32
witness (``witness_verdict``), on the CPU from given distances.

Each distance is the largest absolute logit difference over the largest
logit of the bf16 plain prefill. The draws are eight measured on an H100
(``examples/depth_margin_torch.py``, draws 0-7): the bf16 kernels against
the f32 witness, the bf16 plain path against it, the f32 kernels against it.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# (kernel_vs_f32, plain_vs_f32, f32_kernel_vs_plain), draws 0-7
DRAWS = [(0.018693, 0.017665, 3.79e-6), (0.015971, 0.015822, 3.07e-6),
         (0.016106, 0.017068, 2.95e-6), (0.014982, 0.018833, 3.63e-6),
         (0.022423, 0.024636, 3.27e-6), (0.020903, 0.018079, 2.65e-6),
         (0.015774, 0.015316, 2.79e-6), (0.017239, 0.018601, 3.68e-6)]


@pytest.mark.parametrize("draw", DRAWS)
def test_the_measured_draws_pass(draw):
    """Every measured draw passes, the two whose kernels lie over 2% from the
    f32 witness included (draws 4 and 5)."""
    assert chip_smoke.witness_verdict(*draw)


@pytest.mark.parametrize("kernel,plain,f32,ok", [
    (0.0250, 0.0200, 3e-6, True),       # within the margin of the plain path's distance
    (0.0251, 0.0200, 3e-6, False),      # past it: the kernels lie further than bf16 explains
    (0.0100, 0.0200, 1e-4, True),       # the f32 check at its tolerance
    (0.0100, 0.0200, 1.01e-4, False),   # past it: a fault of the kernels or the MoE path
    (0.0600, 0.0100, 0.0, False),       # a bf16 fault with exact f32 kernels
])
def test_the_decision_at_its_limits(kernel, plain, f32, ok):
    assert chip_smoke.WITNESS_F32_TOL == 1e-4 and chip_smoke.WITNESS_MARGIN == 5e-3
    assert chip_smoke.witness_verdict(kernel, plain, f32) is ok


def test_only_the_moe_model_that_fits_twice_has_a_witness():
    """olmoe and jamba are held to the f32 witness; kimi-k2 keeps the 2%
    check of kernels against plain (its 8 draws stayed under it). jamba's
    cut fits twice only because its witness shares the bf16 experts
    (``witness_model``)."""
    served = [arch for arch, _, _ in chip_smoke.SERVED_MODELS]
    assert chip_smoke.WITNESSED == ("olmoe-1b-7b", "jamba-1.5-large-398b")
    assert set(chip_smoke.WITNESSED) <= set(served)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b"])
def test_the_witness_is_the_same_weights_in_f32(arch):
    """``witness_model`` of a bf16 smoke model keeps the expert tensors
    themselves (no copy) and every other tensor as an f32 copy; its prefill, with the expert choices pinned, equals the
    prefill of a whole f32 copy of the model within f32 rounding (bf16 to
    f32 is exact, and each expert is cast only while its products run)."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import forward_prefill, init_params
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    model = init_params(cfg, seed=0, device="cpu")
    witness = chip_smoke.witness_model(model)
    moe = [(b.moe, w.moe) for b, w in zip(model.blocks, witness.blocks) if b.moe is not None]
    assert moe
    for ours, theirs in moe:
        for name in ("w_gate", "w_up", "w_down"):
            assert theirs[name].dtype == torch.bfloat16
            assert theirs[name].data_ptr() == ours[name].data_ptr()
        assert theirs["router"].dtype == torch.float32
    others = [p for n, p in witness.named_parameters()
              if ".moe." not in n or n.endswith("router")]
    assert others and all(p.dtype == torch.float32 for p in others)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    chosen = []
    with torch.inference_mode():
        with chip_smoke.routing("record", chosen):
            forward_prefill(model, tokens, 17)
        with chip_smoke.routing("replay", list(chosen)):
            got = forward_prefill(witness, tokens, 17)[0]
        with chip_smoke.routing("replay", list(chosen)):
            want = forward_prefill(copy.deepcopy(model).float(), tokens, 17)[0]
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
