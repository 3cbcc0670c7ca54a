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
    """kimi-k2 and jamba hold no f32 copy beside the bf16 one: they keep the
    2% check of kernels against plain."""
    served = [arch for arch, _, _ in chip_smoke.SERVED_MODELS]
    assert chip_smoke.WITNESSED == ("olmoe-1b-7b",)
    assert set(chip_smoke.WITNESSED) <= set(served)
