"""The mesh paths' per-device bodies on the card at a reduced width: the
two checks of ``chip_smoke.py``'s ``moe_mesh`` phase.

Imports no JAX: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_moe_mesh_cuda.py``. Without a card every case skips.

- ``moe_device_body`` for each rank of a 2×2 and a 1×2 layout
  (``chip_smoke.moe_mesh_check``, rank by rank on the card, the collectives'
  results formed in the process) against ``moe_ffn`` on the whole batch,
  with the ranks' expert choices: the kept assignments and slots equal,
  the output within ``chip_smoke.TOL`` of the largest output in bf16 and
  in f32, at a capacity that drops assignments too;
- ``decode_device_body`` over 16 sequence pieces of a cache
  (``chip_smoke.decode_cp_check``) against ``decode_attention`` on the
  whole cache, in bf16 and f32, over ``chip_smoke.CP_CASES``.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", [(2, 2, 1), (1, 2, 1)])
def test_moe_mesh_body_on_the_card(layout, dtype, cf):
    rec = chip_smoke.moe_mesh_check(16, 4, 256, 192, 4, 128, getattr(torch, dtype),
                                    dict(zip(("batch", "experts", "slots"), layout)), "cuda",
                                    cf=cf)
    assert rec["plan_equal"] and rec["ranks_agree"], rec
    assert rec["max_abs_err"] <= chip_smoke.TOL[dtype]["atol"] * rec["max_abs_out"], rec
    if cf < 1:
        assert rec["dropped"] > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_cp_on_the_card(dtype):
    for c in chip_smoke.decode_cp_check(8, 2, 64, 4, 256, 16, chip_smoke.CP_CASES[1:] + (
            (256, None),), getattr(torch, dtype), "cuda"):
        assert c["max_abs_err"] <= chip_smoke.TOL[dtype]["atol"] * c["max_abs_out"], c
