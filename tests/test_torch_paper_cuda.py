"""The paper harness's card paths: ``simspeed``'s compiled legs on B1
(``kernels/csrc/batchsim_advance.cu``) and the ``kernels`` section's K1, K2
and K3 rows.

Imports no JAX and nothing of the JAX package, so it runs where only
PyTorch is installed: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_paper_cuda.py``. Without a card every case skips.
"""
import argparse

import pytest
import torch

from repro_torch.experiments import paper
from repro_torch.kernels.flash_attention import _route as attention_route
from repro_torch.kernels.ssd_scan import _route as ssd_route

pytestmark = pytest.mark.cuda

ARGS = argparse.Namespace(section=None, only=None, full=False, smoke=True, json=False)
# chip_smoke.py's TOL / SSD_TOL; K1 exact
TOL = {("flash_attention", "float32"): dict(rtol=2e-5, atol=2e-5),
       ("flash_attention", "bfloat16"): dict(rtol=2e-2, atol=2e-2),
       ("ssd_scan", "float32"): dict(rtol=2e-4, atol=2e-4),
       ("ssd_scan", "bfloat16"): dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_simspeed_compiled_legs_launch_b1_without_fallback(card, capsys):
    from repro_torch.kernels.batchsim_advance import batchsim_advance
    before = batchsim_advance.launches
    record = paper.bench_simspeed(ARGS, card, generation=8, crossover_lanes=16)
    rows = capsys.readouterr().out
    assert record["compiled_launches"] > 0
    assert batchsim_advance.launches - before == record["compiled_launches"]
    assert record["compiled_fallbacks"] == {"collect-tasks": 0, "queue-bound": 0}
    assert record["device"]["type"] == "cuda" and record["device"]["nvidia_smi"]
    assert "B1 on cuda" in rows
    assert record["alpha_star_grid"] == record["alpha_star_bisect"]


def test_kernels_rows_match_plain_on_their_routes(card, capsys):
    rows = paper.bench_kernels(ARGS, card)
    capsys.readouterr()
    want = {"kernels.flash_attention": attention_route(torch.float32, 128),
            "kernels.flash_attention.bf16": attention_route(torch.bfloat16, 128),
            "kernels.ssd_scan": ssd_route(torch.float32, 64, 32, 32),
            "kernels.ssd_scan.bf16": ssd_route(torch.bfloat16, 64, 32, 32)}
    assert [r["name"] for r in rows] == [*want, "kernels.quantize_int8"]
    for row in rows:
        assert row["launches"] > 0, row["name"]
        if row["name"] in want:
            assert row["route"] == want[row["name"]]
            kernel = row["name"].split(".")[1]
            for got, plain in row["outputs"]:
                assert torch.allclose(got.float(), plain.float(),
                                      **TOL[(kernel, row["dtype"])]), row["name"]
        else:
            assert row["route"] in ("sm90", "simt")
            assert all(torch.equal(got, plain) for got, plain in row["outputs"])
    assert {r["route"] for r in rows[:2]} == {"simt", "sm90"}
    assert {r["route"] for r in rows[2:4]} == {"simt", "sm90"}
