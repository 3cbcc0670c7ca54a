"""``examples/depth_margin_torch.py`` on the CPU at the smoke configs: it runs
through every column, and on the CPU, where each kernel takes its plain
version, the kernels' prefill equals the plain one bit for bit. In an f32
smoke config the f32 witness is the same computation, so every column is
0."""
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _probe():
    spec = importlib.util.spec_from_file_location(
        "depth_margin_torch", ROOT / "examples" / "depth_margin_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b"])
def test_depth_margin_runs_on_the_cpu(arch, tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    assert _probe().main(["--arch", arch, "--device", "cpu", "--smoke", "--draws", "2",
                          "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["draw"] for r in rows[:-1]] == [0, 1]
    summary = rows[-1]
    assert summary["draws"] == 2 and summary["over_limit"] == 0
    for key in ("kernel_vs_plain", "kernel_vs_f32", "plain_vs_f32", "f32_kernel_vs_plain"):
        assert summary[key] == [0.0, 0.0]
    assert all(r["max_abs_logit"] > 0 for r in rows[:-1])


def test_depth_margin_needs_a_card_unless_told_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _probe().main(["--draws", "1"]) == 2
