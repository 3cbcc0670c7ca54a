"""The four ported examples (``examples/*_torch.py``) on the CPU at their
smallest sizes, against the reference's examples where the output is
deterministic, and the harness's device rule.

``quickstart_torch`` prints the reference's schedule and α* line for line;
``sweep_small_torch`` its per-scenario α* table and summary.
``serve_multimodel_torch`` and ``device_in_loop_torch`` execute the zoo
networks (channels 4, spatial 8, the reference's reduced models); the
latter's virtual-clock trace differs from the simulator's by 0 and its
trace file is the port's own.
"""
import importlib.util
import json
import tempfile

import pytest
import torch

from _paper_harness import ROOT
from _paper_harness import one_thread  # noqa: F401  (autouse fixture)
from repro_torch.experiments import paper

SMALL = ["--device", "cpu", "--channels", "4", "--spatial", "8"]


def _example(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_equals_reference(capsys):
    _example("quickstart").main()
    want = capsys.readouterr().out
    _example("quickstart_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and "Puzzle sustains" in got


def test_sweep_small_equals_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _example("sweep_small").main()
    want = capsys.readouterr().out
    doc = _example("sweep_small_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out

    def stable(text):       # the log lines carry seconds; the run dir differs
        return [line for line in text.splitlines()
                if not line.startswith("[") and "run dir" not in line]
    assert stable(got) == stable(want)
    assert len(doc["scenarios"]) == 3


def test_serve_multimodel_serves_both_groups(capsys):
    _example("serve_multimodel_torch").main(SMALL)
    out = capsys.readouterr().out
    assert "group 0: mean makespan" in out and "group 1: mean makespan" in out
    assert "runtime stats:" in out


def test_device_in_loop_trace_diff_is_zero(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    got = _example("device_in_loop_torch").main(SMALL)
    path = tmp_path / "results" / "conformance_trace_torch.json"
    capsys.readouterr()
    assert got["trace_diff"] == 0.0 and got["tasks"] > 0
    assert got["profile_updates"] > 0 and got["moved"] > 0 and got["in_search_rounds"] > 0
    trace = json.loads(path.read_text())
    assert trace["passed"] is True


@pytest.mark.parametrize("example", ["quickstart_torch", "serve_multimodel_torch",
                                     "device_in_loop_torch", "sweep_small_torch"])
def test_examples_and_harness_need_a_card_unless_told_cpu(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(example).main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper.main(["table2"])
