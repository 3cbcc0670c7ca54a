"""The port's paper harness against the reference's ``benchmarks/run.py``,
run live on the CPU: the prescreen, conformance, sweep, arrivals and faults
sections.

Each case runs both sections with the same arguments (smoke sizing, as the
reference's CI targets) and compares every deterministic ``derived`` field
exactly: evaluation, prune and probe counts, the conformance diff and task
count, each scenario's α* per method, the aggregates and satisfaction, the
fault runs' deadlines, drops, remaps and retries, and ``score_under_faults``.
"""
import json

import pytest

from _paper_harness import CPU, capture, fields, named, reference_harness, section_args
from _paper_harness import one_thread  # noqa: F401  (autouse fixture)
from repro_torch.experiments import paper

REF = reference_harness()

# rows whose derived field holds a time (compared by name only)
TIMED = {"conformance.virtual_runtime_replay"}


def _pair(section, **kw):
    args = section_args(section, **kw)
    ref, _ = capture(REF.SECTIONS[section], args)
    port, value = capture(paper.SECTIONS[section], args, CPU)
    return ref, port, value


def _assert_rows_equal(ref, port):
    assert [r[0] for r in port] == [r[0] for r in ref]
    for (name, _, d_ref), (_, _, d_port) in zip(ref, port, strict=True):
        if name not in TIMED:
            assert d_port == d_ref, name


@pytest.mark.parametrize("section", ["sweep", "arrivals", "faults"])
def test_section_equals_reference(section):
    ref, port, _ = _pair(section)
    _assert_rows_equal(ref, port)
    assert len(port) >= 6


def test_sweep_is_deterministic_and_at_smoke_size():
    _, port, _ = _pair("sweep")
    rows = named(port)
    assert rows["sweep.deterministic"][1] == "ok=True"
    assert sum(n.startswith("sweep.sweep_s2025_") for n in rows) == 2


def test_conformance_zero_diff_equals_reference():
    ref, port, _ = _pair("conformance")
    _assert_rows_equal(ref, port)
    got = fields(named(port)["conformance.zero_diff"][1])
    assert got["ok"] == "True" and got["max_abs_diff"] == "0.0" and int(got["tasks"]) > 0


def test_conformance_full_size_replays_24_requests():
    _, port, _ = _pair("conformance", smoke=False)
    assert named(port)["conformance.fastsim_replay"][1] == "requests=24"


def test_prescreen_equals_reference_and_writes_its_record(tmp_path):
    """Evaluations, prunes, probes and ``false_prunes`` 0 equal the
    reference's; ``--json`` writes the port's own record, never the
    reference's root file, with the device it ran on."""
    args = section_args("prescreen", json=True)
    ref, _ = capture(REF.SECTIONS["prescreen"], section_args("prescreen"))
    port, record = capture(paper.bench_prescreen, args, CPU, out_dir=str(tmp_path))
    _assert_rows_equal(ref, [r for r in port if r[0] != "prescreen.json"])
    assert named(port)["prescreen.false_prunes"][1] == "0 (gate: 0)"
    written = json.loads((tmp_path / "BENCH_prescreen.json").read_text())
    assert written["device"] == {"type": "cpu"}
    assert written["constrained"]["prescreen_false_prunes"] == 0
    assert written["constrained"]["prescreen_stats"] == record["constrained"]["prescreen_stats"]
    assert named(port)["prescreen.json"][1] == str(tmp_path / "BENCH_prescreen.json")


def test_faults_full_size_stops_where_the_reference_stops():
    """R5 (ROADMAP Queue 3): selected explicitly without ``--smoke`` (16
    requests a group), the clean virtual run drops a request at the base
    periods, and the deadline calibration takes ``max`` over its ``None``
    makespan. The port keeps the reference's code, so both stop there."""
    args = section_args("faults", smoke=False)
    for fn in (lambda: REF.bench_faults(args), lambda: paper.bench_faults(args, CPU)):
        with pytest.raises(TypeError, match="NoneType"):
            capture(fn)
