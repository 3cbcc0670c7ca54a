"""The port's ``simspeed`` section against the reference's, run live on the CPU.

The reference's section stops at ``benchmarks/run.py:462``: its
generation-batched leg asserts the per-solution objectives equal the
batch's bit for bit, and Python 3.12 sums the group means in two ways (R2,
ROADMAP Queue 3). That failure is pinned here, and the rows it printed
before it (legs 1–5: engine parity, grid vs bisection α*, the end-to-end α*
and evaluation counts) are compared with the port's. The port's legs 6–6c
are held by the section itself, and checked here: the batch passes against
the per-solution loop under R2's contract (n ulps of a mean for n
requests), the compiled tier (its plain pass on the CPU) against
``FastSimulator`` and ``BatchSimulator`` within
``COMPILED_REL_TOL``/``COMPILED_ABS_TOL``, with no fallback.
"""
import contextlib
import io
import json
import math

import pytest

from _paper_harness import (CPU, capture, fields, named, parse, reference_harness,
                            section_args, single_thread)
from _paper_harness import one_thread  # noqa: F401  (autouse fixture)
from repro_torch.core import COMPILED_ABS_TOL, COMPILED_REL_TOL
from repro_torch.experiments import paper

REF = reference_harness()
GENERATION = 6          # parents; as many offspring (the reference's: 40)
LANES = 8               # the compiled crossover leg's lanes (the reference's: 80)

# legs 1-5: the derived fields that hold no time
DETERMINISTIC = {
    "simspeed.parity": ("max_makespan_diff", "ok"),
    "simspeed.alpha_star_grid": ("alpha_star", "evals"),
    "simspeed.alpha_star_bisect": ("alpha_star", "evals", "agrees"),
    "simspeed.e2e_seed_path": ("alpha_star", "ga_evals"),
    "simspeed.e2e_fast_path": ("alpha_star", "ga_evals"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        with pytest.raises(AssertionError, match="batch parity violated"):
            REF.bench_simspeed(section_args("simspeed"))
    ref = parse(out.getvalue())
    out_dir = tmp_path_factory.mktemp("paper_torch")
    with single_thread():
        port, record = capture(paper.bench_simspeed, section_args("simspeed", json=True), CPU,
                               generation=GENERATION, crossover_lanes=LANES,
                               out_dir=str(out_dir))
    return ref, port, record, out_dir


def test_reference_stops_at_r2_after_legs_1_to_5(runs):
    ref, _, _, _ = runs
    assert [r[0] for r in ref] == [
        "simspeed.parity", "simspeed.eval_reference", "simspeed.eval_fastsim",
        "simspeed.score_per_alpha_reference", "simspeed.score_per_alpha_fastsim",
        "simspeed.alpha_star_grid", "simspeed.alpha_star_bisect",
        "simspeed.e2e_seed_path", "simspeed.e2e_fast_path"]


@pytest.mark.parametrize("row", sorted(DETERMINISTIC))
def test_legs_1_to_5_equal_reference(runs, row):
    ref, port, _, _ = runs
    want, got = fields(named(ref)[row][1]), fields(named(port)[row][1])
    assert {k: got[k] for k in DETERMINISTIC[row]} == {k: want[k] for k in DETERMINISTIC[row]}


def test_legs_1_to_5_print_the_reference_rows_first(runs):
    ref, port, _, _ = runs
    assert [r[0] for r in port[:len(ref)]] == [r[0] for r in ref]
    assert fields(named(port)["simspeed.parity"][1]) == {"max_makespan_diff": "0.000e+00",
                                                        "ok": "True"}


def test_batch_leg_holds_r2_contract(runs):
    _, port, record, _ = runs
    got = named(port)["simspeed.pop_eval_batch"][1]
    ulps = float(got.split("r2_max_ulps=")[1].split(" ")[0])
    assert record["batch_r2_max_ulps"] == ulps <= 12 and record["batch_parity_ok"]
    assert named(port)["simspeed.pop_eval_per_solution"][1].startswith(
        f"{2 * GENERATION}-candidate generation")


def test_compiled_legs_within_tolerance_without_fallback(runs):
    _, port, record, _ = runs
    for row in ("simspeed.pop_eval_batch_compiled", "simspeed.compiled_crossover"):
        got = fields(named(port)[row][1])
        assert got["launches"] == "0"            # the plain pass: no kernel on the CPU
        assert "B1 on cpu" in named(port)[row][1]
        diff = float(got["max_diff"])
        assert 0.0 <= diff <= COMPILED_ABS_TOL + COMPILED_REL_TOL * 10.0
        assert float(got["cold_us"]) > 0
    assert record["compiled_fallbacks"] == {"collect-tasks": 0, "queue-bound": 0}
    assert record["compiled_launches"] == 0


def test_saturation_leg_and_json_record(runs):
    _, port, record, out_dir = runs
    assert {"simspeed.pop_alpha_star_per_solution", "simspeed.pop_alpha_star_batch"} <= \
        set(named(port))
    written = json.loads((out_dir / "BENCH_simspeed.json").read_text())
    assert written["device"] == {"type": "cpu"}
    assert written["alpha_star_grid"] == written["alpha_star_bisect"] == record["alpha_star_grid"]
    assert written["e2e_alpha_star"] == record["e2e_alpha_star"]
    assert math.isfinite(written["eval_us_batch_compiled"])
    assert named(port)["simspeed.json"][1] == str(out_dir / "BENCH_simspeed.json")


def test_r2_bound_rejects_a_gap_past_n_ulps():
    a = [[1.0, 2.0]]
    assert paper._r2_ulps(a, [[1.0 + 3 * math.ulp(1.0), 2.0]], 3) == 3
    with pytest.raises(AssertionError, match="R2"):
        paper._r2_ulps(a, [[1.0 + 4 * math.ulp(1.0), 2.0]], 3)
    with pytest.raises(AssertionError, match="R2"):
        paper._r2_ulps(a, [[1.0, 2.0 + math.ulp(2.0)]], 3)      # a p90 must be equal
