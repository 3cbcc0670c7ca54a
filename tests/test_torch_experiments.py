"""The port's scenario-sweep harness (``repro_torch.experiments``).

Counterpart of ``tests/test_experiments.py``: generation determinism, §6.1
invariants, aggregation math, and end-to-end resume/worker-count
determinism (the port's pool spawns its workers), run on the port. Then the
port against the reference, run live on the same seed-0 specs: specs,
``evaluate_scenario`` on the scalar and numpy batch paths and the CLI's
results document are equal (``==``, wall times aside), and the compiled
batch engine on the CPU (``device="cpu"``) gives the reference's numpy
result. ``RESULTS_sweep.json`` is never the oracle: it predates the
reference's current code and no longer matches it.
"""
import copy
import json
import math
import random

import pytest

from repro_torch.core import base_periods, best_model_times, build_scenario, sample_groups
from repro_torch.core.scoring import deadline_satisfaction
from repro_torch.core import ArrivalSpec
from repro_torch.experiments import (
    METHODS,
    ScenarioResult,
    ScenarioSpec,
    SweepConfig,
    aggregate_results,
    arrival_stream_seed,
    default_context,
    generate_scenario_specs,
    geometric_mean,
    run_sweep,
    scenario_stream_seed,
)
from repro_torch.zoo import MODEL_NAMES

TINY = SweepConfig(pop_size=8, max_generations=6, min_generations=2,
                   bm_max_evals=30)


# -- scenario generation (§6.1) ---------------------------------------------

def test_specs_deterministic_and_prefix_stable():
    a = generate_scenario_specs(6, seed=3)
    b = generate_scenario_specs(6, seed=3)
    assert a == b
    # per-scenario streams: a shorter sweep is a prefix of a longer one
    assert generate_scenario_specs(3, seed=3) == a[:3]
    # a different sweep seed changes the compositions
    c = generate_scenario_specs(6, seed=4)
    assert [s.groups for s in c] != [s.groups for s in a]


def test_stream_seed_stable_across_processes():
    # SHA-256 derivation, not hash(): the value is a constant of (seed, index)
    assert scenario_stream_seed(0, 0) == scenario_stream_seed(0, 0)
    assert scenario_stream_seed(0, 0) != scenario_stream_seed(0, 1)
    assert 0 <= scenario_stream_seed(123, 456) < 2 ** 63


def test_spec_group_invariants():
    for spec in generate_scenario_specs(25, seed=11):
        assert 1 <= len(spec.groups) <= 3
        for group in spec.groups:
            assert 1 <= len(group) <= 4
            assert len(set(group)) == len(group)  # distinct within a group
            assert all(name in MODEL_NAMES for name in group)


def test_sample_groups_uses_only_caller_rng():
    g1 = sample_groups(random.Random(5), MODEL_NAMES)
    random.seed(999)  # global RNG state must be irrelevant
    g2 = sample_groups(random.Random(5), MODEL_NAMES)
    assert g1 == g2


def test_spec_json_roundtrip():
    spec = generate_scenario_specs(1, seed=9)[0]
    wire = json.loads(json.dumps(spec.to_json()))
    assert ScenarioSpec.from_json(wire) == spec


# -- arrival axis (this PR) ---------------------------------------------------

def test_arrival_axis_specs_deterministic():
    base = generate_scenario_specs(4, seed=5)
    poisson = generate_scenario_specs(4, seed=5, arrival="poisson")
    # same compositions, only the traffic changes
    assert [s.groups for s in poisson] == [s.groups for s in base]
    assert all(s.arrival is None for s in base)
    assert all(s.arrival.kind == "poisson" for s in poisson)
    # per-scenario SHA-256 arrival seeds: stable, distinct, independent of
    # the composition stream
    seeds = [s.arrival.seed for s in poisson]
    assert seeds == [arrival_stream_seed(5, i) for i in range(4)]
    assert len(set(seeds)) == 4
    assert generate_scenario_specs(4, seed=5, arrival="poisson") == poisson
    # "periodic" is spelled the old way: no arrival key in the JSON at all,
    # so pre-axis run dirs load (and resume) unchanged
    assert generate_scenario_specs(2, seed=5, arrival="periodic") == base[:2]
    assert "arrival" not in base[0].to_json()


def test_arrival_axis_spec_json_roundtrip():
    for kind, kw in (("poisson", {}),
                     ("jittered", dict(arrival_jitter=0.4)),
                     ("jittered", dict(arrival_jitter=0.2,
                                       arrival_distribution="lognormal"))):
        spec = generate_scenario_specs(2, seed=7, arrival=kind, **kw)[1]
        wire = json.loads(json.dumps(spec.to_json()))
        assert ScenarioSpec.from_json(wire) == spec
        assert isinstance(ScenarioSpec.from_json(wire).arrival, ArrivalSpec)


def test_base_period_follows_section_6_1_formula():
    ctx = default_context()
    spec = generate_scenario_specs(4, seed=2)[3]
    scenario = build_scenario(spec.name, [list(g) for g in spec.groups],
                              ctx.graphs)
    bt = best_model_times(scenario.graphs, ctx.processors, ctx.profiler)
    periods = base_periods(scenario, bt)
    n = len(spec.groups)
    for group, period in zip(scenario.groups, periods):
        expect = sum(min(t for t, _, _ in bt[m].values()) for m in group)
        assert period == pytest.approx(expect * n * 1.1)
        assert period > 0


def test_base_period_scales_with_group_count():
    ctx = default_context()
    one = build_scenario("one", [["face_det", "yolov8n"]], ctx.graphs)
    two = build_scenario(
        "two", [["face_det", "yolov8n"], ["hand_det"]], ctx.graphs)
    bt1 = best_model_times(one.graphs, ctx.processors, ctx.profiler)
    bt2 = best_model_times(two.graphs, ctx.processors, ctx.profiler)
    # φ̄ ∝ N: the same group composition doubles its period in a 2-group scenario
    assert base_periods(two, bt2)[0] == pytest.approx(
        2 * base_periods(one, bt1)[0])


# -- aggregation math --------------------------------------------------------

def _canned(index, alpha, ratios, satisfaction):
    spec = ScenarioSpec(index=index, name=f"c{index}", seed=index,
                        groups=(("face_det",),))
    return ScenarioResult(
        spec=spec, base_periods_s=[0.01],
        alpha_star=dict(alpha), alpha_star_best=dict(alpha),
        ratios=dict(ratios), satisfaction=dict(satisfaction),
        ga_generations=1, ga_evaluations=10, pareto_size=1, wall_s=0.1,
    )


def test_geometric_mean():
    assert geometric_mean([2.0, 8.0]) == pytest.approx(4.0)
    assert geometric_mean([3.0]) == pytest.approx(3.0)
    assert geometric_mean([]) == 0.0
    assert math.isinf(geometric_mean([1.0, float("inf")]))


def test_aggregate_canned_results():
    results = [
        _canned(0, {"puzzle": 1.0, "best_mapping": 2.0, "npu_only": 2.0},
                {"npu_only": 2.0, "best_mapping": 2.0},
                {"puzzle": 1.0, "best_mapping": 0.5, "npu_only": 0.5}),
        _canned(1, {"puzzle": 0.5, "best_mapping": 1.0, "npu_only": 4.0},
                {"npu_only": 8.0, "best_mapping": 2.0},
                {"puzzle": 0.8, "best_mapping": 0.9, "npu_only": 0.1}),
    ]
    agg = aggregate_results(results)
    assert agg["num_scenarios"] == 2
    assert agg["speedup_geomean"]["vs_npu_only"] == pytest.approx(4.0)
    assert agg["speedup_geomean"]["vs_best_mapping"] == pytest.approx(2.0)
    assert agg["speedup_mean"]["vs_npu_only"] == pytest.approx(5.0)
    assert agg["satisfaction_rate"]["puzzle"] == pytest.approx(0.9)
    assert agg["satisfaction_rate"]["npu_only"] == pytest.approx(0.3)
    assert agg["alpha_star"]["puzzle"]["mean_capped"] == pytest.approx(0.75)
    assert agg["alpha_star"]["npu_only"]["median_capped"] == pytest.approx(3.0)


def test_aggregate_caps_unsaturated_alpha():
    results = [
        _canned(0, {"puzzle": 2.0, "best_mapping": float("inf"),
                    "npu_only": float("inf")},
                {"npu_only": 3.0, "best_mapping": 3.0},
                {m: 1.0 for m in METHODS}),
    ]
    agg = aggregate_results(results, alpha_cap=6.0)
    assert agg["alpha_star"]["npu_only"]["mean_capped"] == pytest.approx(6.0)
    assert agg["alpha_star"]["npu_only"]["saturated_fraction"] == 0.0
    assert agg["alpha_star"]["puzzle"]["saturated_fraction"] == 1.0
    # best-convention ratios are capped, never inf
    assert agg["speedup_geomean_best"]["vs_npu_only"] == pytest.approx(3.0)


def test_deadline_satisfaction_pools_requests():
    ms = [[0.5, 1.5], [1.0, 2.0, float("inf")]]
    dl = [1.0, 2.0]
    # hits: 0.5; 1.0, 2.0 → 3 of 5
    assert deadline_satisfaction(ms, dl) == pytest.approx(3 / 5)
    assert deadline_satisfaction([], []) == 0.0
    assert deadline_satisfaction([[]], [1.0]) == 0.0


def test_deadline_satisfaction_rejects_group_mismatch():
    with pytest.raises(ValueError, match="group count mismatch"):
        deadline_satisfaction([[0.5], [0.5]], [1.0])


def test_scenario_result_rejects_nan():
    with pytest.raises(ValueError, match="alpha_star\\[puzzle\\]"):
        _canned(0, {"puzzle": float("nan"), "best_mapping": 2.0,
                    "npu_only": 2.0},
                {"npu_only": 2.0, "best_mapping": 2.0},
                {m: 1.0 for m in METHODS})


# -- end-to-end: resume + worker determinism --------------------------------

def _strip_wall(doc):
    doc = copy.deepcopy(doc)
    for row in doc["scenarios"]:
        row.pop("wall_s")
    doc["aggregate"].pop("total_wall_s")
    return doc


def test_sweep_resume_and_worker_determinism(tmp_path):
    specs = generate_scenario_specs(2, seed=1)
    d1 = tmp_path / "w1"
    doc1 = run_sweep(specs, TINY, run_dir=str(d1), workers=1)
    assert len(doc1["scenarios"]) == 2
    for row in doc1["scenarios"]:
        assert set(row["alpha_star"]) == set(METHODS)

    # per-scenario files landed and round-trip through ScenarioResult
    files = sorted(d1.glob("scenario_*.json"))
    assert len(files) == 2
    reloaded = ScenarioResult.from_json(json.loads(files[0].read_text()))
    assert reloaded.to_json() == doc1["scenarios"][0]

    # resume: a second run reuses the stored results verbatim
    messages = []
    doc2 = run_sweep(specs, TINY, run_dir=str(d1), workers=1,
                     log=messages.append)
    assert doc2 == doc1
    assert any("resumed 2/2" in m for m in messages)

    # fan-out: a 2-worker pool in a fresh dir reproduces everything but wall time
    doc3 = run_sweep(specs, TINY, run_dir=str(tmp_path / "w2"), workers=2)
    assert _strip_wall(doc3) == _strip_wall(doc1)


def test_sweep_arrival_axis_worker_determinism(tmp_path):
    """The arrival axis preserves the sweep's determinism contract:
    ``--workers 2`` reproduces ``--workers 1`` bit for bit, and resuming a
    non-periodic run dir reuses the stored results."""
    specs = generate_scenario_specs(2, seed=4, arrival="poisson")
    doc1 = run_sweep(specs, TINY, run_dir=str(tmp_path / "w1"), workers=1)
    for row in doc1["scenarios"]:
        assert row["spec"]["arrival"]["kind"] == "poisson"
    doc2 = run_sweep(specs, TINY, run_dir=str(tmp_path / "w2"), workers=2)
    assert _strip_wall(doc2) == _strip_wall(doc1)
    # resume path: stored non-periodic scenarios reload (spec match incl.
    # the arrival block)
    messages = []
    doc3 = run_sweep(specs, TINY, run_dir=str(tmp_path / "w1"), workers=1,
                     log=messages.append)
    assert doc3 == doc1
    assert any("resumed 2/2" in m for m in messages)
    # and the traffic actually matters: the periodic sweep of the same
    # compositions yields different results
    doc4 = run_sweep(generate_scenario_specs(2, seed=4), TINY,
                     run_dir=str(tmp_path / "p"), workers=1)
    strip1, strip4 = _strip_wall(doc1), _strip_wall(doc4)
    for row in strip1["scenarios"] + strip4["scenarios"]:
        row.pop("spec")
    assert strip1 != strip4


@pytest.mark.parametrize("arrival", [None, "poisson"])
def test_evaluate_scenario_batch_path_identical(arrival):
    """use_batch routes α*-search + satisfaction through batchsim; the
    per-scenario result must be bit-identical (wall time aside) — under
    periodic and non-periodic arrivals alike (the batch lanes must carry
    the scenario's arrival spec)."""
    from repro_torch.experiments.evaluate import evaluate_scenario

    spec = generate_scenario_specs(2, seed=2025, arrival=arrival)[1]
    kw = dict(pop_size=8, max_generations=4, min_generations=2,
              bm_max_evals=24)
    plain = evaluate_scenario(spec, SweepConfig(**kw)).to_json()
    batched = evaluate_scenario(
        spec, SweepConfig(use_batch=True, **kw)).to_json()
    plain.pop("wall_s")
    batched.pop("wall_s")
    # the configs differ by construction; everything else must not
    assert plain.pop("spec") == batched.pop("spec")
    assert plain == batched


def test_sweep_rejects_config_mismatch(tmp_path):
    specs = generate_scenario_specs(1, seed=1)
    run_sweep(specs, TINY, run_dir=str(tmp_path), workers=1)
    other = SweepConfig(pop_size=6, max_generations=4, min_generations=2,
                        bm_max_evals=20)
    with pytest.raises(RuntimeError, match="different sweep config"):
        run_sweep(specs, other, run_dir=str(tmp_path), workers=1)
    # --force wipes the stale per-scenario results and proceeds
    doc = run_sweep(specs, other, run_dir=str(tmp_path), workers=1, force=True)
    assert len(doc["scenarios"]) == 1


# -- the port against the reference, run live ---------------------------------

import repro.experiments as rx  # noqa: E402
import repro_torch.core.batchsim_compiled as bsc  # noqa: E402
from repro.experiments import sweep as ref_sweep  # noqa: E402
from repro_torch.experiments import evaluate_scenario, sweep  # noqa: E402

PARITY = dict(pop_size=8, max_generations=4, min_generations=2, bm_max_evals=24)


def _no_wall(doc):
    doc = dict(doc)
    doc.pop("wall_s")
    return doc


@pytest.mark.parametrize("arrival", [None, "poisson", "jittered"])
def test_specs_equal_reference(arrival):
    got = generate_scenario_specs(8, seed=0, arrival=arrival)
    want = rx.generate_scenario_specs(8, seed=0, arrival=arrival)
    assert [s.to_json() for s in got] == [s.to_json() for s in want]


@pytest.mark.parametrize("index,use_batch", [(0, False), (1, False), (2, False),
                                             (0, True), (1, True)])
def test_evaluate_scenario_equals_reference(index, use_batch):
    """The first three seed-0 specs on the scalar path and the first two on
    the numpy batch path: every α*, ratio, satisfaction and GA count equals
    the reference's."""
    spec = generate_scenario_specs(3, seed=0)[index]
    ref_spec = rx.generate_scenario_specs(3, seed=0)[index]
    got = evaluate_scenario(spec, SweepConfig(use_batch=use_batch, **PARITY))
    want = rx.evaluate_scenario(ref_spec, rx.SweepConfig(use_batch=use_batch, **PARITY))
    assert _no_wall(got.to_json()) == _no_wall(want.to_json())


def test_evaluate_scenario_compiled_cpu_equals_reference():
    """``batch_engine="compiled"`` with ``device="cpu"`` (the kernel's plain
    pass) on seed-0 spec 0 gives the reference's numpy-batch result."""
    spec = generate_scenario_specs(1, seed=0)[0]
    config = SweepConfig(use_batch=True, batch_engine="compiled", **PARITY)
    before = dict(bsc.fallbacks)
    got = evaluate_scenario(spec, config, default_context("cpu"))
    assert bsc.fallbacks == before and bsc.last_stats["fallback"] is False
    want = rx.evaluate_scenario(rx.generate_scenario_specs(1, seed=0)[0],
                                rx.SweepConfig(use_batch=True, **PARITY))
    got, want = _no_wall(got.to_json()), _no_wall(want.to_json())
    assert got.pop("spec") == want.pop("spec")
    assert got == want


def test_compiled_engine_needs_a_device_only_when_chosen(monkeypatch):
    """The device is resolved only for the compiled engine: without a card
    the numpy path runs and the compiled path raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = generate_scenario_specs(1, seed=0)[0]
    evaluate_scenario(spec, SweepConfig(use_batch=True, **PARITY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_scenario(spec, SweepConfig(use_batch=True, batch_engine="compiled",
                                            **PARITY))


def test_sweep_cli_equals_reference(tmp_path, capsys):
    """``python -m repro_torch.experiments.sweep`` and the reference's CLI on
    the same arguments write equal results documents."""
    args = ["--scenarios", "2", "--seed", "0", "--pop-size", "8", "--max-generations", "4",
            "--min-generations", "2", "--bm-evals", "24", "--use-batch"]
    docs = []
    for main, tag in ((sweep.main, "port"), (ref_sweep.main, "ref")):
        out = tmp_path / f"{tag}.json"
        assert main(args + ["--run-dir", str(tmp_path / tag), "--out", str(out)]) == 0
        doc = _strip_wall(json.loads(out.read_text()))
        doc["meta"].pop("wall_s")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert "frequency gain" in capsys.readouterr().out
