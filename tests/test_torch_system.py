"""End-to-end behaviour of the Puzzle system in the port (paper §6 protocol,
reduced): the counterpart of ``tests/test_system.py``, its analyzer held to the
reference's on the same scenario."""
import pytest

from repro_torch.core import (
    AnalyzerConfig,
    GAConfig,
    PAPER_COMM_MODEL,
    Profiler,
    StaticAnalyzer,
    TableBackend,
    build_scenario,
    decode_solution,
    mobile_processors,
    random_scenarios,
)
from repro_torch.core.profiler import AnalyticMobileBackend
from repro_torch.zoo import MODEL_NAMES, all_cost_graphs, paper_profile_tables


@pytest.fixture(scope="module")
def analyzer():
    graphs = all_cost_graphs()
    procs = mobile_processors()
    backend = TableBackend(
        processors=procs, tables=paper_profile_tables(),
        fallback=AnalyticMobileBackend(procs),
    )
    prof = Profiler(backend)
    scen = build_scenario(
        "e2e",
        [["face_det", "selfie_seg", "yolov8n", "fast_scnn", "pose_det", "hand_det"]],
        graphs,
    )
    cfg = AnalyzerConfig(ga=GAConfig(pop_size=16, max_generations=14, min_generations=6, seed=7))
    return StaticAnalyzer(scen, procs, prof, PAPER_COMM_MODEL, cfg)


def test_base_periods_formula(analyzer):
    # φ̄ = Σ min_p τ_p(m) × N × 1.1 with N=1
    s = sum(min(t for t, _, _ in bt.values()) for bt in analyzer.best_times)
    assert analyzer.base_periods[0] == pytest.approx(s * 1.1)


def test_npu_only_baseline_structure(analyzer):
    sol = analyzer.npu_only()
    placed = decode_solution(sol, analyzer.scenario.graphs)
    for plist in placed:
        assert len(plist) == 1           # un-partitioned
        assert plist[0].processor == 2   # NPU


def test_best_mapping_no_partitioning(analyzer):
    sols = analyzer.best_mapping(max_evals=40)
    assert sols
    for sol in sols:
        placed = decode_solution(sol, analyzer.scenario.graphs)
        assert all(len(p) == 1 for p in placed)


def test_ga_improves_over_npu_only(analyzer):
    res = analyzer.run_ga()
    assert res.pareto
    npu_obj = analyzer.objectives(analyzer.npu_only())
    best = min(res.pareto, key=lambda s: s.fitness[0])
    assert best.fitness[0] <= npu_obj[0]


def test_saturation_ordering_puzzle_vs_npu(analyzer):
    """The paper's headline: Puzzle sustains higher request frequency
    (lower α*) than NPU Only."""
    res = analyzer.run_ga()
    pz = analyzer.median_saturation(res.pareto)
    npu = analyzer.saturation(analyzer.npu_only()).alpha_star
    assert pz < npu
    assert pz < 2.0  # sane absolute range (paper: 0.78±0.08)


def test_score_monotone_in_alpha_roughly(analyzer):
    sol = analyzer.npu_only()
    s_tight = analyzer.score(sol, 0.4, measured=False)
    s_loose = analyzer.score(sol, 3.0, measured=False)
    assert s_loose >= s_tight


def test_random_scenarios_shapes():
    single = random_scenarios(MODEL_NAMES, count=10, models_per_scenario=6, num_groups=1)
    multi = random_scenarios(MODEL_NAMES, count=10, models_per_scenario=6, num_groups=2)
    assert len(single) == 10 and len(multi) == 10
    for s in single:
        assert len(s) == 1 and len(s[0]) == 6
        assert len(set(s[0])) == 6  # no duplicate models within scenario
    for s in multi:
        assert len(s) == 2 and all(len(g) == 3 for g in s)



def _analyzer(core, zoo, backend):
    procs = core.mobile_processors()
    prof = core.Profiler(core.TableBackend(processors=procs, tables=zoo.paper_profile_tables(),
                                           fallback=backend(procs)))
    scen = core.build_scenario(
        "e2e",
        [["face_det", "selfie_seg", "yolov8n", "fast_scnn", "pose_det", "hand_det"]],
        zoo.all_cost_graphs(),
    )
    cfg = core.AnalyzerConfig(ga=core.GAConfig(pop_size=16, max_generations=14,
                                               min_generations=6, seed=7))
    return core.StaticAnalyzer(scen, procs, prof, core.PAPER_COMM_MODEL, cfg)


def test_search_and_saturation_equal_reference():
    """The same protocol on a fresh analyzer in each package: the GA's
    front, its median α* and NPU Only's α* are equal (``==``)."""
    import repro.core as rc
    import repro.zoo as rz
    import repro_torch.core as tc
    import repro_torch.zoo as tz
    from repro.core.profiler import AnalyticMobileBackend as RefAnalytic

    port = _analyzer(tc, tz, AnalyticMobileBackend)
    ref = _analyzer(rc, rz, RefAnalytic)
    got, want = port.run_ga(), ref.run_ga()
    assert [s.fitness for s in got.pareto] == [s.fitness for s in want.pareto]
    assert port.median_saturation(got.pareto) == ref.median_saturation(want.pareto)
    assert (port.saturation(port.npu_only()).alpha_star
            == ref.saturation(ref.npu_only()).alpha_star)
