"""The port's GA, baselines and scenario functions against the JAX package's.

With the same ``GAConfig`` and seed, ``GeneticScheduler.run`` through the
port's ``StaticAnalyzer`` returns the reference's ``GAResult``: Pareto
chromosomes and fitness, history, generations, evaluation count, oracle
drift. NPU Only and Best Mapping pick the same solutions, and the scenario
functions draw the same compositions. Tolerance: none (``==``). GA cases stay
at ``pop_size`` ≤ 10 and ``max_generations`` ≤ 6 (the recipe of
``tests/test_ga_determinism.py``).
"""
import random

import pytest

import repro.core as rc
import repro.zoo as rz
import repro_torch.core as tc
import repro_torch.zoo as tz
from test_torch_sched_inputs import PKGS, analyzer, procs_and_profiler


def _fingerprint(result):
    return (
        result.history,
        [s.key() for s in result.pareto],
        [s.fitness for s in result.pareto],
        result.generations,
        result.evaluations,
        result.oracle_drift,
        result.device_updates,
        result.prescreen_stats,
    )


GA_CASES = {
    "seed3": dict(seed=3),
    "seed4": dict(seed=4),
    "batch_eval": dict(seed=3, batch_eval=True),
    "python_nsga": dict(seed=5, vectorized_nsga=False),
    "oracle": dict(seed=4, oracle_interval=1, max_generations=3,
                   min_generations=1, pop_size=6),
}


@pytest.mark.parametrize("case", sorted(GA_CASES))
def test_ga_result_matches_reference(case):
    kw = dict(pop_size=8, max_generations=4, min_generations=2)
    kw.update(GA_CASES[case])
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(pkg, ga=pkg.GAConfig(**kw))
        out[tag] = (_fingerprint(an.run_ga()), an.spec_cache_hits,
                    an.spec_cache_misses, an.objective_cache_hits,
                    an.objective_cache_misses)
    assert out["port"] == out["ref"]
    if case == "oracle":
        drift = out["port"][0][5]
        assert drift and all(d == 0.0 for _, d in drift)


def test_batch_workers_change_nothing():
    """Counterpart of the reference's ``test_batch_workers_identical``."""
    out = []
    for workers in (1, 2):
        an = analyzer(tc, batch_workers=workers,
                      ga=tc.GAConfig(pop_size=8, max_generations=4,
                                     min_generations=2, seed=3, batch_eval=True))
        try:
            out.append(_fingerprint(an.run_ga()))
        finally:
            an.close()
    ref = analyzer(rc, ga=rc.GAConfig(pop_size=8, max_generations=4,
                                      min_generations=2, seed=3, batch_eval=True))
    assert out[0] == out[1] == _fingerprint(ref.run_ga())


def test_ga_under_arrivals_and_faults_matches_reference():
    """A scenario with Poisson arrivals and a fault ensemble: every GA
    evaluation is faulted (the robustness objective)."""
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(
            pkg, ga=pkg.GAConfig(pop_size=6, max_generations=3,
                                 min_generations=1, seed=9),
            arrival=pkg.ArrivalSpec(kind="poisson", seed=3),
            faults=pkg.FaultSpec(throttles=((0, 0.002, 0.01, 2.0),),
                                 straggler_prob=0.1, straggler_shape=1.5,
                                 seed=2))
        out[tag] = _fingerprint(an.run_ga(seeds=[an.factory.seeded_solution(2)]))
    assert out["port"] == out["ref"]


def test_genetic_scheduler_with_synthetic_objective_matches():
    """``GeneticScheduler`` on its own, with a cheap objective over the
    chromosome (no simulator): the draws of selection, crossover and
    mutation are the reference's."""
    def objective(sol):
        cut = sum(sum(p) for p in sol.partition)
        moved = sum(sum(m) for m in sol.mapping)
        return (float(cut) + 0.5 * sol.priority[0], float(moved) - 0.1 * cut)

    out = {}
    for tag, pkg in PKGS.items():
        nets = [pkg.chain_graph(f"m{i}", [("conv", 1e6, 10, 100)] * 5)
                for i in range(3)]
        fac = pkg.SolutionFactory(nets, num_processors=3, rng=random.Random(1))
        ga = pkg.GeneticScheduler(
            factory=fac, evaluate_fast=objective, evaluate_accurate=objective,
            config=pkg.GAConfig(pop_size=10, max_generations=6,
                                min_generations=3, seed=7))
        out[tag] = _fingerprint(ga.run(seeds=[fac.seeded_solution(0)]))
    assert out["port"] == out["ref"]


# -- baselines ---------------------------------------------------------------

@pytest.mark.parametrize("max_evals", [10, 40, 120])
def test_best_mapping_and_npu_only_match(max_evals):
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(pkg)
        bm = an.best_mapping(max_evals=max_evals, seed=max_evals)
        npu = an.npu_only()
        out[tag] = ([(s.key(), s.fitness) for s in bm], npu.key(),
                    an.objectives(npu), an.best_times, an.base_periods)
    assert out["port"] == out["ref"]


def test_baseline_functions_match_on_zoo_graphs():
    names = ("face_det", "selfie_seg", "pose_det", "mosaic")
    out = {}
    for tag, pkg, zoo in (("ref", rc, rz), ("port", tc, tz)):
        graphs = [zoo.make_cost_graph(n) for n in names]
        procs, prof = procs_and_profiler(pkg)
        best = pkg.best_model_times(graphs, procs, prof)

        def evaluate(sol):
            return (float(sum(sum(m) for m in sol.mapping)),
                    float(sum(sol.dtype)))

        sols = pkg.best_mapping_solutions(graphs, [p.pid for p in procs], best,
                                          evaluate, max_evals=25, seed=1)
        out[tag] = (best, pkg.npu_only_solution(graphs, 2, best).key(),
                    [(s.key(), s.fitness) for s in sols])
    assert out["port"] == out["ref"]


# -- scenarios ---------------------------------------------------------------

@pytest.mark.parametrize("num_groups,per", [(1, 6), (2, 6), (3, 3)])
def test_random_scenarios_match(num_groups, per):
    for seed in (0, 1, 2025):
        got = tc.random_scenarios(tz.MODEL_NAMES, count=5,
                                  models_per_scenario=per,
                                  num_groups=num_groups, seed=seed)
        assert got == rc.random_scenarios(rz.MODEL_NAMES, count=5,
                                          models_per_scenario=per,
                                          num_groups=num_groups, seed=seed)


def test_multi_group_protocol_composition():
    """The composition the card's search phase serves (Fig. 15 protocol)."""
    first = tc.random_scenarios(tz.MODEL_NAMES, count=1, models_per_scenario=6,
                                num_groups=2, seed=2025)[0]
    assert first == [("fastsam_s", "selfie_seg", "fast_scnn"),
                     ("pose_det", "mosaic", "face_det")]


def test_sample_groups_match():
    for seed in range(10):
        rt, rr = random.Random(seed), random.Random(seed)
        for _ in range(3):
            got = tc.sample_groups(rt, tz.MODEL_NAMES)
            assert got == rc.sample_groups(rr, rz.MODEL_NAMES)
        assert tc.sample_groups(rt, tz.MODEL_NAMES, 2, 2, 3, 3) == \
            rc.sample_groups(rr, rz.MODEL_NAMES, 2, 2, 3, 3)


def test_build_scenario_periods_and_placements_match():
    groups = [("face_det", "selfie_seg"), ("pose_det", "face_det")]
    out = {}
    for tag, pkg, zoo in (("ref", rc, rz), ("port", tc, tz)):
        factory = {n: zoo.make_cost_graph(n) for g in groups for n in g}
        scen = pkg.build_scenario("zoo", groups, factory,
                                  arrival=pkg.ArrivalSpec(kind="poisson", seed=1))
        procs, prof = procs_and_profiler(pkg)
        best = pkg.best_model_times(scen.graphs, procs, prof)
        placed = pkg.whole_model_placement(scen.graphs[1], 1, 2, 1, 0)
        out[tag] = (scen.groups, scen.num_groups, scen.arrival.key(),
                    [g.name for g in scen.graphs],
                    pkg.base_periods(scen, best),
                    pkg.base_periods(scen, best, epsilon=0.3),
                    (placed.subgraph.merkle_hash(), placed.dtype,
                     placed.backend, placed.priority),
                    prof.subgraph_time(placed))
    assert out["port"] == out["ref"]
