"""The port's StaticAnalyzer against the JAX package's, and its
device-in-the-loop rounds on the CPU.

Parity: on the diamond-mix scenario of ``tests/test_fastsim.py`` (and with
Poisson arrivals or a fault ensemble), ``objectives``, ``objectives_batch``,
``score``, ``saturation`` (bisect, grid, a given lattice),
``population_saturation``, ``score_batch``, ``score_under_faults``,
``backup_mapping``, ``rerank_pareto`` and the measured-cost feedback equal
the reference's with ``==`` (tolerance: none).

R2 (ROADMAP Queue 3): ``batch_objectives`` takes the group mean with a
plain sequential sum of numpy floats and the scalar ``objectives`` with
Python 3.12's compensated ``sum`` of floats, so the two differ in the last
bits of the means. The port keeps both sums as the reference has them (its
batch objectives equal the reference's exactly, above). The counterparts of
the reference's two R2 tests therefore hold the group means to the error
bound of a sequential sum of n non-negative values, n ulps of the mean, and
everything else (the p90s, the chosen chromosomes, the counts) exactly.

Device in the loop: the port's zoo at 4 channels and 8×8 on the CPU, with
``TorchExecBackend`` costs and ``PuzzleRuntime`` rounds
(``RuntimeConfig(int8_staging=True)``), as the card runs it at full size.
"""
import math
import random

import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
import repro_torch.runtime as tr
import repro_torch.zoo as tz
from test_torch_sched_inputs import PKGS, analyzer


def _sols(pkg, an, count, seed):
    an.factory.rng = random.Random(seed)
    return [an.factory.random_solution() for _ in range(count)]


SCENARIOS = {
    "periodic": {},
    "poisson": {"arrival": "poisson"},
    "faults": {"faults": True},
}


def _scenario_kw(pkg, name):
    kw = {}
    if SCENARIOS[name].get("arrival"):
        kw["arrival"] = pkg.ArrivalSpec(kind="poisson", seed=8)
    if SCENARIOS[name].get("faults"):
        kw["faults"] = pkg.FaultSpec(dropouts=((1, 0.01, 0.004),),
                                     throttles=((0, 0.002, 0.012, 2.0),),
                                     straggler_prob=0.15, straggler_shape=1.5,
                                     seed=4)
    return kw


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_objectives_and_caches_match(scenario):
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(pkg, **_scenario_kw(pkg, scenario))
        sols = _sols(pkg, an, 5, seed=21)
        vals = []
        for s in sols + sols[:2]:
            for measured in (False, True):
                vals.append(an.objectives(s, measured=measured))
                vals.append(an.objectives(s, alpha=1.7, num_requests=9,
                                          measured=measured, engine="reference"))
        vals.append(an.objectives_batch(sols, measured=True))
        vals.append(an.objectives_batch(sols + sols[:1], alpha=0.8))
        out[tag] = (vals, an.spec_cache_hits, an.spec_cache_misses,
                    an.objective_cache_hits, an.objective_cache_misses,
                    an.base_periods, an.best_times)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scores_and_saturation_match(scenario):
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(pkg, **_scenario_kw(pkg, scenario))
        sols = _sols(pkg, an, 3, seed=4) + [an.factory.seeded_solution(2)]
        vals = [an.score(s, a, num_requests=10, seed=3)
                for s in sols for a in (0.5, 1.0, 2.5)]
        vals.append(an.score_batch([(s, a) for s in sols for a in (0.5, 2.5)],
                                   num_requests=10, seed=3))
        sat = [an.saturation(s) for s in sols]
        sat.append(an.saturation(sols[-1], mode="grid"))
        sat.append(an.saturation(sols[0], alphas=[0.5, 1.0, 2.0, 4.0]))
        vals += [(r.alpha_star, r.scores) for r in sat]
        vals += [(r.alpha_star, r.scores)
                 for r in an.population_saturation(sols)]
        vals.append(an.median_saturation(sols[:3]))
        res = an.simulate_batch([(s, 1.0) for s in sols], 6, measured=True)
        vals.append([res.makespans(i, g) for i in range(len(sols))
                     for g in range(2)])
        out[tag] = vals
    assert out["port"] == out["ref"]


def test_population_saturation_grid_matches():
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(pkg, accurate_requests=6)
        sols = _sols(pkg, an, 2, seed=42)
        out[tag] = [(r.alpha_star, r.scores)
                    for r in an.population_saturation(sols, mode="grid")]
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("scenario", ["periodic", "faults"])
def test_score_under_faults_and_backup_mapping_match(scenario):
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(pkg, **_scenario_kw(pkg, scenario))
        sols = _sols(pkg, an, 3, seed=17)
        faults = pkg.FaultSpec(dropouts=((2, 0.006, None),), seed=5)
        vals = [an.score_under_faults(s, num_requests=10) for s in sols]
        vals += [an.score_under_faults(s, faults=faults, alpha=1.5,
                                       num_requests=10, seed=2) for s in sols]
        for s in sols:
            for dead in range(3):
                backup, remap = an.backup_mapping(s, dead)
                vals.append((backup.key(), sorted(remap.items()),
                             an.objectives(backup)))
        out[tag] = vals
    assert out["port"] == out["ref"]
    assert out["port"][0]["dropped_clean"] == 0.0


def test_rerank_pareto_matches():
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(pkg)
        sols = _sols(pkg, an, 6, seed=12)
        for s in sols:
            s.fitness = an.objectives(s, num_requests=6)
        key = pkg.decode_solution(sols[0], an.scenario.graphs)[0][0].profile_key()
        an.apply_measured_costs({key: an.profiler.db.get(key) * 20.0})
        front = an.rerank_pareto(sols, num_requests=8)
        out[tag] = ([s.key() for s in front], [s.fitness for s in sols])
        for s in sols:
            assert s.fitness == an.objectives(s, num_requests=8, measured=True)
    assert out["port"] == out["ref"]


# -- measured-cost feedback ----------------------------------------------------

def _feedback_trace(pkg):
    """The steps of the reference's ``test_apply_measured_costs_*`` tests."""
    an = analyzer(pkg)
    sols = [an.factory.seeded_solution(2)] + _sols(pkg, an, 5, seed=7)
    trace = [[an.objectives(s, num_requests=8) for s in sols]]
    placed = pkg.decode_solution(sols[0], an.scenario.graphs)
    key, key2 = placed[0][0].profile_key(), placed[1][0].profile_key()
    old = an.profiler.db.get(key)
    assert old is not None
    # unchanged and within rel_tol: skipped, caches stay warm
    trace.append(an.apply_measured_costs({key: old}))
    trace.append(an.apply_measured_costs({key: old * 1.04}))
    hits = an.objective_cache_hits
    trace.append(an.objectives(sols[0], num_requests=8))
    trace.append(an.objective_cache_hits - hits)
    # unusable samples are skipped and counted
    trace.append(an.apply_measured_costs(
        {key: None, key2: float("inf"), "absent": -1.0}))
    trace.append(an.measured_skips)
    # a real change flushes the caches and moves exactly the affected solutions
    trace.append(an.apply_measured_costs({key: old * 10.0, key2: None},
                                         rel_tol=0.05))
    trace.append(an.measured_skips)
    trace.append((len(an._spec_cache), len(an._objective_cache)))
    trace.append([an.objectives(s, num_requests=8) for s in sols])
    uses = [key in {p.profile_key() for plist in
                    pkg.decode_solution(s, an.scenario.graphs) for p in plist}
            for s in sols]
    trace.append(uses)
    trace.append(an.profiler.db.get(key) == old * 10.0)
    return trace


def test_apply_measured_costs_matches_reference():
    port, ref = _feedback_trace(tc), _feedback_trace(rc)
    assert port == ref
    before, after, uses = port[0], port[-3], port[-2]
    assert port[1:3] == [0, 0] and port[4] == 1          # skipped, cache hit
    assert port[5:7] == [0, 3] and port[7:9] == [1, 1]   # skips counted
    assert port[9] == (0, 0)                             # caches flushed
    assert uses[0]
    for u, b, a in zip(uses, before, after):
        if not u:
            assert a == b      # untouched keys re-derive identical costs
    assert any(a != b for u, b, a in zip(uses, before, after) if u)
    assert port[-1]


def test_ga_device_in_loop_interval_reranks_as_reference():
    """Measurement rounds with a stubbed measurement (the reference's
    ``test_ga_device_in_loop_interval_reranks``), in both packages."""
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(pkg, ga=pkg.GAConfig(pop_size=8, max_generations=6,
                                           min_generations=6, patience=99,
                                           seed=3, device_in_loop_interval=2))
        factor = [2.0]

        def fake_measure(front, an=an, pkg=pkg):
            total = 0
            for s in front[:1]:
                key = pkg.decode_solution(s, an.scenario.graphs)[0][0].profile_key()
                old = an.profiler.db.get(key)
                if old is None:
                    continue
                total += an.apply_measured_costs({key: old * factor[0]})
                factor[0] *= 1.5
            return total

        sched = pkg.GeneticScheduler(
            factory=an.factory,
            evaluate_fast=lambda s, an=an: an.objectives(s, num_requests=6),
            config=an.cfg.ga, measure_device=fake_measure)
        res = sched.run(seeds=_sols(pkg, an, 4, seed=1))
        assert res.device_updates
        assert all(g % 2 == 0 for g, _ in res.device_updates)
        for s in res.pareto:
            assert s.fitness == an.objectives(s, num_requests=6)
        out[tag] = (res.device_updates, [s.key() for s in res.pareto],
                    res.history, res.evaluations)
    assert out["port"] == out["ref"]


# -- R2: the batch objectives against the scalar loop ---------------------------

def _within_sum_bound(batch, scalar, n):
    """Group means within n ulps (sequential sum of n values against a
    compensated one); p90s exact."""
    assert len(batch) == len(scalar)
    for i, (b, s) in enumerate(zip(batch, scalar)):
        if i % 2:
            assert b == s, (i, b, s)
        else:
            assert abs(b - s) <= n * math.ulp(s), (i, b, s, (b - s) / math.ulp(s))


def test_objectives_batch_matches_scalar_loop_within_sum_bound():
    """Counterpart of the reference's ``test_objectives_batch_matches_scalar_loop``."""
    an = analyzer(tc, ga=tc.GAConfig(pop_size=8, max_generations=4,
                                     min_generations=2, seed=3))
    sols = _sols(tc, an, 12, seed=99)
    sols = sols + [sols[0].copy(), sols[5].copy()]
    n = an.cfg.fast_requests
    for measured in (False, True):
        fresh = analyzer(tc)
        batch = an.objectives_batch(sols, measured=measured)
        scalar = [fresh.objectives(s, measured=measured) for s in sols]
        for b, s in zip(batch, scalar):
            _within_sum_bound(b, s, n)


def test_batch_eval_on_off_same_search_within_sum_bound():
    """Counterpart of the reference's ``test_batch_eval_on_off_identical``:
    the same chromosomes, generations and evaluation count; fitness within
    the sum bound; the history (a mean over the population of sums of those
    fitnesses) within the same bound scaled by its number of terms."""
    def run(batch_eval):
        an = analyzer(tc, ga=tc.GAConfig(pop_size=8, max_generations=4,
                                         min_generations=2, seed=3,
                                         batch_eval=batch_eval))
        return an.run_ga(), an.cfg.accurate_requests
    (base, n), (batched, _) = run(False), run(True)
    assert [s.key() for s in base.pareto] == [s.key() for s in batched.pareto]
    assert (base.generations, base.evaluations, base.oracle_drift) == \
        (batched.generations, batched.evaluations, batched.oracle_drift)
    for a, b in zip(base.pareto, batched.pareto):
        _within_sum_bound(b.fitness, a.fitness, n)
    terms = 8 * len(base.pareto[0].fitness)
    for a, b in zip(base.history, batched.history):
        assert abs(a - b) <= (n + 1) * terms * math.ulp(a), (a, b)


def test_batch_objectives_of_port_equal_reference():
    """Both packages keep R2's sum, so their batch objectives agree exactly."""
    out = {}
    for tag, pkg in PKGS.items():
        an = analyzer(pkg)
        sols = _sols(pkg, an, 12, seed=99)
        out[tag] = [an.objectives_batch(sols, measured=m) for m in (False, True)]
    assert out["port"] == out["ref"]


# -- the entry points that waited for slice 6c ----------------------------------

def test_later_entry_points_raise(monkeypatch):
    """The entry points that once raised for want of a later slice all run
    now: the linter, the pre-screen, ``validate_on_runtime`` and the
    compiled batch engine on the analyzer's ``device``. The one raise left
    is the compiled engine's without a card when no ``device="cpu"`` was
    given. (The name is kept from when they all raised.)"""
    an = analyzer(tc)
    sol = an.factory.seeded_solution(0)
    assert an.validate_on_runtime(sol, num_requests=4).passed
    assert an.lint(sol).to_json() == an.linter().lint(sol).to_json()
    assert an.prescreen_objectives(sol) is None
    assert an.alpha_floor(sol) == 0.0
    assert analyzer(tc, prescreen=True).alpha_floor(sol) >= 0.0
    assert tc.AnalyzerConfig(batch_engine="compiled").batch_engine == "compiled"
    an.device = "cpu"
    assert an.objectives_batch([sol], engine="compiled") == analyzer(tc).objectives_batch([sol])
    ga = analyzer(tc, ga=tc.GAConfig(pop_size=4, max_generations=1, batch_eval="compiled"))
    ga.device = "cpu"
    assert ga.run_ga().pareto
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyzer(tc, batch_engine="compiled").objectives_batch([sol])


def test_measure_on_runtime_needs_executables():
    with pytest.raises(ValueError, match="executables"):
        analyzer(tc).measure_on_runtime(analyzer(tc).factory.seeded_solution(0))


# -- device in the loop, on the CPU ---------------------------------------------

NAMES = ("face_det", "selfie_seg")


@pytest.fixture(scope="module")
def zoo():
    return tz.executable_zoo(NAMES, channels=4, spatial=8, device="cpu")


def _device_analyzer(zoo, **cfg_kw):
    procs = tc.mobile_processors()
    prof = tc.Profiler(tc.TorchExecBackend(zoo, repeats=1))
    scen = tc.build_scenario("dil", [(NAMES[0],), (NAMES[1],)],
                             {n: zoo[n].graph for n in NAMES})
    return tc.StaticAnalyzer(
        scen, procs, prof, tc.PAPER_COMM_MODEL, tc.AnalyzerConfig(**cfg_kw),
        executables=zoo, device="cpu",
        runtime_config=tr.RuntimeConfig(int8_staging=True))


def _split_int8(an):
    """Each net cut at num_layers // 2 (skip edges too), halves on two
    processors, every dtype gene int8."""
    graphs = an.scenario.graphs
    part, mapping = [], []
    for i, g in enumerate(graphs):
        h = g.num_layers // 2
        part.append([1 if e.src <= h < e.dst else 0 for e in g.edges])
        mapping.append([i % 3] * (h + 1) + [(i + 1) % 3] * (g.num_layers - h - 1))
    return tc.Solution(partition=part, mapping=mapping,
                       priority=list(range(len(graphs))),
                       dtype=[2] * len(graphs), backend=[0] * len(graphs))


def test_measure_on_runtime_keys_every_placed_subgraph(zoo):
    an = _device_analyzer(zoo)
    assert an.device == "cpu" and an.runtime_config.int8_staging
    for sol in (_split_int8(an), an.npu_only(), an.factory.seeded_solution(1)):
        placed = tc.decode_solution(sol, an.scenario.graphs)
        got = an.measure_on_runtime(sol, num_requests=3)
        assert set(got) == {p.profile_key() for plist in placed for p in plist}
        assert all(math.isfinite(t) and t > 0 for t in got.values())
    assert sum(len(p) for p in tc.decode_solution(
        _split_int8(an), an.scenario.graphs)) == 4


def test_measured_costs_feed_the_profile(zoo):
    an = _device_analyzer(zoo)
    sol = _split_int8(an)
    an.objectives(sol)
    got = an.measure_on_runtime(sol, num_requests=3)
    profiled = {k: an.profiler.db.get(k) for k in got}
    assert all(t is not None for t in profiled.values())
    changed = an.apply_measured_costs(got, rel_tol=0.0)
    assert changed == sum(1 for k, t in got.items() if t != profiled[k]) > 0
    assert all(an.profiler.db.get(k) == t for k, t in got.items())
    assert len(an._objective_cache) == 0
    # the same values again are within rel_tol: nothing changes
    assert an.apply_measured_costs(got) == 0


def test_run_ga_with_device_rounds_on_cpu(zoo):
    an = _device_analyzer(zoo, ga=tc.GAConfig(
        pop_size=6, max_generations=4, min_generations=4, patience=99, seed=0,
        device_in_loop_interval=2), device_in_loop_topk=1,
        device_in_loop_requests=3)
    rounds = []
    inner = an._device_in_loop

    def counted(front):
        rounds.append(len(front))
        return inner(front)

    an._device_in_loop = counted
    res = an.run_ga()
    assert len(rounds) == 2
    assert res.device_updates, "no measurement round changed the profile"
    assert all(g % 2 == 0 for g, _ in res.device_updates)
    for s in res.pareto:
        assert s.fitness in (
            an.objectives(s, num_requests=an.cfg.fast_requests),
            an.objectives(s, num_requests=an.cfg.accurate_requests,
                          measured=True)), s.key()
    assert not torch.cuda.is_initialized()
