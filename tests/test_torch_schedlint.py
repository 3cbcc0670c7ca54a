"""The port's static schedule linter (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``).

The unit cases of ``tests/test_schedlint.py`` run on both packages with the
same nets, solutions and seeds; every ``LintReport`` (its JSON), every
``alpha_lower_bound``, memory bound and provisioning verdict, and every
pre-screened GA run (history, front, fitness, ``prescreen_stats``) must
equal the reference's (``==``). The soundness differential runs on the
port in chunks, each chromosome's report held to the reference's and each
proof to the port's own simulator and its capacity-bounded TensorPool on
the CPU.
"""
import dataclasses
import json
import math
import random

import pytest

import repro.analysis as ra
import repro.core as rc
import repro_torch.analysis as ta
import repro_torch.core as tc
from repro.core.analyzer import PRESCREEN_OBJECTIVE as REF_PRESCREEN_OBJECTIVE
from repro.core.graph import Subgraph as RefSubgraph
from repro_torch.core.analyzer import PRESCREEN_OBJECTIVE
from repro_torch.core.graph import Subgraph, partition_quotient, quotient_is_acyclic
from repro_torch.core.memlayout import CHUNK, rounded_chunk_bytes
from repro_torch.core.scoring import ALPHA_GRID
from test_torch_sched_inputs import PKGS, procs_and_profiler, random_problem

ANALYSIS = {"ref": ra, "port": ta}
THRESHOLD = 0.995


def _nets(pkg):
    return (
        pkg.chain_graph("alpha", [("conv", 4e6, 1000, 4000)] * 4),
        pkg.chain_graph("beta", [("fc", 8e6, 2000, 8000)] * 3),
    )


def _analyzer(pkg, nets=None, groups=((0,), (1,)), processors=None,
              faults=None, arrival=None, **cfg):
    nets = nets if nets is not None else _nets(pkg)
    procs, prof = procs_and_profiler(pkg)
    scenario = pkg.Scenario(name="lint_test", graphs=tuple(nets),
                            groups=tuple(tuple(g) for g in groups),
                            arrival=arrival, faults=faults)
    return pkg.StaticAnalyzer(
        scenario, list(processors if processors is not None else procs),
        prof, pkg.PAPER_COMM_MODEL, pkg.AnalyzerConfig(**cfg))


def _solution(pkg, nets, seed=0, cut_prob=0.35):
    return pkg.SolutionFactory(nets, num_processors=3, rng=random.Random(seed),
                               cut_prob=cut_prob).random_solution()


def _both(fn):
    """``fn(tag, pkg)`` in both packages; asserts equal results, returns the port's."""
    out = {tag: fn(tag, pkg) for tag, pkg in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


# -- diagnostics plumbing ----------------------------------------------------

def test_diagnostic_rejects_unknown_code_and_severity():
    with pytest.raises(ValueError):
        ta.Diagnostic(code="SL999", severity="error", message="x")
    with pytest.raises(ValueError):
        ta.Diagnostic(code="SL001", severity="fatal", message="x")


def test_lint_report_json_round_trip():
    def build(tag, pkg):
        a = ANALYSIS[tag]
        rep = a.LintReport(alpha_lower_bound=1.25, checked_alpha=0.8)
        rep.extend([
            a.Diagnostic(code="SL020", severity="error", message="oom",
                         location=(("processor", 2),), proof=True),
            a.Diagnostic(code="SL010", severity="warning", message="fallback",
                         location=(("net", 0), ("processor", 2))),
        ])
        back = a.LintReport.from_json(json.loads(json.dumps(rep.to_json())))
        assert back.to_json() == rep.to_json()
        assert back.infeasible and rep.infeasible
        return (rep.to_json(), back.counts(), [d.code for d in back.errors()],
                [d.code for d in back.warnings()], back.by_code("SL020")[0].where())
    got = _both(build)
    assert got[1] == {"SL010": 1, "SL020": 1} and got[2] == ["SL020"]


def test_alpha_scoped_proof_is_not_schedule_infeasibility():
    rep = ta.LintReport()
    rep.extend([ta.Diagnostic(code="SL030", severity="error", message="miss",
                              location=(("alpha", 0.5), ("group", 0)),
                              proof=True)])
    assert not rep.infeasible


def test_every_code_is_documented():
    assert ta.CODES == ra.CODES
    assert set(ta.CODES) == {"SL001", "SL002", "SL003", "SL004", "SL010",
                             "SL020", "SL030", "SL031"}
    assert ta.PROOF_MARGIN == ra.PROOF_MARGIN


# -- SL001/SL002: structural -------------------------------------------------

def test_sl001_quotient_cycle():
    def run(tag, pkg):
        g = pkg.chain_graph("c", [("conv", 1e6, 100, 400)] * 3)
        sg = Subgraph if tag == "port" else RefSubgraph
        sgs = [sg(graph=g, layer_ids=(0, 2), sg_index=0),
               sg(graph=g, layer_ids=(1,), sg_index=1)]
        diags = ANALYSIS[tag].structural_diagnostics(g, sgs, net=3)
        return [d.to_json() for d in diags]
    got = _both(run)
    assert [d["code"] for d in got] == ["SL001"]
    assert got[0]["proof"] and got[0]["location"] == {"net": 3}
    g = tc.chain_graph("c", [("conv", 1e6, 100, 400)] * 3)
    _owner, edges, problems = partition_quotient(
        g, [Subgraph(graph=g, layer_ids=(0, 2), sg_index=0),
            Subgraph(graph=g, layer_ids=(1,), sg_index=1)])
    assert not problems and not quotient_is_acyclic(2, edges)


def test_sl002_unowned_and_duplicated_layers():
    def run(tag, pkg):
        g = pkg.chain_graph("c", [("conv", 1e6, 100, 400)] * 3)
        sg = Subgraph if tag == "port" else RefSubgraph
        missing = [sg(graph=g, layer_ids=(0, 1), sg_index=0)]
        dup = [sg(graph=g, layer_ids=(0, 1), sg_index=0),
               sg(graph=g, layer_ids=(1, 2), sg_index=1)]
        sd = ANALYSIS[tag].structural_diagnostics
        return ([d.to_json() for d in sd(g, missing)],
                [d.to_json() for d in sd(g, dup)])
    for diags in _both(run):
        assert diags and {d["code"] for d in diags} == {"SL002"}


def test_structural_clean_on_real_partitions():
    nets = _nets(tc)
    an = _analyzer(tc, nets)
    for seed in range(5):
        placed = an.linter().builder.decode(_solution(tc, nets, seed=seed))
        for net, g in enumerate(nets):
            assert ta.structural_diagnostics(
                g, [p.subgraph for p in placed[net]], net) == []


# -- SL003/SL004: chromosome shape -------------------------------------------

def _corrupt(kind):
    def run(tag, pkg):
        nets = _nets(pkg)
        an = _analyzer(pkg, nets)
        sol = _solution(pkg, nets)
        if kind == "truncated":
            sol.mapping = [row[:-1] for row in sol.mapping]
        elif kind == "processor":
            sol.mapping[0][0] = 3
        elif kind == "dtype":
            sol.dtype = list(sol.dtype)
            sol.dtype[1] = 99
        else:
            sol.priority = [0, 0]
        rep = an.linter().lint(sol)
        return rep.to_json(), rep.infeasible, an.prescreen_objectives(sol)
    return run


@pytest.mark.parametrize("kind,code", [("truncated", "SL003"),
                                       ("processor", "SL003"),
                                       ("dtype", "SL003"),
                                       ("priority", "SL004")])
def test_sl003_sl004_corrupt_chromosomes(kind, code):
    doc, infeasible, obj = _both(_corrupt(kind))
    assert {f["code"] for f in doc["findings"]} == {code}
    assert infeasible
    assert obj == (PRESCREEN_OBJECTIVE,) * 4


# -- SL010: capability -------------------------------------------------------

def test_sl010_npu_fp32_is_warning_not_proof():
    def run(tag, pkg):
        nets = _nets(pkg)
        an = _analyzer(pkg, nets)
        sol = an.factory.seeded_solution(2)
        sol.dtype = [0] * len(nets)
        sol.backend = [0] * len(nets)
        rep = an.linter().lint(sol)
        w = rep.by_code("SL010")
        assert len(w) == len(nets) and all(d.severity == "warning" for d in w)
        assert not rep.infeasible
        assert an.prescreen_objectives(sol) is None
        score = an.score(sol, 6.0)
        assert score > 0.0
        return rep.to_json(), score
    _both(run)


def test_sl010_silent_on_supported_config():
    an = _analyzer(tc, _nets(tc))
    assert an.linter().lint(an.factory.seeded_solution(0)).by_code("SL010") == []


# -- SL020: memory ------------------------------------------------------------

def test_memory_bound_matches_pool_provisioning_exactly():
    nets = _nets(tc)
    an = _analyzer(tc, nets)
    ref_an = _analyzer(rc, _nets(rc))
    for seed in range(8):
        placed = an.linter().builder.decode(_solution(tc, nets, seed=seed))
        ref_placed = ref_an.linter().builder.decode(
            _solution(rc, ref_an.scenario.graphs, seed=seed))
        bounds = ta.memory_lower_bounds(placed)
        assert bounds == ra.memory_lower_bounds(ref_placed) and bounds
        for pid, (weights, arena) in bounds.items():
            assert weights % CHUNK == 0 and arena % CHUNK == 0
            need = weights + arena
            assert ta.provision_memory(placed, {pid: need},
                                       device="cpu") == {pid: True}
            assert ta.provision_memory(placed, {pid: need - 1},
                                       device="cpu") == {pid: False}


def test_sl020_fires_iff_capacity_exceeded():
    def run(tag, pkg):
        nets = _nets(pkg)
        an = _analyzer(pkg, nets)
        sol = _solution(pkg, nets, seed=3)
        bounds = ANALYSIS[tag].memory_lower_bounds(an.linter().builder.decode(sol))
        pid, (weights, arena) = sorted(bounds.items())[0]
        need = weights + arena
        tight = ANALYSIS[tag].ScheduleLinter.from_analyzer(an)
        tight._capacity[pid] = need - 1
        rep = tight.lint(sol)
        oom = rep.by_code("SL020")
        assert len(oom) == 1 and oom[0].proof and rep.infeasible
        assert oom[0].where()["processor"] == pid
        exact = ANALYSIS[tag].ScheduleLinter.from_analyzer(an)
        exact._capacity[pid] = need
        assert exact.lint(sol).by_code("SL020") == []
        return rep.to_json()
    _both(run)


def test_processor_memory_capacity_flows_into_linter():
    def run(tag, pkg):
        procs = [dataclasses.replace(p, memory_capacity=CHUNK) if p.pid == 2
                 else p for p in pkg.mobile_processors()]
        an = _analyzer(pkg, processors=procs)
        assert an.linter().capacities()[2] == CHUNK
        sol = an.factory.seeded_solution(2)
        rep = an.linter().lint(sol)
        assert rep.by_code("SL020") and rep.infeasible
        return rep.to_json(), an.prescreen_objectives(sol)
    _, obj = _both(run)
    assert obj == (PRESCREEN_OBJECTIVE,) * 4


def test_rounded_chunk_bytes():
    assert [rounded_chunk_bytes(n) for n in (0, 1, CHUNK, CHUNK + 1)] == \
        [CHUNK, CHUNK, CHUNK, 2 * CHUNK]


def test_provision_memory_defaults_to_the_card(monkeypatch):
    """Without ``device`` the pool goes to the card; with no card that is an
    error, not a fall-back to host memory."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    an = _analyzer(tc)
    placed = an.linter().builder.decode(_solution(tc, an.scenario.graphs))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.provision_memory(placed, {0: 1 << 20})


# -- SL030/SL031: deadline proofs ---------------------------------------------

@pytest.mark.parametrize("groups,code", [(((0,), (1,)), "SL030"),
                                         (((0, 1),), "SL031")])
def test_deadline_proofs_agree_with_simulator(groups, code):
    def run(tag, pkg):
        an = _analyzer(pkg, groups=groups)
        an.base_periods = [p / 50.0 for p in an.base_periods]
        sol = an.factory.seeded_solution(0)
        rep = an.lint(sol, alpha=1.0)
        assert rep.by_code(code)
        score = an.score(sol, 1.0)
        assert score < THRESHOLD
        return rep.to_json(), score
    doc, _ = _both(run)
    if code == "SL030":
        assert doc["alpha_lower_bound"] > 1.0 and not doc["infeasible"]


def test_deadline_proofs_silent_when_feasible():
    def run(tag, pkg):
        an = _analyzer(pkg)
        sol = an.factory.seeded_solution(2)
        sat = an.saturation(sol)
        assert math.isfinite(sat.alpha_star)
        rep = an.lint(sol, alpha=sat.alpha_star)
        assert rep.by_code("SL030") == [] and rep.by_code("SL031") == []
        assert rep.alpha_lower_bound <= sat.alpha_star
        return rep.to_json(), sat.alpha_star
    _both(run)


def test_group_proof_guard_disables_weak_templates():
    an = _analyzer(tc)
    linter = an.linter()
    linter.threshold = 0.5
    spec = an.solution_spec(an.factory.seeded_solution(0))
    assert linter.alpha_lower_bound(spec) == 0.0
    assert linter.deadline_diagnostics(spec, 1e-9) == []


def test_exec_floor_clean_and_noise_and_throttle():
    def run(tag, pkg):
        linter = _analyzer(pkg).linter()
        noisy = linter.exec_floor(measured=True)
        assert linter.exec_floor(measured=False) == 1.0 and 0.0 < noisy < 1.0
        an2 = _analyzer(pkg, faults=pkg.FaultSpec(
            throttles=((0, 0.0, 10.0, 0.25),)))
        fast = an2.linter().exec_floor(measured=True)
        assert fast == pytest.approx(noisy * 0.25)
        assert an2.linter().exec_floor(measured=False) == 0.25
        return noisy, fast
    _both(run)


# -- α floor ↔ bisection skip --------------------------------------------------

def test_alpha_floor_skip_preserves_alpha_star():
    def run(tag, pkg):
        out = []
        for pid in (1, 2):
            sats, floors = {}, {}
            for prescreen in (False, True):
                an = _analyzer(pkg, prescreen=prescreen)
                sol = an.factory.seeded_solution(pid)
                sats[prescreen] = an.saturation(sol).alpha_star
                floors[prescreen] = an.alpha_floor(sol)
            assert sats[False] == sats[True] and floors[False] == 0.0
            out.append((sats[True], floors[True]))
        return out
    _both(run)


def test_population_saturation_matches_scalar_with_prescreen():
    def run(tag, pkg):
        an = _analyzer(pkg, prescreen=True)
        sols = [an.factory.seeded_solution(p.pid) for p in an.processors]
        batched = [b.alpha_star for b in an.population_saturation(sols)]
        assert batched == [an.saturation(s).alpha_star for s in sols]
        return batched
    _both(run)


# -- soundness differential, in chunks -------------------------------------------

def _lattice_below(lb, k=3):
    return [a for a in ALPHA_GRID if a < lb][-k:]


def _sweep_scenario(pkg, rng):
    nets, groups, periods = random_problem(pkg, rng)
    arrival = None
    if rng.random() < 0.3:
        arrival = pkg.ArrivalSpec(kind=rng.choice(["jittered", "poisson"]),
                                  jitter=0.25, seed=rng.randrange(1 << 20))
    faults = None
    if rng.random() < 0.3:
        faults = pkg.FaultSpec(
            throttles=((rng.randrange(3), 0.0, rng.uniform(0.01, 1.0),
                        rng.choice([0.5, 2.0, 3.0])),),
            straggler_prob=rng.choice([0.0, 0.2]),
            straggler_shape=1.5, seed=rng.randrange(1 << 20))
    an = _analyzer(pkg, nets, groups=groups, arrival=arrival, faults=faults,
                   prescreen=True)
    an.base_periods = list(periods)
    fac = pkg.SolutionFactory(nets, num_processors=3,
                              rng=random.Random(rng.randrange(1 << 30)),
                              cut_prob=rng.uniform(0.1, 0.5))
    return an, fac


def _lint_docs(tag, an, sol):
    linter = an.linter()
    spec = an.solution_spec(sol)
    placed = linter.builder.decode(sol)
    return (linter.lint(sol, alpha=1.0).to_json(),
            linter.alpha_lower_bound(spec),
            [[d.to_json() for d in linter.deadline_diagnostics(spec, a)]
             for a in (0.5, 1.0, 2.0)],
            ANALYSIS[tag].memory_lower_bounds(placed))


@pytest.mark.parametrize("chunk", range(8))
def test_soundness_differential_sweep(chunk):
    """13 random chromosomes a chunk (104 in all, as the reference's sweep):
    each report equals the reference's, and every proof the port emits is
    confirmed by its simulator and by its capacity-bounded TensorPool."""
    rngs = {tag: random.Random(20250808 + chunk) for tag in PKGS}
    chromosomes = proof_checks = memory_checks = 0
    while chromosomes < 13:
        made = {tag: _sweep_scenario(pkg, rngs[tag]) for tag, pkg in PKGS.items()}
        an, fac = made["port"]
        ref_an, ref_fac = made["ref"]
        for _ in range(4):
            sol, ref_sol = fac.random_solution(), ref_fac.random_solution()
            chromosomes += 1
            docs = _lint_docs("port", an, sol)
            assert docs == _lint_docs("ref", ref_an, ref_sol)
            lint, lb, deadline, bounds = docs
            for alpha in _lattice_below(lb):
                assert an.score(sol, alpha) < THRESHOLD, (lb, alpha)
                proof_checks += 1
            for alpha, found in zip((0.5, 1.0, 2.0), deadline):
                if found:
                    assert an.score(sol, alpha) < THRESHOLD, alpha
                    proof_checks += 1
            placed = an.linter().builder.decode(sol)
            pid = rngs["port"].choice(sorted(bounds))
            assert rngs["ref"].choice(sorted(bounds)) == pid
            need = sum(bounds[pid])
            free = rngs["port"].randrange(CHUNK, need + CHUNK)
            assert rngs["ref"].randrange(CHUNK, need + CHUNK) == free
            for cap, expect_ok in ((need, True), (need - 1, False), (free, None)):
                ok = ta.provision_memory(placed, {pid: cap}, device="cpu")[pid]
                if expect_ok is not None:
                    assert ok is expect_ok
                probe = ta.ScheduleLinter.from_analyzer(an)
                probe._capacity = {pid: cap}
                assert bool(probe.memory_diagnostics(placed)) == (not ok), (
                    cap, need, ok)
                memory_checks += 1
    assert memory_checks == 3 * chromosomes
    assert proof_checks > 0


# -- GA integration ------------------------------------------------------------

def _fingerprint(result):
    return (result.history, [s.key() for s in result.pareto],
            [s.fitness for s in result.pareto], result.generations,
            result.evaluations, result.prescreen_stats)


def _ga_analyzer(pkg, processors=None, prescreen=False):
    return _analyzer(
        pkg, processors=processors, prescreen=prescreen,
        ga=pkg.GAConfig(pop_size=12, max_generations=8, min_generations=4,
                        seed=11, prescreen=prescreen))


def test_ga_prescreen_off_on_identical_when_nothing_pruned():
    def run(tag, pkg):
        base = _ga_analyzer(pkg, prescreen=False).run_ga()
        screened = _ga_analyzer(pkg, prescreen=True).run_ga()
        assert _fingerprint(base)[:5] == _fingerprint(screened)[:5]
        assert screened.prescreen_stats["pruned"] == 0
        assert screened.prescreen_stats["checked"] > 0
        assert base.prescreen_stats["checked"] == 0
        return _fingerprint(base), _fingerprint(screened)
    _both(run)


def _tight(pkg):
    return [dataclasses.replace(p, memory_capacity=16384) if p.kind == "npu"
            else p for p in pkg.mobile_processors()]


def test_ga_prescreen_prunes_only_provable_oom():
    def run(tag, pkg):
        an = _ga_analyzer(pkg, processors=_tight(pkg), prescreen=True)
        result = an.run_ga()
        stats = result.prescreen_stats
        assert stats["pruned"] > 0
        assert stats["simulations_avoided"] == stats["pruned"]
        assert stats["checked"] >= stats["pruned"] and result.evaluations > 0
        if tag == "port":
            linter = an.linter()
            for sol in result.pareto:
                assert sol.fitness is None or \
                    max(sol.fitness) < PRESCREEN_OBJECTIVE
                ok = ta.provision_memory(linter.builder.decode(sol),
                                         linter.capacities(), device="cpu")
                assert all(ok.values()), "infeasible chromosome survived"
        return _fingerprint(result)
    _both(run)


def test_prescreen_objective_matches_reference():
    assert PRESCREEN_OBJECTIVE == REF_PRESCREEN_OBJECTIVE == 2.0e6
