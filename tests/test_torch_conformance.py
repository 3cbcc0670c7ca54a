"""The port's runtime↔simulator conformance harness against the JAX package's.

``StaticAnalyzer.validate_on_runtime`` (``tests/test_conformance.py``) and
the virtual-runtime tier of the fault differential
(``tests/test_fault_differential.py``) run on both packages with the same
nets, solutions, seeds, arrival processes and fault ensembles, built in
each package from one seed. Virtual mode is held at zero tolerance: the
port's ``ConformanceReport.summary()`` and both traces must equal the
reference's (``==``), and the port's virtual runtime must equal the
reference's DES, its virtual runtime and the port's own FastSimulator,
bit for bit. Real mode runs on ``device="cpu"`` with the CPU zoo and
``int8_staging``; there only the task set and K1's staging count are
checked, never ``passed`` (wall-clock makespans).
"""
import math
import random

import pytest

import repro.core as rc
import repro.runtime as rr
import repro_torch.core as tc
import repro_torch.kernels.int8_quant as k1
import repro_torch.runtime as tr
import repro_torch.zoo as tz
from test_torch_sched_inputs import (
    PKGS,
    procs_and_profiler,
    random_arrival,
    random_fault,
    random_problem,
    serialize,
)

RUNTIMES = {"ref": rr, "port": tr}


def _nets(pkg):
    return [
        pkg.chain_graph("cfa", [("conv", 4e6, 1000, 4000)] * 5),
        pkg.branching_graph("cfb", [("conv", 2e6, 800, 2000)] * 4,
                            [(0, 1), (0, 2), (1, 3), (2, 3)]),
    ]


def _analyzer(pkg, groups=((0,), (1,)), arrival=None, faults=None, **cfg_kw):
    procs, prof = procs_and_profiler(pkg)
    scenario = pkg.Scenario(name="conf", graphs=_nets(pkg),
                            groups=[list(g) for g in groups], arrival=arrival,
                            faults=faults)
    return pkg.StaticAnalyzer(scenario, procs, prof, pkg.PAPER_COMM_MODEL,
                              pkg.AnalyzerConfig(**cfg_kw))


def _solutions(pkg, nets, count, seed=0):
    fac = pkg.SolutionFactory(nets, num_processors=3, rng=random.Random(seed))
    return [fac.random_solution() for _ in range(count)]


def _report_doc(rep):
    return rep.to_json(include_traces=True)


def _validate_both(sols_seed, count, analyzer_kw=None, **kw):
    """``validate_on_runtime`` over the same solutions in both packages."""
    out = {}
    for tag, pkg in PKGS.items():
        an = _analyzer(pkg, **(analyzer_kw or {}))
        reps = [an.validate_on_runtime(sol, **kw)
                for sol in _solutions(pkg, an.scenario.graphs, count,
                                      seed=sols_seed)]
        out[tag] = reps
    return out


def _assert_exact(rep):
    assert rep.mode == "virtual"
    assert rep.passed, rep.summary()
    assert rep.ordering_match
    assert rep.runtime_tasks == rep.sim_tasks > 0
    assert rep.max_release_diff == rep.max_start_diff == 0.0
    assert rep.max_finish_diff == rep.max_makespan_diff == 0.0
    assert rep.max_busy_diff == 0.0


# -- virtual conformance ------------------------------------------------------

@pytest.mark.parametrize("measured", [False, True])
def test_validate_on_runtime_virtual_zero_diff(measured):
    out = _validate_both(2, 3, alpha=1.0, num_requests=8, measured=measured,
                         seed=6)
    for rep in out["port"]:
        _assert_exact(rep)
    assert [_report_doc(r) for r in out["port"]] == \
        [_report_doc(r) for r in out["ref"]]


@pytest.mark.parametrize("arrival_kind", ["jittered", "poisson"])
def test_validate_on_runtime_nonperiodic_zero_diff(arrival_kind):
    out = {}
    for tag, pkg in PKGS.items():
        an = _analyzer(pkg, arrival=pkg.ArrivalSpec(kind=arrival_kind,
                                                    jitter=0.5, seed=13))
        out[tag] = [an.validate_on_runtime(sol, alpha=1.0, num_requests=8,
                                           measured=True, seed=6)
                    for sol in _solutions(pkg, an.scenario.graphs, 2, seed=8)]
    for rep in out["port"]:
        _assert_exact(rep)
    arrivals = [r[2] for r in out["port"][-1].runtime_trace["requests"]
                if r[0] == 0]
    gaps = {round(b - a, 12) for a, b in zip(arrivals, arrivals[1:])}
    assert len(gaps) > 1, "conformance replay ignored the arrival spec"
    assert [_report_doc(r) for r in out["port"]] == \
        [_report_doc(r) for r in out["ref"]]


def test_validate_on_runtime_overload_drops_match():
    """Dropped requests (overload) drop identically on both sides."""
    out = {}
    for tag, pkg in PKGS.items():
        an = _analyzer(pkg, groups=((0, 1),))
        sol = _solutions(pkg, an.scenario.graphs, 1, seed=4)[0]
        sol.partition = [[1] * g.num_edges for g in an.scenario.graphs]
        sol.mapping = [[0] * g.num_layers for g in an.scenario.graphs]
        out[tag] = an.validate_on_runtime(sol, alpha=0.001, num_requests=700,
                                          measured=True, seed=1)
    rep = out["port"]
    _assert_exact(rep)
    assert any(m is None for m in rep.sim_trace["makespans"])
    assert rep.runtime_trace["makespans"] == rep.sim_trace["makespans"]
    assert _report_doc(rep) == _report_doc(out["ref"])


def test_validate_on_runtime_under_faults_zero_diff():
    """The analyzer's fault ensemble reaches both sides (injected raw)."""
    out = {}
    for tag, pkg in PKGS.items():
        faults = pkg.FaultSpec(dropouts=((2, 0.012, None),),
                               throttles=((0, 0.002, 0.008, 3.0),),
                               straggler_prob=0.2, straggler_shape=1.5, seed=13)
        an = _analyzer(pkg, faults=faults)
        out[tag] = [an.validate_on_runtime(sol, num_requests=8, measured=True,
                                           seed=3)
                    for sol in _solutions(pkg, an.scenario.graphs, 3, seed=5)]
    for rep in out["port"]:
        _assert_exact(rep)
    assert [_report_doc(r) for r in out["port"]] == \
        [_report_doc(r) for r in out["ref"]]


def test_conformance_trace_uses_golden_schema():
    an = _analyzer(tc)
    sol = _solutions(tc, an.scenario.graphs, 1)[0]
    rep = an.validate_on_runtime(sol, num_requests=4)
    for trace in (rep.runtime_trace, rep.sim_trace):
        assert set(trace) == {"horizon", "busy_time", "requests",
                              "makespans", "tasks"}
        assert all(len(t) == 11 for t in trace["tasks"])
        assert all(len(r) == 7 for r in trace["requests"])
    doc = rep.to_json()
    assert doc["passed"] is True
    assert "runtime_trace" in doc and "sim_trace" in doc
    assert "runtime_trace" not in rep.to_json(include_traces=False)
    ref_an = _analyzer(rc)
    ref = ref_an.validate_on_runtime(
        _solutions(rc, ref_an.scenario.graphs, 1)[0], num_requests=4)
    assert rep.summary() == ref.summary()


def test_build_report_detects_divergence():
    """A perturbed trace fails the zero-tolerance comparison, with the same
    summary as the reference's."""
    out = {}
    for tag, pkg in PKGS.items():
        an = _analyzer(pkg)
        sol = _solutions(pkg, an.scenario.graphs, 1, seed=9)[0]
        a = an.simulate(sol, 1.0, 6, collect_tasks=True)
        b = an.simulate(sol, 1.0, 6, collect_tasks=True)
        ok = RUNTIMES[tag].build_report("virtual", a, b)
        assert ok.passed
        b.tasks[3].started += 1e-9
        bad = RUNTIMES[tag].build_report("virtual", a, b)
        assert not bad.passed and bad.max_start_diff > 0
        real = RUNTIMES[tag].build_report("real", a, b, rel_tol=0.35)
        out[tag] = (ok.summary(), bad.summary(), real.summary())
    assert out["port"] == out["ref"]


def test_apply_measured_costs_only_affected_solutions_change():
    out = {}
    for tag, pkg in PKGS.items():
        an = _analyzer(pkg)
        sols = _solutions(pkg, an.scenario.graphs, 6, seed=7)
        before = [an.objectives(s, num_requests=6) for s in sols]
        key = pkg.decode_solution(sols[0], an.scenario.graphs)[1][0].profile_key()
        an.apply_measured_costs({key: an.profiler.db.get(key) * 7.5})
        after = [an.objectives(s, num_requests=6) for s in sols]
        uses = [key in {p.profile_key()
                        for plist in pkg.decode_solution(s, an.scenario.graphs)
                        for p in plist} for s in sols]
        for u, b, a in zip(uses, before, after):
            assert (a != b) if u else (a == b)
        out[tag] = (before, after)
    assert out["port"] == out["ref"]


def test_conformance_holds_after_measured_update():
    out = {}
    for tag, pkg in PKGS.items():
        an = _analyzer(pkg)
        sol = _solutions(pkg, an.scenario.graphs, 1, seed=8)[0]
        key = pkg.decode_solution(sol, an.scenario.graphs)[0][0].profile_key()
        an.objectives(sol)
        an.apply_measured_costs({key: an.profiler.db.get(key) * 3.0})
        out[tag] = an.validate_on_runtime(sol, num_requests=8, measured=True)
    _assert_exact(out["port"])
    assert _report_doc(out["port"]) == _report_doc(out["ref"])


def test_unknown_mode_and_missing_executables_raise():
    an = _analyzer(tc)
    sol = an.factory.seeded_solution(0)
    with pytest.raises(ValueError, match="unknown conformance mode"):
        an.validate_on_runtime(sol, mode="bogus")
    with pytest.raises(ValueError, match="executables"):
        an.validate_on_runtime(sol, mode="real")


# -- the fault differential's virtual tier --------------------------------------

def _faulted_case(pkg, rng, measured, with_arrivals):
    """``_run_four_engines_faults`` of ``tests/test_fault_differential.py``:
    the same draws from ``rng``, in ``pkg``."""
    nets, groups, periods = random_problem(pkg, rng)
    fac = pkg.SolutionFactory(nets, num_processors=3,
                              rng=random.Random(rng.randrange(1 << 30)),
                              cut_prob=rng.uniform(0.1, 0.5))
    sol = fac.random_solution()
    num_requests = rng.randint(3, 6)
    faults = random_fault(pkg, rng, periods, num_requests)
    arrivals = (random_arrival(pkg, rng, periods, num_requests)
                if with_arrivals else None)
    noise = pkg.NoiseModel(seed=rng.randrange(1 << 16)) if measured else None
    return nets, sol, groups, periods, num_requests, noise, arrivals, faults


def _virtual_tiers(pkg, rt_pkg, case):
    nets, sol, groups, periods, nr, noise, arrivals, faults = case
    dispatch = 150e-6 if noise is not None else 0.0
    procs, prof = procs_and_profiler(pkg)
    placed = pkg.decode_solution(sol, nets)
    spec = pkg.build_spec(placed, procs, prof, pkg.PAPER_COMM_MODEL)
    virtual = rt_pkg.run_virtual_schedule(
        nets, sol, procs, spec, groups, periods, nr, noise=noise,
        dispatch_overhead=dispatch, arrivals=arrivals, faults=faults)
    fast = pkg.FastSimulator(
        spec, groups=groups, periods=periods, num_requests=nr, noise=noise,
        dispatch_overhead=dispatch, arrivals=arrivals, faults=faults,
    ).run(collect_tasks=True)
    return serialize(virtual), serialize(fast)


#: kind -> (base seed, measured, arrivals, cases) of the reference's sweep:
#: clean, measured, measured + non-periodic arrivals
SWEEPS = {"clean": (0xFA41, False, False, 40),
          "measured": (0x5E11, True, False, 40),
          "arrivals": (0xC0DE, True, True, 25)}


def _sweep_case(kind, i):
    base, measured, with_arrivals, _ = SWEEPS[kind]
    out = {}
    for tag, pkg in PKGS.items():
        case = _faulted_case(pkg, random.Random(base + i), measured,
                             with_arrivals)
        out[tag] = (_virtual_tiers(pkg, RUNTIMES[tag], case), case[-1])
    return out


@pytest.mark.parametrize("kind,i", [(k, i) for k in sorted(SWEEPS)
                                    for i in range(SWEEPS[k][3])])
def test_virtual_runtime_faults_match_reference(kind, i):
    out = _sweep_case(kind, i)
    (port_virtual, port_fast), _ = out["port"]
    (ref_virtual, ref_fast), _ = out["ref"]
    assert port_virtual == port_fast
    assert port_virtual == ref_virtual == ref_fast


def test_fault_sweep_exercises_every_fault_class():
    cov = set()
    for kind in SWEEPS:
        for i in range(SWEEPS[kind][3]):
            (doc, _), faults = _sweep_case(kind, i)["port"]
            if faults.dropped_pids():
                cov.add("permanent-dropout")
            if any(r is not None for _, _, r in faults.dropouts):
                cov.add("repairable-dropout")
            if faults.throttles:
                cov.add("throttle")
            if faults.straggler_prob > 0.0:
                cov.add("straggler")
            if any(m is None for m in doc["makespans"]):
                cov.add("dropped-request")
    assert cov >= {"permanent-dropout", "repairable-dropout", "throttle",
                   "straggler", "dropped-request"}, cov


# -- real mode, on the CPU --------------------------------------------------------

NAMES = ("face_det", "selfie_seg")


@pytest.fixture(scope="module")
def zoo():
    return tz.executable_zoo(NAMES, channels=4, spatial=8, device="cpu")


def _real_analyzer(zoo):
    procs = tc.mobile_processors()
    prof = tc.Profiler(tc.TorchExecBackend(zoo, repeats=1))
    scen = tc.build_scenario("conf-real", [(NAMES[0],), (NAMES[1],)],
                             {n: zoo[n].graph for n in NAMES})
    return tc.StaticAnalyzer(
        scen, procs, prof, tc.PAPER_COMM_MODEL, tc.AnalyzerConfig(),
        executables=zoo, device="cpu",
        runtime_config=tr.RuntimeConfig(int8_staging=True))


def _split_int8(graphs):
    """Each net cut at num_layers // 2 (skip edges too), halves on two
    processors, every dtype gene int8."""
    part, mapping = [], []
    for i, g in enumerate(graphs):
        h = g.num_layers // 2
        part.append([1 if e.src <= h < e.dst else 0 for e in g.edges])
        mapping.append([i % 3] * (h + 1) + [(i + 1) % 3] * (g.num_layers - h - 1))
    return tc.Solution(partition=part, mapping=mapping,
                       priority=list(range(len(graphs))),
                       dtype=[2] * len(graphs), backend=[0] * len(graphs))


def _staged_inputs(zoo, graphs, sol):
    """Boundary inputs one request of every net stages through K1."""
    n = 0
    for g, plist in zip(graphs, tc.decode_solution(sol, graphs)):
        for p in plist:
            if p.dtype == "int8" and p.subgraph.in_cut_edges():
                n += len(zoo[g.name].build_subgraph_fn(p.subgraph.layer_ids,
                                                       p.dtype)[1])
    return n


def test_validate_on_runtime_real_on_cpu(zoo, monkeypatch):
    an = _real_analyzer(zoo)
    graphs = an.scenario.graphs
    sol = _split_int8(graphs)
    plain = k1.quantize_int8_plain
    calls = []

    def counted(x, out=None):
        calls.append(tuple(x.shape))
        return plain(x, out)

    monkeypatch.setattr(k1, "quantize_int8_plain", counted)
    launches = k1.quantize_int8.launches
    nr = 3
    rep = an.validate_on_runtime(sol, mode="real", num_requests=nr)
    assert rep.mode == "real" and rep.rel_tol == 0.35
    keys = lambda tr_: {tuple(t[:4]) for t in tr_["tasks"]}  # noqa: E731
    assert keys(rep.runtime_trace) == keys(rep.sim_trace)
    assert rep.runtime_tasks == rep.sim_tasks == 4 * nr
    assert all(m is not None and math.isfinite(m)
               for m in rep.runtime_trace["makespans"])
    # rebased to the first submission: host-clock seconds from t = 0
    tasks = rep.runtime_trace["tasks"]
    assert min(r[2] for r in rep.runtime_trace["requests"]) == 0.0
    assert all(0.0 <= t[5] <= t[6] <= t[7] < 60.0 for t in tasks)
    assert len(calls) == nr * _staged_inputs(zoo, graphs, sol) > 0
    assert k1.quantize_int8.launches == launches


def test_validate_on_runtime_real_without_staging_calls_no_k1(zoo, monkeypatch):
    an = _real_analyzer(zoo)
    an.runtime_config = tr.RuntimeConfig()
    calls = []
    monkeypatch.setattr(k1, "quantize_int8_plain",
                        lambda *a, **kw: calls.append(a))
    rep = an.validate_on_runtime(_split_int8(an.scenario.graphs), mode="real",
                                 num_requests=2)
    assert rep.runtime_tasks == rep.sim_tasks and not calls
