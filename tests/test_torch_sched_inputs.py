"""Inputs shared by the scheduler parity tests (``tests/test_torch_sim.py``,
``test_torch_search.py``, ``test_torch_analyzer.py``); it holds no tests.

Every function here takes the package (``repro.core`` or ``repro_torch.core``) and
draws from a ``random.Random`` the test owns, so both packages get the same
nets, solutions, arrival processes and fault ensembles from one seed. The
recipes are the reference tests' (``tests/test_batchsim_properties.py``,
``test_fault_differential.py``, ``test_fastsim.py``).
"""
import math
import random

import repro.core as rc
import repro_torch.core as tc

PKGS = {"ref": rc, "port": tc}


def serialize(res):
    """The golden-trace schema (``tests/golden/*.json``) of a SimResult."""
    return {
        "horizon": res.horizon,
        "busy_time": {str(pid): t for pid, t in sorted(res.busy_time.items())},
        "requests": [
            [r.group, r.request, r.arrival, r.first_start, r.last_finish,
             r.done_tasks, r.total_tasks]
            for r in res.requests
        ],
        "makespans": [
            None if math.isinf(r.makespan) else r.makespan
            for r in res.requests
        ],
        "tasks": [
            [t.group, t.request, t.network, t.sg_index, t.processor,
             t.released, t.started, t.finished,
             t.comm_time, t.quant_time, t.exec_time]
            for t in res.tasks
        ],
    }


def procs_and_profiler(pkg):
    procs = pkg.mobile_processors()
    return procs, pkg.Profiler(pkg.AnalyticMobileBackend(procs))


def diamond_mix(pkg):
    """The four nets of ``tests/test_fastsim.py`` and the golden traces."""
    return [
        pkg.chain_graph("a", [("conv", 4e6, 1000, 4000)] * 5),
        pkg.branching_graph("b", [("conv", 2e6, 800, 2000)] * 4,
                            [(0, 1), (0, 2), (1, 3), (2, 3)]),
        pkg.chain_graph("c", [("fc", 8e6, 2000, 8000)] * 3),
        pkg.branching_graph("d", [("conv", 3e6, 500, 1500)] * 5,
                            [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4)]),
    ]


def tri_chain(pkg):
    return [
        pkg.chain_graph("alpha", [("conv", 4e6, 1000, 4000)] * 4),
        pkg.chain_graph("beta", [("fc", 8e6, 2000, 8000)] * 3),
        pkg.chain_graph("gamma", [("dw", 1.5e6, 600, 1800)] * 5),
    ]


def random_problem(pkg, rng):
    """``_random_problem`` of ``tests/test_batchsim_properties.py``."""
    n_nets = rng.randint(2, 4)
    nets = []
    for n in range(n_nets):
        n_layers = rng.randint(2, 5)
        layers = [
            (rng.choice(["conv", "fc", "dw"]),
             rng.uniform(5e5, 8e6),
             rng.uniform(200, 3000),
             rng.uniform(500, 6000))
            for _ in range(n_layers)
        ]
        if rng.random() < 0.5 or n_layers < 3:
            g = pkg.chain_graph(f"n{n}", layers)
        else:
            edges = [(i, i + 1) for i in range(n_layers - 1)]
            edges += [(0, n_layers - 1)]
            g = pkg.branching_graph(f"n{n}", layers, edges)
        nets.append(g)
    if n_nets == 2 or rng.random() < 0.4:
        groups = [list(range(n_nets))]
    else:
        cut = rng.randint(1, n_nets - 1)
        groups = [list(range(cut)), list(range(cut, n_nets))]
    periods = [rng.uniform(0.0005, 0.006) for _ in groups]
    return nets, groups, periods


def random_arrival(pkg, rng, periods, num_requests):
    """``_random_arrival`` of ``tests/test_batchsim_properties.py``."""
    kind = rng.choice(("periodic", "jittered", "jittered-lognormal",
                       "poisson", "trace"))
    if kind == "periodic":
        return rng.choice((None, pkg.ArrivalSpec()))
    if kind == "jittered":
        return pkg.ArrivalSpec(kind="jittered", jitter=rng.uniform(0.05, 1.5),
                               seed=rng.randrange(1 << 16))
    if kind == "jittered-lognormal":
        return pkg.ArrivalSpec(kind="jittered", distribution="lognormal",
                               jitter=rng.uniform(0.1, 0.8),
                               sigma=rng.uniform(0.1, 0.9),
                               seed=rng.randrange(1 << 16))
    if kind == "poisson":
        return pkg.ArrivalSpec(kind="poisson", seed=rng.randrange(1 << 16))
    trace = []
    for period in periods:
        n = rng.randint(0, num_requests + 2)
        ts = [rng.uniform(0.0, num_requests * period) for _ in range(n)]
        if ts and rng.random() < 0.5:
            ts.sort()
        if ts and rng.random() < 0.3:
            ts[rng.randrange(len(ts))] = ts[0]
        trace.append(tuple(ts))
    return pkg.ArrivalSpec(kind="trace", trace=tuple(trace))


def random_fault(pkg, rng, periods, num_requests, num_procs=3):
    """``_random_fault`` of ``tests/test_fault_differential.py``."""
    span = max(periods) * num_requests
    dropouts = []
    for _ in range(rng.randint(0, 2)):
        pid = rng.randrange(num_procs)
        start = rng.uniform(0.0, span)
        repair = None if rng.random() < 0.5 else rng.uniform(
            0.05 * span, 0.5 * span)
        dropouts.append((pid, start, repair))
    throttles = []
    for _ in range(rng.randint(0, 2)):
        pid = rng.randrange(num_procs)
        t0 = rng.uniform(0.0, 0.8 * span)
        throttles.append((pid, t0, t0 + rng.uniform(0.05 * span, 0.6 * span),
                          rng.choice((0.5, 1.5, 2.0, 4.0))))
    prob = rng.choice((0.0, 0.1, 0.25, 0.5))
    spec = pkg.FaultSpec(
        dropouts=tuple(dropouts), throttles=tuple(throttles),
        straggler_prob=prob,
        straggler_shape=rng.choice((0.8, 1.5, 2.5)),
        seed=rng.randrange(1 << 16),
    )
    if spec.empty:
        spec = pkg.FaultSpec(straggler_prob=0.25, straggler_shape=1.5,
                             seed=rng.randrange(1 << 16))
    return spec


def three_tiers(pkg, nets, sol, groups, periods, num_requests, noise_seed=None,
                dispatch=0.0, arrivals=None, faults=None, overlap_comm=False,
                input_home_pid=0):
    """One solution through ``pkg``'s RuntimeSimulator, FastSimulator and
    BatchSimulator; returns their serialized results by tier."""
    procs, prof = procs_and_profiler(pkg)
    placed = pkg.decode_solution(sol, nets)
    noise = pkg.NoiseModel(seed=noise_seed) if noise_seed is not None else None
    ref = pkg.RuntimeSimulator(
        placed=placed, processors=procs, profiler=prof,
        comm_model=pkg.PAPER_COMM_MODEL, groups=groups, periods=periods,
        num_requests=num_requests, input_home_pid=input_home_pid,
        overlap_comm=overlap_comm, noise=noise, dispatch_overhead=dispatch,
        arrivals=arrivals, faults=faults,
    ).run()
    spec = pkg.build_spec(placed, procs, prof, pkg.PAPER_COMM_MODEL,
                          input_home_pid=input_home_pid)
    fast = pkg.FastSimulator(
        spec, groups=groups, periods=periods, num_requests=num_requests,
        overlap_comm=overlap_comm, noise=noise, dispatch_overhead=dispatch,
        arrivals=arrivals, faults=faults,
    ).run(collect_tasks=True)
    batch = pkg.BatchSimulator(
        [pkg.BatchLane(spec=spec, periods=periods, num_requests=num_requests,
                       noise=noise, dispatch_overhead=dispatch,
                       overlap_comm=overlap_comm, arrivals=arrivals,
                       faults=faults)],
        groups, procs,
    ).run(collect_tasks=True).result(0)
    return {"reference-des": serialize(ref), "fastsim": serialize(fast),
            "batchsim": serialize(batch)}


def random_solution(pkg, nets, seed, cut_prob=0.35, num_procs=3):
    fac = pkg.SolutionFactory(nets, num_processors=num_procs,
                              rng=random.Random(seed), cut_prob=cut_prob)
    return fac.random_solution()


def analyzer(pkg, nets=None, names=(("a", "b"), ("c", "d")), **cfg_kw):
    """A ``StaticAnalyzer`` over the diamond-mix nets (``tests/test_fastsim.py``)."""
    nets = nets if nets is not None else diamond_mix(pkg)
    procs, prof = procs_and_profiler(pkg)
    scen = pkg.build_scenario("parity", [list(g) for g in names],
                              {g.name: g for g in nets},
                              arrival=cfg_kw.pop("arrival", None),
                              faults=cfg_kw.pop("faults", None))
    return pkg.StaticAnalyzer(scen, procs, prof, pkg.PAPER_COMM_MODEL,
                              pkg.AnalyzerConfig(**cfg_kw))
