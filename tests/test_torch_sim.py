"""The port's simulators against the JAX package's: bit-identical traces.

``repro_torch.core``'s RuntimeSimulator (the reference DES), FastSimulator
and BatchSimulator are copies of ``repro.core``'s. The same nets, solutions,
noise seeds, arrival processes and fault ensembles, built in both packages
from one seed, must give the same ``SimResult`` in every tier: task
records, request records, busy times and horizon, compared with ``==``
(tolerance: none). The six goldens of ``tests/golden/`` must come out of
the port's three simulator tiers and of its fourth tier, the virtual-clock
``PuzzleRuntime`` (``run_virtual_schedule``), bit for bit.
"""
import dataclasses
import json
import random
from pathlib import Path

import pytest

import repro.core as rc
import repro_torch.core as tc
from repro_torch.runtime import run_virtual_schedule, serialize_result
from test_torch_sched_inputs import (
    PKGS,
    conformance_mix,
    diamond_mix,
    procs_and_profiler,
    random_arrival,
    random_fault,
    random_problem,
    random_solution,
    serialize,
    three_tiers,
    tri_chain,
)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_DIR = ROOT / "tests" / "golden"


# -- the DES engine ----------------------------------------------------------

def _des_log(pkg):
    """The three scenarios of ``tests/test_des_simulator.py``'s engine tests."""
    env = pkg.Environment()
    log = []

    def proc(tag, delay):
        yield env.timeout(delay)
        log.append((tag, env.now))

    env.process(proc("b", 2.0))
    env.process(proc("a", 1.0))
    env.run()

    env = pkg.Environment()
    store = pkg.PriorityStore(env)

    def consumer():
        while True:
            item = yield store.get()
            log.append((item, env.now))

    def producer():
        yield env.timeout(1.0)
        store.put("low", priority=5)
        store.put("high", priority=1)
        yield env.timeout(1.0)
        store.put("later", priority=0)

    env.process(consumer())
    env.process(producer())
    env.run(until=10)

    env = pkg.Environment()
    store = pkg.PriorityStore(env)
    for item, prio in (("x", 1), ("y", 1), ("z", 0)):
        store.put(item, priority=prio)

    def drain():
        for _ in range(3):
            log.append((yield store.get()))

    env.process(drain())
    env.run()
    return log


def test_des_engine_matches_reference():
    log = _des_log(tc)
    assert log == _des_log(rc)
    assert log[:2] == [("a", 1.0), ("b", 2.0)]
    assert log[2:5] == [("low", 1.0), ("high", 1.0), ("later", 2.0)]
    assert log[5:] == ["z", "x", "y"]


# -- the goldens -------------------------------------------------------------

#: name -> (nets, groups, periods, num_requests, noise seed, dispatch, pin,
#:          arrivals, faults), as in ``tests/test_golden_traces.py``
def _golden_setup(pkg, name):
    return {
        "tri_chain_clean": (
            tri_chain(pkg), [[0, 1, 2]], [0.005], 8, None, 0.0, None, None,
            None),
        "diamond_mix_measured": (
            diamond_mix(pkg), [[0, 1], [2, 3]], [0.004, 0.006], 6, 7, 150e-6,
            None, None, None),
        "diamond_mix_overload": (
            diamond_mix(pkg), [[0, 1], [2, 3]], [2e-6, 2e-6], 30, None, 0.0, 0,
            None, None),
        "runtime_conformance": (
            conformance_mix(pkg), [[0, 2], [1]], [0.035, 0.05], 8, 3, 150e-6,
            None, None, None),
        "poisson_burst_measured": (
            diamond_mix(pkg), [[0, 1], [2, 3]], [0.004, 0.006], 8, 5, 150e-6,
            None, pkg.ArrivalSpec(kind="poisson", seed=42), None),
        "fault_dropout_mix": (
            diamond_mix(pkg), [[0, 1], [2, 3]], [0.004, 0.006], 8, 7, 150e-6,
            None, None,
            pkg.FaultSpec(
                dropouts=((2, 0.012, None),),
                throttles=((0, 0.002, 0.008, 3.0),),
                straggler_prob=0.2, straggler_shape=1.5, seed=13,
            )),
    }[name]


GOLDENS = ("tri_chain_clean", "diamond_mix_measured", "diamond_mix_overload",
           "runtime_conformance", "poisson_burst_measured", "fault_dropout_mix")


def _golden_case(name):
    golden = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    (nets, groups, periods, nr, noise_seed, dispatch, pin, arrivals,
     faults) = _golden_setup(tc, name)
    sol = random_solution(tc, nets, seed=11)
    if pin is not None:
        sol.partition = [[1] * g.num_edges for g in nets]
        sol.mapping = [[pin] * g.num_layers for g in nets]
    return golden, nets, sol, groups, periods, nr, noise_seed, dispatch, arrivals, faults


@pytest.mark.parametrize("name", GOLDENS)
def test_port_tiers_reproduce_golden(name):
    (golden, nets, sol, groups, periods, nr, noise_seed, dispatch, arrivals,
     faults) = _golden_case(name)
    tiers = three_tiers(tc, nets, sol, groups, periods, nr,
                        noise_seed=noise_seed, dispatch=dispatch,
                        arrivals=arrivals, faults=faults)
    for tier, got in tiers.items():
        assert got == golden, (name, tier)


@pytest.mark.parametrize("name", GOLDENS)
def test_virtual_runtime_reproduces_golden(name):
    """The fourth tier: the port's Coordinator/Worker dispatch code replaying
    the spec's costs on the virtual clock (no device)."""
    (golden, nets, sol, groups, periods, nr, noise_seed, dispatch, arrivals,
     faults) = _golden_case(name)
    procs, prof = procs_and_profiler(tc)
    spec = tc.build_spec(tc.decode_solution(sol, nets), procs, prof,
                         tc.PAPER_COMM_MODEL)
    noise = tc.NoiseModel(seed=noise_seed) if noise_seed is not None else None
    got = run_virtual_schedule(nets, sol, procs, spec, groups, periods, nr,
                               noise=noise, dispatch_overhead=dispatch,
                               arrivals=arrivals, faults=faults)
    assert serialize_result(got) == golden, name


# -- port against reference, case by case ------------------------------------

def _case(pkg, kind, seed):
    """One randomized case of ``kind``, built in ``pkg`` from ``seed``."""
    rng = random.Random(seed * 7919 + len(kind))
    nets, groups, periods = random_problem(pkg, rng)
    sol = random_solution(pkg, nets, seed=rng.randrange(1 << 30),
                          cut_prob=rng.uniform(0.1, 0.5))
    kw = dict(num_requests=rng.randint(3, 6))
    if kind in ("measured", "arrivals", "faults-measured", "overlap"):
        kw.update(noise_seed=rng.randrange(1 << 16), dispatch=150e-6)
    if kind == "overlap":
        kw.update(overlap_comm=True, input_home_pid=2)
    if kind == "arrivals":
        kw["arrivals"] = random_arrival(pkg, rng, periods, kw["num_requests"])
    if kind in ("faults", "faults-measured"):
        kw["faults"] = random_fault(pkg, rng, periods, kw["num_requests"])
    if kind == "overload":
        periods = [2e-6 for _ in groups]
        kw["num_requests"] = 40
    return three_tiers(pkg, nets, sol, groups, periods, **kw)


KINDS = ("clean", "measured", "overlap", "arrivals", "faults",
         "faults-measured", "overload")


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("kind", KINDS)
def test_tiers_match_reference(kind, seed):
    port, ref = _case(tc, kind, seed), _case(rc, kind, seed)
    for tier in ref:
        assert port[tier] == ref[tier], (kind, seed, tier)
        assert port[tier] == ref["reference-des"], (kind, seed, tier)


def test_overload_cases_drop_requests():
    """The overload kind really reaches inf makespans (as the reference's
    ``test_bulk_parity_overload`` demands of its cases)."""
    dropped = [None in _case(tc, "overload", s)["batchsim"]["makespans"]
               for s in range(3)]
    assert any(dropped)


def test_measured_noise_varies_and_is_seeded():
    nets = diamond_mix(tc)
    sol = random_solution(tc, nets, seed=3)
    runs = [three_tiers(tc, nets, sol, [[0, 1], [2, 3]], [0.004, 0.006], 5,
                        noise_seed=s, dispatch=150e-6)["fastsim"]
            for s in (1, 1, 2)]
    assert runs[0] == runs[1]
    assert runs[0]["makespans"] != runs[2]["makespans"]


@pytest.mark.parametrize("measured", [False, True])
def test_from_placed_matches_reference(measured):
    """``FastSimulator.from_placed`` (the path of ``tests/test_fastsim.py``)."""
    out = {}
    for tag, pkg in PKGS.items():
        nets = diamond_mix(pkg)
        procs, prof = procs_and_profiler(pkg)
        placed = pkg.decode_solution(random_solution(pkg, nets, seed=23), nets)
        noise = pkg.NoiseModel(seed=4) if measured else None
        out[tag] = serialize(pkg.FastSimulator.from_placed(
            placed, procs, prof, pkg.PAPER_COMM_MODEL, [[0, 1], [2, 3]],
            [0.004, 0.006], num_requests=8, noise=noise,
            dispatch_overhead=150e-6 if measured else 0.0).run())
    assert out["port"] == out["ref"]


def test_subgraph_task_costs_and_dependencies_match():
    out = {}
    for tag, pkg in PKGS.items():
        nets = diamond_mix(pkg)
        procs, prof = procs_and_profiler(pkg)
        placed = pkg.decode_solution(random_solution(pkg, nets, seed=5), nets)
        deps, succs, owners = pkg.derive_dependencies(placed)
        costs = [pkg.subgraph_task_costs(placed, net, k, owners[net],
                                         bool(deps[net][k]), prof,
                                         pkg.PAPER_COMM_MODEL, home)
                 for home in (0, 2)
                 for net, plist in enumerate(placed) for k in range(len(plist))]
        out[tag] = (deps, succs, owners, costs)
    assert out["port"] == out["ref"]


# -- the batch tier -----------------------------------------------------------

def _lanes(pkg, seed):
    rng = random.Random(seed)
    nets, groups, periods = random_problem(pkg, rng)
    procs, prof = procs_and_profiler(pkg)
    fac = pkg.SolutionFactory(nets, num_processors=len(procs),
                              rng=random.Random(seed), cut_prob=0.3)
    specs = [pkg.build_spec(pkg.decode_solution(fac.random_solution(), nets),
                            procs, prof, pkg.PAPER_COMM_MODEL)
             for _ in range(5)]
    lanes = [
        pkg.BatchLane(spec=sp, periods=periods, num_requests=3 + (i % 3),
                      noise=pkg.NoiseModel(seed=i) if i % 2 else None,
                      dispatch_overhead=150e-6 if i % 2 else 0.0)
        for i, sp in enumerate(specs)
    ]
    return lanes, groups, procs


@pytest.mark.parametrize("seed", [1, 2])
def test_batch_objectives_and_width_invariance_match(seed):
    out = {}
    for tag, pkg in PKGS.items():
        lanes, groups, procs = _lanes(pkg, seed)
        wide = pkg.run_batch(lanes, groups, procs)
        solos = [pkg.BatchSimulator([lane], groups, procs).run().makespans(0)
                 for lane in lanes]
        assert [wide.makespans(i) for i in range(len(lanes))] == solos
        out[tag] = (pkg.batch_objectives(wide),
                    [serialize(wide.result(i)) for i in range(len(lanes))])
    assert out["port"] == out["ref"]


def test_batch_sharding_across_processes_is_bit_identical():
    """The process-pool path (spawned workers): sharded lanes stitch back to
    the in-process results, tasks included."""
    lanes, groups, procs = _lanes(tc, 7)
    lanes = lanes * 4
    one = tc.run_batch(lanes, groups, procs, collect_tasks=True)
    two = tc.run_batch(lanes, groups, procs, collect_tasks=True, workers=2,
                       shard_min_lanes=0)
    assert tc.batch_objectives(one) == tc.batch_objectives(two)
    for i in range(len(lanes)):
        assert serialize(one.result(i)) == serialize(two.result(i))


def test_compiled_batch_engine_waits_for_slice_6c():
    lanes, groups, procs = _lanes(tc, 1)
    with pytest.raises(NotImplementedError, match="6c"):
        tc.run_batch(lanes, groups, procs, engine="compiled")
    with pytest.raises(ValueError):
        tc.run_batch(lanes, groups, procs, engine="jax")
    assert tc.SHARD_MIN_LANES == rc.SHARD_MIN_LANES


# -- faults and the comm model ------------------------------------------------

def test_fault_specs_and_stream_match():
    for seed in range(6):
        specs = {}
        for tag, pkg in PKGS.items():
            rng = random.Random(seed)
            spec = random_fault(pkg, rng, [0.004, 0.006], 6)
            stream = pkg.FaultStream(spec)
            draws = [stream.service(i % 3, 0.001 * i, 1.0 + 0.01 * i)
                     for i in range(40)]
            specs[tag] = (spec.key(), spec.to_json(), spec.dropped_pids(),
                          spec.empty, draws)
        assert specs["port"] == specs["ref"]
        assert tc.FaultSpec.from_json(specs["port"][1]).key() == specs["port"][0]
    assert tc.NO_FAULTS.empty
    with pytest.raises(ValueError):
        tc.FaultSpec(straggler_prob=1.0)


def test_comm_model_matches():
    sizes = [0, 1, 1000, 1 << 20, (1 << 20) + 1, 10 << 20, 3.7e7]
    assert [tc.PAPER_COMM_MODEL.cost(n) for n in sizes] == \
        [rc.PAPER_COMM_MODEL.cost(n) for n in sizes]
    assert [tc.quantization_cost(n) for n in sizes] == \
        [rc.quantization_cost(n) for n in sizes]
    samples = [(float(2 ** k), 1e-5 + 3e-11 * 2 ** k + (2e-5 if k > 20 else 0))
               for k in range(8, 26)]
    fit_t = tc.PiecewiseLinearCommModel.fit(samples)
    fit_r = rc.PiecewiseLinearCommModel.fit(samples)
    assert dataclasses.asdict(fit_t) == dataclasses.asdict(fit_r)
    host = tc.microbenchmark_host(sizes=(1 << 12, 1 << 16), repeats=2)
    assert [n for n, _ in host] == [4096.0, 65536.0]
    assert all(t > 0 for _, t in host)
    assert not hasattr(tc, "TPU_COMM_MODEL")
