"""The port's compiled batch tier on the CPU, against the bit-exact tiers.

Counterpart of ``tests/test_batchsim_compiled.py`` and of
``test_batchsim_properties.py::test_compiled_tier_differential_spot_check``.
The reference's compiled tier cannot be the oracle (it fails to import on
the jax these tests run with), so ``run_batch_compiled(..., device="cpu")``
(the kernel's plain torch pass) is held to the reference's numpy
``BatchSimulator`` on the same inputs built in both packages from one seed,
and to the port's ``FastSimulator``, within ``COMPILED_REL_TOL`` relative /
``COMPILED_ABS_TOL`` absolute per reported float (done counts exact, inf
agreeing with inf). Each comparison prints the largest difference it saw;
``last_stats`` is asserted on so that a silent numpy fallback cannot pass
for compiled coverage. The kernel itself is held to the same oracles on the
card by ``tests/test_torch_batchsim_cuda.py``.
"""
import json
import math
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
import repro_torch.core.batchsim_compiled as bsc
from repro_torch.analysis.lint import GOLDENS, golden_setup, golden_solution
from repro_torch.kernels import batchsim_advance as kb
from test_torch_sched_inputs import (
    analyzer,
    procs_and_profiler,
    random_arrival,
    random_problem,
)

GOLDEN_DIR = Path(__file__).resolve().parent / "golden"


def _close(a, b):
    """The documented compiled-tier tolerance, inf-aware."""
    if math.isinf(a) or math.isinf(b):
        return math.isinf(a) and math.isinf(b)
    return abs(a - b) <= tc.COMPILED_ABS_TOL + tc.COMPILED_REL_TOL * max(abs(a), abs(b))


def _assert_lane_close(ref_res, comp_res, tag):
    """Per-lane SimResult comparison under the tolerance contract; returns
    the largest finite difference."""
    diff = 0.0

    def check(a, b, what):
        nonlocal diff
        assert _close(a, b), (tag, what, a, b)
        if not (math.isinf(a) or math.isinf(b)):
            diff = max(diff, abs(a - b))

    assert ref_res.busy_time.keys() == comp_res.busy_time.keys(), tag
    for pid in ref_res.busy_time:
        check(ref_res.busy_time[pid], comp_res.busy_time[pid], ("busy", pid))
    assert len(ref_res.requests) == len(comp_res.requests), tag
    for qa, qb in zip(ref_res.requests, comp_res.requests):
        assert qa.done_tasks == qb.done_tasks, (tag, qa, qb)
        assert qa.total_tasks == qb.total_tasks, (tag, qa, qb)
        for f in ("arrival", "first_start", "last_finish", "makespan"):
            check(getattr(qa, f), getattr(qb, f), (f, qa.group, qa.request))
    return diff


def _compiled(lanes, groups, procs):
    comp = tc.run_batch_compiled(lanes, groups, procs, device="cpu")
    assert comp is not None, bsc.last_stats
    assert bsc.last_stats["fallback"] is False, bsc.last_stats
    return comp


# -- golden traces -------------------------------------------------------------

def _golden_lane(name):
    (nets, groups, periods, nr, noise_seed, dispatch, pin, arrivals,
     faults) = golden_setup(name)
    procs, prof = procs_and_profiler(tc)
    sol = golden_solution(nets, pin=pin)
    spec = tc.build_spec(tc.decode_solution(sol, nets), procs, prof, tc.PAPER_COMM_MODEL)
    noise = tc.NoiseModel(seed=noise_seed) if noise_seed is not None else None
    lane = tc.BatchLane(spec=spec, periods=periods, num_requests=nr, noise=noise,
                        dispatch_overhead=dispatch, arrivals=arrivals, faults=faults)
    return lane, groups, procs


@pytest.mark.parametrize("name", GOLDENS)
def test_compiled_reproduces_golden_trace(name):
    """Every committed golden trace replays through the compiled tier within
    the documented tolerance (done counts exact, inf == inf), and the lane
    equals the numpy tier's."""
    lane, groups, procs = _golden_lane(name)
    res = _compiled([lane], groups, procs).result(0)
    golden = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    assert _close(res.horizon, golden["horizon"])
    assert {str(p) for p in res.busy_time} == set(golden["busy_time"])
    for pid, t in res.busy_time.items():
        assert _close(t, golden["busy_time"][str(pid)]), ("busy", pid)
    assert len(res.requests) == len(golden["requests"])
    for r, row in zip(res.requests, golden["requests"]):
        group, request, arrival, first_start, last_finish, done, total = row
        assert (r.group, r.request) == (group, request)
        assert r.done_tasks == done and r.total_tasks == total
        assert _close(r.arrival, arrival)
        assert _close(r.first_start, first_start)
        assert _close(r.last_finish, last_finish)
    for r, gm in zip(res.requests, golden["makespans"]):
        assert math.isinf(r.makespan) if gm is None else _close(r.makespan, gm)
    diff = _assert_lane_close(tc.BatchSimulator([lane], groups, procs).run().result(0),
                              res, name)
    print(f"{name}: max |compiled - numpy| = {diff!r}")


# -- differential: compiled vs the reference's numpy tier vs fastsim -------

def _make_lanes(pkg, seed, n_lanes, measured, arrivals_on, faults_on):
    """``_make_lanes`` of ``tests/test_batchsim_compiled.py``, built in ``pkg``."""
    rng = random.Random(seed)
    procs, prof = procs_and_profiler(pkg)
    nets, groups, periods = random_problem(pkg, rng)
    fac = pkg.SolutionFactory(nets, num_processors=len(procs),
                              rng=random.Random(rng.randrange(1 << 30)),
                              cut_prob=rng.uniform(0.1, 0.5))
    lanes = []
    for _ in range(n_lanes):
        spec = pkg.build_spec(pkg.decode_solution(fac.random_solution(), nets), procs, prof,
                              pkg.PAPER_COMM_MODEL)
        nr = rng.randint(3, 6)
        noise = pkg.NoiseModel(seed=rng.randrange(1 << 16)) if measured else None
        arr = random_arrival(pkg, rng, periods, nr) if arrivals_on else None
        faults = None
        if faults_on and rng.random() < 0.7:
            faults = pkg.FaultSpec(
                dropouts=((rng.randrange(len(procs)), rng.uniform(0, 0.01),
                           None if rng.random() < 0.5 else rng.uniform(0.001, 0.01)),),
                throttles=((rng.randrange(len(procs)), 0.0, rng.uniform(0.002, 0.02),
                            rng.uniform(1.5, 4.0)),),
                straggler_prob=rng.choice([0.0, 0.2, 0.5]), straggler_shape=1.5,
                seed=rng.randrange(1 << 16),
            )
        lanes.append(pkg.BatchLane(spec=spec, periods=periods, num_requests=nr, noise=noise,
                                   dispatch_overhead=150e-6 if measured else 0.0,
                                   arrivals=arr, faults=faults))
    return lanes, groups, procs


def _compare_tiers(tag, seed, n_lanes, **kw):
    lanes, groups, procs = _make_lanes(tc, seed, n_lanes, **kw)
    ref_lanes, ref_groups, ref_procs = _make_lanes(rc, seed, n_lanes, **kw)
    ref = rc.BatchSimulator(ref_lanes, ref_groups, ref_procs).run()
    comp = _compiled(lanes, groups, procs)
    diff = 0.0
    for i, lane in enumerate(lanes):
        diff = max(diff, _assert_lane_close(ref.result(i), comp.result(i), (tag, i)))
        fast = tc.FastSimulator(
            lane.spec, groups=groups, periods=lane.periods,
            num_requests=lane.num_requests, noise=lane.noise,
            dispatch_overhead=lane.dispatch_overhead,
            arrivals=lane.arrivals, faults=lane.faults,
        ).run()
        diff = max(diff, _assert_lane_close(fast, comp.result(i), (tag, i, "fastsim")))
    print(f"{tag}: max |compiled - numpy, fastsim| = {diff!r}")


@pytest.mark.parametrize("seed", [0, 1])
def test_compiled_differential_clean(seed):
    _compare_tiers(f"clean-{seed}", 5000 + seed, 4, measured=False, arrivals_on=False,
                   faults_on=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compiled_differential_arrivals(seed):
    """Jittered / poisson / trace arrivals + noise + dispatch tokens."""
    _compare_tiers(f"arrivals-{seed}", 6000 + seed, 4, measured=True, arrivals_on=True,
                   faults_on=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compiled_differential_faults(seed):
    """Dropout + throttle + straggler ensembles on top of noise."""
    _compare_tiers(f"faults-{seed}", 7000 + seed, 4, measured=True, arrivals_on=True,
                   faults_on=True)


def test_compiled_tier_differential_spot_check():
    """The counterpart of ``test_batchsim_properties.py``'s spot check:
    arrivals + noise + dispatch tokens, then a fault ensemble, three lanes
    each, against the numpy tier and fastsim."""
    procs, prof = procs_and_profiler(tc)
    for seed, faulted in ((0xC0119, False), (0xC011A, True)):
        rng = random.Random(seed)
        nets, groups, periods = random_problem(tc, rng)
        fac = tc.SolutionFactory(nets, num_processors=len(procs),
                                 rng=random.Random(seed + 1), cut_prob=0.3)
        lanes = []
        for _ in range(3):
            spec = tc.build_spec(tc.decode_solution(fac.random_solution(), nets), procs,
                                 prof, tc.PAPER_COMM_MODEL)
            nr = rng.randint(3, 6)
            faults = tc.FaultSpec(
                dropouts=((rng.randrange(len(procs)), 0.0, 0.004),),
                straggler_prob=0.3, straggler_shape=1.5, seed=rng.randrange(1 << 16),
            ) if faulted else None
            lanes.append(tc.BatchLane(
                spec=spec, periods=periods, num_requests=nr,
                noise=tc.NoiseModel(seed=rng.randrange(1 << 16)), dispatch_overhead=150e-6,
                arrivals=random_arrival(tc, rng, periods, nr), faults=faults))
        comp = _compiled(lanes, groups, procs)
        ref = tc.BatchSimulator(lanes, groups, procs).run()
        for i, lane in enumerate(lanes):
            fast = tc.FastSimulator(
                lane.spec, groups=groups, periods=lane.periods,
                num_requests=lane.num_requests, noise=lane.noise,
                dispatch_overhead=lane.dispatch_overhead, arrivals=lane.arrivals,
                faults=lane.faults).run()
            for tier in (ref.result(i), fast):
                _assert_lane_close(tier, comp.result(i), (seed, i))


def test_compiled_overload_inf_parity():
    """Deep-queue overload: dropped requests (inf makespans) and partial
    done counts agree with the numpy tier; the FIFO rings must not overflow
    at the host-computed capacity bound."""
    def lanes_of(pkg):
        rng = random.Random(99)
        procs, prof = procs_and_profiler(pkg)
        nets, groups, periods = random_problem(pkg, rng)
        periods = tuple(p * 0.01 for p in periods)  # ~100x arrival rate
        fac = pkg.SolutionFactory(nets, num_processors=len(procs),
                                  rng=random.Random(2), cut_prob=0.3)
        lanes = [pkg.BatchLane(spec=pkg.build_spec(pkg.decode_solution(
                     fac.random_solution(), nets), procs, prof, pkg.PAPER_COMM_MODEL),
                     periods=periods, num_requests=20, dispatch_overhead=150e-6)
                 for _ in range(6)]
        return lanes, groups, procs

    ref = rc.BatchSimulator(*lanes_of(rc)).run()
    comp = _compiled(*lanes_of(tc))
    dropped = 0
    for i in range(6):
        _assert_lane_close(ref.result(i), comp.result(i), ("overload", i))
        dropped += sum(math.isinf(m) for m in ref.makespans(i))
    assert dropped, "overload scenario dropped no requests"


# -- fallback contract ----------------------------------------------------------

def test_run_batch_compiled_collect_tasks_falls_back_bitexact():
    """engine="compiled" with collect_tasks routes to numpy (task traces are
    python-side by design), counted as such: results bit-identical."""
    lanes, groups, procs = _make_lanes(tc, 31, 3, measured=True, arrivals_on=False,
                                       faults_on=False)
    before = bsc.fallbacks["collect-tasks"]
    ref = tc.run_batch(lanes, groups, procs, collect_tasks=True)
    via = tc.run_batch(lanes, groups, procs, collect_tasks=True, engine="compiled",
                       device="cpu")
    assert bsc.last_stats["reason"] == "collect-tasks"
    assert bsc.fallbacks["collect-tasks"] == before + 1
    for i in range(len(lanes)):
        assert ref.makespans(i) == via.makespans(i)
        assert ref.result(i).busy_time == via.result(i).busy_time
        assert ref.result(i).tasks == via.result(i).tasks


def test_run_batch_compiled_queue_bound_fallback():
    """A workload whose released-task bound exceeds QUEUE_CAP_MAX is declined
    before launch; run_batch reruns it on numpy and counts it."""
    lanes, groups, procs = _make_lanes(tc, 32, 2, measured=False, arrivals_on=False,
                                       faults_on=False)
    big = [tc.BatchLane(spec=ln.spec, periods=ln.periods, num_requests=4000) for ln in lanes]
    assert tc.run_batch_compiled(big, groups, procs, device="cpu") is None
    assert bsc.last_stats["fallback"] is True
    assert bsc.last_stats["reason"] == "queue-bound"
    before = bsc.fallbacks["queue-bound"]
    small = [tc.BatchLane(spec=ln.spec, periods=ln.periods, num_requests=3) for ln in lanes]
    # the bound is per batch: the same specs at 3 requests run compiled
    assert tc.run_batch_compiled(small, groups, procs, device="cpu") is not None
    assert bsc.fallbacks["queue-bound"] == before


def _planted(prep, fault):
    """A prepared batch whose loop must trip: a ring of one slot (overflow)
    or an iteration cap of three events."""
    key, value = ("CAP", 1) if fault == "overflow" else ("itercap", 3)
    prep.sizes[key] = value
    prep.packed[kb.HEADER.index(key)] = value
    return prep


@pytest.mark.parametrize("fault", ["overflow", "itercap"])
def test_loop_fault_raises_instead_of_falling_back(fault):
    """Once the loop has run, a ring overflow or a lane at the iteration cap
    raises and names the lane: the loop is at fault, and its answer is not
    swapped for the numpy tier's. Nothing is counted as a fallback."""
    lane, groups, procs = _golden_lane("diamond_mix_overload")
    prep = _planted(bsc.prepare_batch([lane], groups, procs), fault)
    before = dict(bsc.fallbacks)
    why = "overflowed" if fault == "overflow" else "iteration cap 3"
    with pytest.raises(RuntimeError, match=rf"lanes \[0\] of 1: .*{why}"):
        bsc.run_prepared(prep, torch.device("cpu"))
    assert bsc.fallbacks == before
    assert set(bsc.fallbacks) == {"collect-tasks", "queue-bound"}


def test_run_batch_unknown_engine_rejected():
    lanes, groups, procs = _make_lanes(tc, 33, 1, measured=False, arrivals_on=False,
                                       faults_on=False)
    with pytest.raises(ValueError, match="unknown batch engine"):
        tc.run_batch(lanes, groups, procs, engine="bogus")


def test_compiled_without_card_needs_device_cpu(monkeypatch):
    """No card and no ``device``: the compiled tier raises, it does not fall
    back to the CPU or to numpy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lanes, groups, procs = _make_lanes(tc, 34, 1, measured=False, arrivals_on=False,
                                       faults_on=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.run_batch_compiled(lanes, groups, procs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.run_batch(lanes, groups, procs, engine="compiled")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.run_batch(lanes, groups, procs, engine="compiled", device="cuda")


def test_packed_tables_round_trip():
    """What the kernel reads is what the host prepared: every table of the
    packed buffer unpacks to its values, in its shape."""
    rng = np.random.default_rng(0)
    sizes = dict(W=3, G=2, P=3, NP=2, CAP=8, S=4, NR=2, J=2, DM=2, ZC=4, FC=2, T=1, D=1,
                 any_noise=1, any_fault=0, any_strag=1, any_dispatch=1, itercap=77)
    tab = {}
    for name, kind, shape in kb.TABLES:
        dims = tuple(sizes[d] for d in shape)
        tab[name] = (rng.standard_normal(dims) if kind == "f8"
                     else rng.integers(-5, 5, dims) if kind == "i8"
                     else rng.random(dims) < 0.5)
    got_sizes, got = kb.unpack_tables(kb.pack_tables(sizes, tab))
    assert got_sizes == sizes
    for name, kind, _ in kb.TABLES:
        assert np.array_equal(got[name].numpy(), tab[name]), name
    with pytest.raises(ValueError, match="shape"):
        kb.pack_tables(dict(sizes, W=4), tab)


def test_batchsim_advance_on_cpu_is_the_plain_pass():
    """A CPU buffer never reaches the kernel: no launch is counted."""
    lane, groups, procs = _golden_lane("tri_chain_clean")
    before = kb.batchsim_advance.launches
    _compiled([lane], groups, procs)
    assert kb.batchsim_advance.launches == before


# -- analyzer and GA integration ---------------------------------------------------

def test_objectives_batch_compiled_engine_close_to_scalar():
    """Analyzer integration: cfg.batch_engine="compiled" yields objectives
    within the documented tolerance of the scalar loop."""
    an = analyzer(tc, batch_engine="compiled")
    an.device = "cpu"
    an.factory.rng = random.Random(77)
    sols = [an.factory.random_solution() for _ in range(6)]
    batch = an.objectives_batch(sols)
    assert bsc.last_stats["fallback"] is False, bsc.last_stats
    scalar = [analyzer(tc).objectives(s) for s in sols]
    for b, s in zip(batch, scalar):
        assert len(b) == len(s)
        for x, y in zip(b, s):
            assert _close(x, y)


def test_ga_batch_eval_compiled_runs():
    """``GAConfig(batch_eval="compiled")`` searches through the compiled
    tier: its Pareto front's fitness is within the tolerance of the same
    search on the numpy tier (``batch_eval=True``)."""
    def search(batch_eval):
        an = analyzer(tc, ga=tc.GAConfig(pop_size=6, max_generations=3, min_generations=2,
                                         seed=3, batch_eval=batch_eval))
        an.device = "cpu"
        return an.run_ga()

    res = search("compiled")
    assert bsc.last_stats["fallback"] is False, bsc.last_stats
    want = search(True)
    assert res.pareto and len(res.pareto) == len(want.pareto)
    for a, b in zip(res.pareto, want.pareto):
        assert len(a.fitness) == len(b.fitness)
        assert all(_close(x, y) for x, y in zip(a.fitness, b.fitness))
