"""The compiled batch tier's kernel (``csrc/batchsim_advance.cu``) on the card.

Imports no JAX and nothing of the JAX package, so it runs where only PyTorch
is installed: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_batchsim_cuda.py``. Without a card every case skips.

The kernel is held to the port's numpy ``BatchSimulator`` (the bit-exact
tier) within ``COMPILED_REL_TOL``/``COMPILED_ABS_TOL`` on the six goldens and
on differential batches (clean, noisy with non-periodic arrivals, fault
ensembles, overload), and to its plain version on the card on the same
packed tables; ``last_stats`` and the launch counter show that the kernel,
not a fallback, produced each result, and a planted ring overflow or
iteration cap raises.
"""
import json
import math
import random
from pathlib import Path

import pytest
import torch

import repro_torch.core as tc
import repro_torch.core.batchsim_compiled as bsc
from repro_torch.analysis.lint import GOLDENS, golden_setup, golden_solution
from repro_torch.kernels import batchsim_advance as kb

GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
PROCS = tc.mobile_processors()
PROFILER = tc.Profiler(tc.AnalyticMobileBackend(PROCS))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _close(a, b):
    if math.isinf(a) or math.isinf(b):
        return math.isinf(a) and math.isinf(b)
    return abs(a - b) <= tc.COMPILED_ABS_TOL + tc.COMPILED_REL_TOL * max(abs(a), abs(b))


def _assert_batch_close(ref, got, tag):
    assert ref.width == got.width
    for i in range(ref.width):
        a, b = ref.result(i), got.result(i)
        for pid in a.busy_time:
            assert _close(a.busy_time[pid], b.busy_time[pid]), (tag, i, "busy", pid)
        assert len(a.requests) == len(b.requests), (tag, i)
        for qa, qb in zip(a.requests, b.requests):
            assert (qa.done_tasks, qa.total_tasks) == (qb.done_tasks, qb.total_tasks), (tag, i)
            for f in ("arrival", "first_start", "last_finish", "makespan"):
                assert _close(getattr(qa, f), getattr(qb, f)), (tag, i, f, qa, qb)


def _run_kernel(lanes, groups):
    before = kb.batchsim_advance.launches
    got = tc.run_batch_compiled(lanes, groups, PROCS, device="cuda")
    assert got is not None, bsc.last_stats
    assert bsc.last_stats["fallback"] is False, bsc.last_stats
    assert kb.batchsim_advance.launches == before + 1
    return got


def _golden_lane(name):
    (nets, groups, periods, nr, noise_seed, dispatch, pin, arrivals,
     faults) = golden_setup(name)
    sol = golden_solution(nets, pin=pin)
    spec = tc.build_spec(tc.decode_solution(sol, nets), PROCS, PROFILER,
                         tc.PAPER_COMM_MODEL)
    noise = tc.NoiseModel(seed=noise_seed) if noise_seed is not None else None
    return tc.BatchLane(spec=spec, periods=periods, num_requests=nr, noise=noise,
                        dispatch_overhead=dispatch, arrivals=arrivals,
                        faults=faults), groups


def _random_lanes(rng, n_lanes, measured, arrivals_on, faults_on, scale=1.0, nr=None):
    """The recipe of ``tests/test_batchsim_compiled.py``'s ``_make_lanes``."""
    n_nets = rng.randint(2, 4)
    nets = []
    for k in range(n_nets):
        n_layers = rng.randint(2, 5)
        layers = [(rng.choice(["conv", "fc", "dw"]), rng.uniform(5e5, 8e6),
                   rng.uniform(200, 3000), rng.uniform(500, 6000))
                  for _ in range(n_layers)]
        if rng.random() < 0.5 or n_layers < 3:
            nets.append(tc.chain_graph(f"n{k}", layers))
        else:
            edges = [(i, i + 1) for i in range(n_layers - 1)] + [(0, n_layers - 1)]
            nets.append(tc.branching_graph(f"n{k}", layers, edges))
    if n_nets == 2 or rng.random() < 0.4:
        groups = [list(range(n_nets))]
    else:
        cut = rng.randint(1, n_nets - 1)
        groups = [list(range(cut)), list(range(cut, n_nets))]
    periods = [rng.uniform(0.0005, 0.006) * scale for _ in groups]
    fac = tc.SolutionFactory(nets, num_processors=len(PROCS),
                             rng=random.Random(rng.randrange(1 << 30)),
                             cut_prob=rng.uniform(0.1, 0.5))
    lanes = []
    for _ in range(n_lanes):
        spec = tc.build_spec(tc.decode_solution(fac.random_solution(), nets), PROCS,
                             PROFILER, tc.PAPER_COMM_MODEL)
        n = nr if nr is not None else rng.randint(3, 6)
        arr = None
        if arrivals_on:
            arr = rng.choice((None, tc.ArrivalSpec(kind="poisson", seed=rng.randrange(1 << 16)),
                              tc.ArrivalSpec(kind="jittered", jitter=rng.uniform(0.05, 1.5),
                                             seed=rng.randrange(1 << 16))))
        faults = None
        if faults_on and rng.random() < 0.7:
            faults = tc.FaultSpec(
                dropouts=((rng.randrange(len(PROCS)), rng.uniform(0, 0.01),
                           None if rng.random() < 0.5 else rng.uniform(0.001, 0.01)),),
                throttles=((rng.randrange(len(PROCS)), 0.0, rng.uniform(0.002, 0.02),
                            rng.uniform(1.5, 4.0)),),
                straggler_prob=rng.choice([0.0, 0.2, 0.5]), straggler_shape=1.5,
                seed=rng.randrange(1 << 16))
        lanes.append(tc.BatchLane(
            spec=spec, periods=periods, num_requests=n,
            noise=tc.NoiseModel(seed=rng.randrange(1 << 16)) if measured else None,
            dispatch_overhead=150e-6 if measured else 0.0, arrivals=arr, faults=faults))
    return lanes, groups


@pytest.mark.cuda
@pytest.mark.parametrize("name", GOLDENS)
def test_kernel_reproduces_golden(name):
    _card()
    lane, groups = _golden_lane(name)
    got = _run_kernel([lane], groups)
    _assert_batch_close(tc.BatchSimulator([lane], groups, PROCS).run(), got, name)
    golden = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    res = got.result(0)
    for r, gm in zip(res.requests, golden["makespans"]):
        assert math.isinf(r.makespan) if gm is None else _close(r.makespan, gm)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["clean", "arrivals", "faults"])
def test_kernel_differential(kind, seed):
    _card()
    rng = random.Random({"clean": 5000, "arrivals": 6000, "faults": 7000}[kind] + seed)
    lanes, groups = _random_lanes(rng, 24, measured=kind != "clean",
                                  arrivals_on=kind != "clean", faults_on=kind == "faults")
    got = _run_kernel(lanes, groups)
    _assert_batch_close(tc.BatchSimulator(lanes, groups, PROCS).run(), got, (kind, seed))


@pytest.mark.cuda
def test_kernel_overload_inf_parity():
    """Deep queues and dropped requests (inf makespans) at ~100x the rate."""
    _card()
    lanes, groups = _random_lanes(random.Random(99), 40, measured=True, arrivals_on=False,
                                  faults_on=False, scale=0.01, nr=20)
    ref = tc.BatchSimulator(lanes, groups, PROCS).run()
    _assert_batch_close(ref, _run_kernel(lanes, groups), "overload")
    assert any(math.isinf(m) for i in range(len(lanes)) for m in ref.makespans(i))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["faults", "golden"])
def test_kernel_matches_plain_on_card(kind, monkeypatch):
    """The kernel and its plain version on the same packed tables, both on
    the card: every output equal."""
    _card()
    if kind == "golden":
        lane, groups = _golden_lane("fault_dropout_mix")
        lanes = [lane]
    else:
        lanes, groups = _random_lanes(random.Random(7001), 8, True, True, True)
    packed = []
    real_pack = kb.pack_tables
    monkeypatch.setattr(kb, "pack_tables",
                        lambda *a: packed.append(real_pack(*a)) or packed[-1])
    _run_kernel(lanes, groups)
    buf = packed[0].to("cuda")
    got = kb.batchsim_advance(buf)
    sizes, tab = kb.unpack_tables(buf)
    tab["itercap"] = torch.tensor(sizes["itercap"])
    want = kb.advance_plain(kb.flags_of(sizes), tab)
    for a, b in zip(got[:5], want[:5]):
        assert a.shape == b.shape
        assert torch.equal(a, b.to(a.dtype)), (a - b).abs().max()
    # per lane: no overflow, the same events and the same ring pushes
    assert not bool(got[5].any()) and not bool(want[5].any())
    assert torch.equal(got[6], want[6]) and torch.equal(got[7], want[7])


@pytest.mark.cuda
def test_queue_bound_is_a_counted_fallback():
    """A ring bound past QUEUE_CAP_MAX never launches: run_batch reruns the
    batch on the numpy tier and counts it."""
    _card()
    lanes, groups = _random_lanes(random.Random(32), 2, False, False, False)
    big = [tc.BatchLane(spec=ln.spec, periods=ln.periods, num_requests=4000) for ln in lanes]
    before, launches = dict(bsc.fallbacks), kb.batchsim_advance.launches
    got = tc.run_batch(big, groups, PROCS, engine="compiled", device="cuda")
    assert bsc.last_stats["reason"] == "queue-bound"
    assert bsc.fallbacks["queue-bound"] == before["queue-bound"] + 1
    assert kb.batchsim_advance.launches == launches
    ref = tc.BatchSimulator(big, groups, PROCS).run()
    assert [ref.makespans(i) for i in range(2)] == [got.makespans(i) for i in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["overflow", "itercap"])
def test_kernel_fault_raises_on_card(fault):
    """A ring of one slot or an iteration cap of three events, planted in the
    packed header: the launch happens, and the host raises and names the
    lane instead of rerunning the batch on numpy."""
    _card()
    lane, groups = _golden_lane("diamond_mix_overload")
    prep = bsc.prepare_batch([lane], groups, PROCS)
    key, value = ("CAP", 1) if fault == "overflow" else ("itercap", 3)
    prep.sizes[key] = value
    prep.packed[kb.HEADER.index(key)] = value
    before, launches = dict(bsc.fallbacks), kb.batchsim_advance.launches
    why = "overflowed" if fault == "overflow" else "iteration cap 3"
    with pytest.raises(RuntimeError, match=rf"lanes \[0\] of 1: .*{why}"):
        bsc.run_prepared(prep, torch.device("cuda"))
    assert kb.batchsim_advance.launches == launches + 1
    assert bsc.fallbacks == before


@pytest.mark.cuda
def test_analyzer_compiled_objectives_on_card():
    """``AnalyzerConfig(batch_engine="compiled")`` on the card: objectives
    within the tolerance of the scalar loop."""
    _card()
    nets, _, _ = golden_setup("diamond_mix_measured")[:3]
    scen = tc.build_scenario("card", [["a", "b"], ["c", "d"]], {g.name: g for g in nets})

    def analyzer(**kw):
        return tc.StaticAnalyzer(scen, PROCS, PROFILER, tc.PAPER_COMM_MODEL,
                                 tc.AnalyzerConfig(**kw), device="cuda")
    an = analyzer(batch_engine="compiled")
    an.factory.rng = random.Random(77)
    sols = [an.factory.random_solution() for _ in range(12)]
    before = kb.batchsim_advance.launches
    batch = an.objectives_batch(sols)
    assert kb.batchsim_advance.launches > before and bsc.last_stats["fallback"] is False
    scalar = [analyzer().objectives(s) for s in sols]
    for b, s in zip(batch, scalar):
        assert all(_close(x, y) for x, y in zip(b, s))
