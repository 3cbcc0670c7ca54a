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

The kernel runs one warp per lane; the thread-per-lane kernel it replaced
stays reachable only through ``_batchsim_advance_thread``, for timing, and
is held to it here. Further cases: strongly uneven lanes at a width that
is no multiple of the lanes a block holds, more fault windows than one
ballot covers, a batch at the sweep's shapes, two launches giving the same
bits, and a block's shared memory past the card's limit.
"""
import dataclasses
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


def _plain(buf):
    sizes, tab = kb.unpack_tables(buf)
    tab["itercap"] = torch.tensor(sizes["itercap"])
    return kb.advance_plain(kb.flags_of(sizes), tab)


def _assert_all_equal(got, want, tag):
    """All eight outputs equal, the flags, events and ring pushes too."""
    assert len(got) == len(want) == 8
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (tag, i)
        assert torch.equal(a, b.to(a.dtype)), (tag, i, (a.double() - b.double()).abs().max())


def _cut(packed, width):
    """A packed batch cut to its first ``width`` lanes (``prepare_batch``
    pads a batch to a multiple of 16 lanes)."""
    sizes, tab = kb.unpack_tables(packed)
    tabs = {name: (tab[name][:width] if shape[0] == "W" else tab[name]).numpy()
            for name, _, shape in kb.TABLES}
    return kb.pack_tables(dict(sizes, W=width), tabs)


@pytest.mark.cuda
def test_kernel_uneven_lanes_odd_width():
    """Nine lanes, one with 10x the requests of the rest (faults, noise and
    non-periodic arrivals on): every output equal to the plain pass's, at a
    width that leaves the last block a lane short."""
    _card()
    lanes, groups = _random_lanes(random.Random(4242), 9, True, True, True, nr=4)
    lanes[3] = dataclasses.replace(lanes[3], num_requests=40)
    buf = _cut(bsc.prepare_batch(lanes, groups, PROCS).packed, 9).to("cuda")
    assert 9 % kb.LANES_PER_BLOCK != 0
    before = kb.batchsim_advance.launches
    got = kb.batchsim_advance(buf)
    assert kb.batchsim_advance.launches == before + 1
    iters = got[6].tolist()
    assert iters[3] == max(iters) and iters[3] >= 3 * sorted(iters)[4], iters
    _assert_all_equal(got, _plain(buf), "uneven")


@pytest.mark.cuda
def test_kernel_many_fault_windows():
    """40 throttle and 35 dropout windows on every second lane, more than one
    ballot covers: the factors multiplied in index order, the first
    dropout winning, as the plain pass and the numpy tier do."""
    _card()
    rng = random.Random(11)
    lanes, groups = _random_lanes(rng, 12, True, True, False, nr=6)
    for i, ln in enumerate(lanes):
        nt, nd = (40, 35) if i % 2 == 0 else (3, 2)
        lanes[i] = dataclasses.replace(ln, faults=tc.FaultSpec(
            throttles=tuple((rng.randrange(3), rng.uniform(0, 0.01), rng.uniform(0.01, 0.03),
                             rng.uniform(1.1, 2.0)) for _ in range(nt)),
            dropouts=tuple((rng.randrange(3), rng.uniform(0, 0.02), rng.uniform(0.0005, 0.002))
                           for _ in range(nd)),
            straggler_prob=0.3, straggler_shape=1.5, seed=i))
    prep = bsc.prepare_batch(lanes, groups, PROCS)
    assert (prep.sizes["T"], prep.sizes["D"]) == (40, 35)
    buf = prep.packed.to("cuda")
    _assert_all_equal(kb.batchsim_advance(buf), _plain(buf), "windows")
    _assert_batch_close(tc.BatchSimulator(lanes, groups, PROCS).run(),
                        bsc.run_prepared(prep, torch.device("cuda")), "windows")


@pytest.mark.cuda
def test_kernel_at_the_sweep_shape(monkeypatch):
    """A satisfaction batch of sweep scenario 1 (the first of the seed-0
    specs with three groups): G 3, S 32, NR 64, CAP 1024, noise on. Held to
    the numpy tier within the tolerance and to the plain pass exactly; the
    thread-per-lane kernel is never launched."""
    _card()
    from repro_torch.experiments import generate_scenario_specs
    from repro_torch.experiments.evaluate import default_context
    spec = generate_scenario_specs(2, seed=0)[1]
    ctx = default_context("cuda")
    scen = tc.build_scenario(spec.name, [list(g) for g in spec.groups], ctx.graphs,
                             arrival=spec.arrival, faults=spec.faults)
    an = tc.StaticAnalyzer(scen, ctx.processors, ctx.profiler, ctx.comm_model,
                           tc.AnalyzerConfig(batch_engine="compiled"), device="cuda")
    an.factory.rng = random.Random(5)
    sols = [an.factory.random_solution() for _ in range(6)]
    preps = []
    real = bsc.prepare_batch
    monkeypatch.setattr(bsc, "prepare_batch",
                        lambda *a, **kw: preps.append(real(*a, **kw)) or preps[-1])
    thread_before = kb._batchsim_advance_thread.launches
    an.simulate_batch([(s, 1.0) for s in sols], 36, measured=True, seed=spec.seed)
    assert kb._batchsim_advance_thread.launches == thread_before
    prep = preps[0]
    assert {k: prep.sizes[k] for k in ("G", "P", "NP", "S", "NR", "CAP")} == dict(
        G=3, P=3, NP=6, S=32, NR=64, CAP=1024)
    assert prep.sizes["any_noise"]
    _assert_batch_close(tc.BatchSimulator(prep.lanes, prep.groups, PROCS).run(),
                        bsc.run_prepared(prep, torch.device("cuda")), "sweep shape")
    buf = prep.packed.to("cuda")
    _assert_all_equal(kb.batchsim_advance(buf), _plain(buf), "sweep shape")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["golden", "faults"])
def test_kernel_same_bits_twice(kind):
    _card()
    if kind == "golden":
        lane, groups = _golden_lane("diamond_mix_overload")
        lanes = [lane]
    else:
        lanes, groups = _random_lanes(random.Random(7003), 24, True, True, True)
    buf = bsc.prepare_batch(lanes, groups, PROCS).packed.to("cuda")
    first = [t.clone() for t in kb.batchsim_advance(buf)]
    _assert_all_equal(kb.batchsim_advance(buf), first, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GOLDENS)
def test_thread_kernel_equals_warp_kernel(name):
    """The thread-per-lane kernel, through its timing entry, computes what
    the warp-per-lane kernel does: the yardstick times the same work."""
    _card()
    lane, groups = _golden_lane(name)
    prep = bsc.prepare_batch([lane], groups, PROCS)
    buf = prep.packed.to("cuda")
    before, thread_before = kb.batchsim_advance.launches, kb._batchsim_advance_thread.launches
    old = kb._batchsim_advance_thread(buf, prep.sizes)
    assert kb._batchsim_advance_thread.launches == thread_before + 1
    assert kb.batchsim_advance.launches == before
    _assert_all_equal(kb.batchsim_advance(buf, prep.sizes), old, name)


@pytest.mark.cuda
def test_shared_bytes_past_the_limit_raise(monkeypatch):
    """A block that needs more shared memory than the card allows is never
    launched: the call raises and names the sizes."""
    _card()
    lane, groups = _golden_lane("tri_chain_clean")
    buf = bsc.prepare_batch([lane], groups, PROCS).packed.to("cuda")
    monkeypatch.setattr(kb, "_shared_limit", lambda device: 64)
    before, thread_before = kb.batchsim_advance.launches, kb._batchsim_advance_thread.launches
    with pytest.raises(ValueError, match=r"bytes of shared memory a block .*G 1, P 3, NP 3"):
        kb.batchsim_advance(buf)
    assert kb.batchsim_advance.launches == before
    assert kb._batchsim_advance_thread.launches == thread_before


@pytest.mark.cuda
def test_kernel_frontier_wider_than_a_warp():
    """34 groups of one network each: a frontier of 38 columns and 34
    priority classes, more than a warp has threads, so a thread holds two
    columns and the FIFO search takes two ballots."""
    _card()
    rng = random.Random(3)
    nets = [tc.chain_graph(f"n{k}", [(rng.choice(["conv", "fc"]), rng.uniform(5e5, 4e6),
                                      rng.uniform(200, 3000), rng.uniform(500, 6000))
                                     for _ in range(2)]) for k in range(34)]
    groups = [[k] for k in range(34)]
    fac = tc.SolutionFactory(nets, num_processors=len(PROCS), rng=random.Random(9),
                             cut_prob=0.3)
    lanes = [tc.BatchLane(spec=tc.build_spec(tc.decode_solution(fac.random_solution(), nets),
                                             PROCS, PROFILER, tc.PAPER_COMM_MODEL),
                          periods=[0.002 * (1 + k % 3) for k in range(34)], num_requests=3,
                          noise=tc.NoiseModel(seed=i), dispatch_overhead=150e-6)
             for i in range(5)]
    prep = bsc.prepare_batch(lanes, groups, PROCS)
    assert prep.sizes["G"] + prep.sizes["P"] + 1 > 32 and prep.sizes["NP"] > 32
    buf = prep.packed.to("cuda")
    _assert_all_equal(kb.batchsim_advance(buf), _plain(buf), "wide")
    _assert_batch_close(tc.BatchSimulator(lanes, groups, PROCS).run(),
                        bsc.run_prepared(prep, torch.device("cuda")), "wide")
