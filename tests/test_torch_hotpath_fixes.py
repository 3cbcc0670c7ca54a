"""The reference's hot-path regression tests, run on the port.

Counterpart of ``tests/test_hotpath_fixes.py``: every case runs on
``repro_torch`` with the reference's inputs; the TensorPool cases use the
port's torch pool on the CPU (``device="cpu"``) and torch dtypes, and the
Best Mapping and objective-cache cases are also held to the reference
(``==``).

The reference's list of fixes, each with a test that fails on the pre-fix
code:

Long-standing bugs, each with a test that fails on the pre-fix code:

* **GA mating** (``ga.py``): with an odd ``pop_size``,
  ``zip(parents[0::2], parents[1::2])`` silently dropped the last shuffled
  parent from mating every generation.
* **TensorPool aliasing** (``runtime/tensorpool.py``): double-releasing a
  buffer enqueued it twice, so two later ``acquire`` calls aliased one
  backing store; foreign releases created unservable free-list buckets;
  pooled frees were never counted.
* **Best Mapping frontier** (``core/baselines.py``): keys whose archive
  entries got dominated stayed in the hillclimb frontier, burning the
  evaluation budget expanding dead mappings.
* **Objective-cache LRU** (``core/analyzer.py``): ``objectives`` cache hits
  never refreshed recency, so the "LRU" evicted by insertion order — the
  incumbent Pareto front, re-scored every generation, was exactly what got
  evicted under pressure; ``objectives_batch`` hits were neither counted
  nor refreshed, so batch-mode stats undercounted and eviction order
  diverged from the scalar path.
* **Batch sharding** (``core/batchsim.py``): the sharded path measured
  *slower* than in-process at GA widths, yet ``workers > 1`` always
  sharded; ``run_batch`` now stays in-process below ``SHARD_MIN_LANES``.
"""
import random

import pytest
import torch

import repro.core as rc
import repro.experiments as rx

from repro_torch.core import (
    PAPER_COMM_MODEL,
    SHARD_MIN_LANES,
    AnalyzerConfig,
    GAConfig,
    GeneticScheduler,
    Profiler,
    SolutionFactory,
    StaticAnalyzer,
    build_scenario,
    chain_graph,
    mobile_processors,
    run_batch,
)
from repro_torch.core.profiler import AnalyticMobileBackend
from repro_torch.core.baselines import _whole_model_solution, best_mapping_solutions
from repro_torch.core.nsga import fast_non_dominated_sort
from repro_torch.experiments import generate_scenario_specs
from repro_torch.experiments.evaluate import default_context
from repro_torch.runtime.tensorpool import CHUNK
from repro_torch.runtime.tensorpool import TensorPool as _TensorPool


# -- GA: odd pop_size mating --------------------------------------------------

def _nets(n=2):
    return [chain_graph(f"m{i}", [("conv", 2e6, 500, 2000)] * 3)
            for i in range(n)]


def _scheduler(pop_size, **cfg_kw):
    nets = _nets()
    fac = SolutionFactory(nets, num_processors=3, rng=random.Random(7))

    def ev(sol):
        # cheap deterministic objective: genes only, no simulation
        return (float(sum(map(sum, sol.mapping))), float(sum(sol.dtype)))

    cfg_kw.setdefault("max_generations", 3)
    cfg_kw.setdefault("min_generations", 1)
    return GeneticScheduler(
        factory=fac, evaluate_fast=ev,
        config=GAConfig(pop_size=pop_size, seed=3, **cfg_kw),
    ), fac


def test_ga_odd_population_mates_every_parent():
    """The leftover shuffled parent must participate in mating.

    With crossover and mutation disabled, offspring are verbatim parent
    copies — so every parent's chromosome must appear among the offspring.
    Pre-fix, an odd population produced only ``pop_size - 1`` offspring and
    the last shuffled parent's genes were guaranteed absent.
    """
    sched, fac = _scheduler(5, cx_prob=0.0, p_bit=0.0, p_map=0.0,
                            p_prio=0.0, p_cfg=0.0)
    parents = [fac.random_solution() for _ in range(5)]
    offspring = sched._mate(parents)
    assert len(offspring) == 6  # pre-fix: 4
    child_keys = {c.key() for c in offspring}
    for p in parents:
        assert p.key() in child_keys, "a parent sat the generation out"


def test_ga_even_population_mating_unchanged():
    sched, fac = _scheduler(6, cx_prob=0.0, p_bit=0.0, p_map=0.0,
                            p_prio=0.0, p_cfg=0.0)
    parents = [fac.random_solution() for _ in range(6)]
    state = sched.rng.getstate()
    offspring = sched._mate(parents)
    assert len(offspring) == 6
    # even path draws exactly one rng value per pair (the cx_prob gate),
    # exactly like the pre-fix loop — no extra partner draw, so even-sized
    # populations reproduce historical GA runs bit for bit
    replay = random.Random()
    replay.setstate(state)
    for _ in range(3):
        replay.random()
    assert replay.getstate() == sched.rng.getstate()


def test_ga_runs_with_odd_pop_size():
    """End to end: an odd population searches without losing candidates.

    With local search off and crossover forced, generation 1 evaluates the
    5 initial candidates, the offspring, and the accurate front-0 re-evals.
    The mating fix produces 6 offspring per generation where the pre-fix
    loop produced 4, so the fast-evaluation count before the accurate pass
    is 11 distinct solutions vs at most 9 — the evaluator-call counter
    (which also includes the accurate pass) must clear the post-fix floor.
    """
    sched, _ = _scheduler(5, cx_prob=1.0, p_local=0.0, max_generations=1,
                          min_generations=1)
    fast_calls = []
    inner = sched.evaluate_fast
    sched.evaluate_fast = lambda s: (fast_calls.append(s.key()), inner(s))[1]
    result = sched.run()
    assert result.generations == 1
    assert result.pareto
    # 5 initial + 6 offspring distinct fast evaluations (pre-fix: 5 + 4)
    assert len(set(fast_calls)) >= 11


def test_ga_singleton_population_survives():
    sched, fac = _scheduler(1, cx_prob=0.0, p_bit=0.0, p_map=0.0,
                            p_prio=0.0, p_cfg=0.0)
    parents = [fac.random_solution()]
    offspring = sched._mate(parents)
    assert len(offspring) == 2
    assert all(c.key() == parents[0].key() for c in offspring)


# -- TensorPool: double/foreign release ---------------------------------------

def TensorPool(**kw):
    return _TensorPool(device="cpu", **kw)


def _base(arr):
    """The backing store of a pooled view, by its storage."""
    return arr.untyped_storage().data_ptr()


def test_tensorpool_double_release_does_not_alias():
    pool = TensorPool()
    a = pool.acquire((100,), torch.float32)
    pool.release(a)
    pool.release(a)  # double release: must be ignored
    x = pool.acquire((100,), torch.float32)
    y = pool.acquire((100,), torch.float32)
    assert _base(x) != _base(y), (
        "two live buffers share one backing store")
    # writes through one view must not corrupt the other
    x.fill_(1.0)
    y.fill_(2.0)
    assert float(x[0]) == 1.0 and float(y[0]) == 2.0
    assert pool.stats.rejected_frees == 1


def test_tensorpool_foreign_release_ignored():
    pool = TensorPool()
    foreign = torch.zeros(100, dtype=torch.uint8)  # not chunk-rounded, never acquired
    pool.release(foreign)
    assert pool.stats.rejected_frees == 1
    # no unservable bucket keyed by the unrounded nbytes
    assert 100 not in pool._free
    # and the free list still serves normally afterwards
    a = pool.acquire((10,), torch.float32)
    pool.release(a)
    b = pool.acquire((10,), torch.float32)
    assert pool.stats.reuses == 1
    assert _base(b) == _base(a)


def test_tensorpool_counts_pooled_frees():
    pool = TensorPool()
    bufs = [pool.acquire((CHUNK // 4,), torch.float32) for _ in range(3)]
    for b in bufs:
        pool.release(b)
    # pre-fix: frees stayed 0 on the pooled path, so §5.3 free-time
    # accounting could not be audited
    assert pool.stats.frees == 3
    assert pool.stats.rejected_frees == 0
    # release calls = honored + rejected, always
    pool.release(bufs[0])
    assert pool.stats.frees + pool.stats.rejected_frees == 4


def test_tensorpool_disabled_counts_frees():
    pool = TensorPool(enabled=False)
    a = pool.acquire((10,), torch.float32)
    pool.release(a)
    assert pool.stats.frees == 1
    assert pool.stats.mallocs == 1


def test_tensorpool_reuse_roundtrip_still_works():
    pool = TensorPool()
    a = pool.acquire((64, 64), torch.float32)
    pool.release(a)
    b = pool.acquire((32, 32), torch.float32)  # smaller, same rounded class?
    # whatever the bucket, acquire/release cycles keep working and tracked
    pool.release(b)
    c = pool.stage(torch.ones((8, 8), dtype=torch.float32))
    assert float(c[0, 0]) == 1.0
    pool.release(c)
    assert pool.stats.frees >= 3


# -- Best Mapping: frontier pruning -------------------------------------------

def _prefix_best_mapping(graphs, processors, best_times, evaluate,
                         max_evals, seed):
    """Faithful reimplementation of the PRE-fix hillclimb (no pruning, no
    dedup) — the behavior the committed-seed comparison runs against."""
    rng = random.Random(seed)
    n = len(graphs)

    def make(key):
        cfgs = [(best_times[m][key[m]][1], best_times[m][key[m]][2])
                for m in range(n)]
        return _whole_model_solution(graphs, list(key), cfgs)

    start = tuple(min(best_times[m], key=lambda pid: best_times[m][pid][0])
                  for m in range(n))
    evaluated = {}

    def ev(key):
        if key not in evaluated:
            evaluated[key] = evaluate(make(key))
        return evaluated[key]

    archive = [(start, ev(start))]
    frontier = [start]
    while frontier and len(evaluated) < max_evals:
        base = frontier.pop(0)
        neighbors = []
        for m in range(n):
            for p in processors:
                if p != base[m]:
                    neighbors.append(
                        tuple(p if i == m else base[i] for i in range(n)))
        rng.shuffle(neighbors)
        for cand in neighbors:
            if len(evaluated) >= max_evals:
                break
            if cand in evaluated:
                continue
            obj = ev(cand)
            fits = [o for _, o in archive] + [obj]
            fronts = fast_non_dominated_sort(fits)
            if len(archive) in fronts[0]:
                items = archive + [(cand, obj)]
                archive = [items[i] for i in fronts[0]]
                frontier.append(cand)
    return archive


#: Synthetic 3-model × 3-processor landscape. With neighbor-shuffle seed 3
#: the hillclimb discovers X=(1,0,0) before Y=(0,1,0) while expanding the
#: start; expanding X then finds (1,1,0), which dominates Y. Pre-fix, the
#: dead Y stays in the frontier and its private neighborhood
#: {(0,1,1), (0,1,2)} is evaluated anyway; with pruning it never is.
_LANDSCAPE = {
    (0, 0, 0): (10.0, 10.0),
    (1, 0, 0): (5.0, 10.0),
    (0, 1, 0): (10.0, 5.0),
    (1, 1, 0): (6.0, 4.0),
}
_DEAD_NEIGHBORHOOD = ((0, 1, 1), (0, 1, 2))


def test_best_mapping_prunes_dominated_frontier_keys():
    graphs = _nets(3)
    best_times = [{p: (float(m + p + 1), 0, 0) for p in (0, 1, 2)}
                  for m in range(3)]  # argmin pid 0 -> start = (0, 0, 0)
    calls = []

    def ev(sol):
        key = tuple(sol.mapping[m][0] for m in range(3))
        calls.append(key)
        return _LANDSCAPE.get(key, (20.0, 20.0))

    sols = best_mapping_solutions(graphs, [0, 1, 2], best_times, ev,
                                  max_evals=30, seed=3)
    ix = {k: i for i, k in enumerate(calls)}
    # precondition of the scenario: X discovered before Y during the start's
    # expansion (fails loudly if the shuffle stream ever changes)
    assert ix[(1, 0, 0)] < ix[(0, 1, 0)], "landscape precondition broken"
    dead = [k for k in _DEAD_NEIGHBORHOOD if k in ix]
    assert not dead, (
        f"budget spent expanding a dominated frontier key: {dead}")
    archive_keys = {tuple(s.mapping[m][0] for m in range(3)) for s in sols}
    assert archive_keys == {(1, 0, 0), (1, 1, 0)}


@pytest.mark.parametrize("index", [1, 2, 4])
def test_best_mapping_unchanged_or_better_on_committed_seeds(index):
    """On the committed ``RESULTS_sweep.json`` seeds the pruned hillclimb's
    archive is unchanged-or-better: no fixed-archive entry is dominated by
    any pre-fix entry (never worse), while the freed budget lets it
    dominate pre-fix entries on some scenarios (strictly better)."""
    ctx = default_context()
    spec = generate_scenario_specs(8, seed=0)[index]
    scen = build_scenario(spec.name, [list(g) for g in spec.groups],
                          ctx.graphs)
    an = StaticAnalyzer(scen, ctx.processors, ctx.profiler, ctx.comm_model,
                        AnalyzerConfig(ga=GAConfig(seed=spec.seed)))
    def ev(s):
        return an.objectives(s, num_requests=an.cfg.fast_requests)

    fixed = [tuple(s.fitness)
             for s in an.best_mapping(max_evals=120, seed=spec.seed)]
    pre = [o for _, o in _prefix_best_mapping(
        scen.graphs, [p.pid for p in an.processors], an.best_times,
        ev, 120, spec.seed)]

    def dominates(a, b):
        return (all(x <= y for x, y in zip(a, b))
                and any(x < y for x, y in zip(a, b)))

    worse = [f for f in fixed if any(dominates(p, f) for p in pre)]
    assert not worse, "pruning made an archive entry strictly worse"
    if index == 4:
        # this scenario's pre-fix run provably wasted budget: the fixed
        # archive strictly dominates several of its entries
        assert any(any(dominates(f, p) for f in fixed) for p in pre)


# -- Objective cache: LRU recency -----------------------------------------


def _cache_analyzer(cache_size=1):
    """Analyzer with a tiny objective cache (cap = 4 * cache_size)."""
    nets = [chain_graph(f"n{i}", [("conv", (2 + i) * 1e6, 500, 2000)] * 3)
            for i in range(2)]
    scen = build_scenario("lru", [["n0", "n1"]], {g.name: g for g in nets})
    procs = mobile_processors()
    prof = Profiler(AnalyticMobileBackend(procs))
    cfg = AnalyzerConfig(decode_cache_size=cache_size, ga=GAConfig(seed=5))
    return StaticAnalyzer(scen, procs, prof, PAPER_COMM_MODEL, cfg)


def _distinct_solutions(an, n):
    """Solutions with pairwise-distinct spec signatures (distinct memo keys)."""
    an.factory.rng = random.Random(11)
    sols, seen = [], set()
    while len(sols) < n:
        s = an.factory.random_solution()
        sig = an.solution_spec(s).signature()
        if sig not in seen:
            seen.add(sig)
            sols.append(s)
    return sols


def test_objective_cache_hot_key_survives_eviction():
    """A repeatedly-hit key must outlive colder insertions.

    Pre-fix, ``objectives`` hits never called ``move_to_end``, so eviction
    degraded to insertion order: the oldest-inserted key was evicted even
    while being hit every generation — exactly the incumbent Pareto front's
    access pattern.
    """
    an = _cache_analyzer()  # objective cache cap = 4
    sol_a, sol_b, sol_c, sol_d, sol_e = _distinct_solutions(an, 5)
    for s in (sol_a, sol_b, sol_c, sol_d):
        an.objectives(s)               # 4 misses: cache exactly full
    assert an.objective_cache_misses == 4
    an.objectives(sol_a)               # hit: must refresh recency
    assert an.objective_cache_hits == 1
    an.objectives(sol_e)               # evicts the true LRU (B) — not A
    misses = an.objective_cache_misses
    an.objectives(sol_a)
    assert an.objective_cache_hits == 2, (
        "hot key evicted: cache degraded to insertion order")
    assert an.objective_cache_misses == misses


def test_objectives_batch_hit_accounting_and_recency():
    """Batch dedup/read-back hits count and refresh like the scalar path."""
    an = _cache_analyzer()
    sol_a, sol_b, sol_c, sol_d, sol_e = _distinct_solutions(an, 5)
    an.objectives(sol_a)
    assert (an.objective_cache_hits, an.objective_cache_misses) == (0, 1)
    out = an.objectives_batch([sol_a, sol_b])   # A: cached; B: fresh lane
    assert an.objective_cache_hits == 1, "batch cache hit went uncounted"
    assert an.objective_cache_misses == 2
    assert out[0] == an.objectives(sol_a)       # agrees with scalar path
    # recency through the batch path only: fill the cap, touch A via a
    # pure-hit batch, then force one eviction — A must survive it
    an.objectives_batch([sol_c, sol_d])         # cache now {A,B,C,D} (cap 4)
    an.objectives_batch([sol_a])
    hits = an.objective_cache_hits
    an.objectives(sol_e)                        # evicts true LRU (B)
    an.objectives(sol_a)
    assert an.objective_cache_hits == hits + 1, (
        "batch hit did not refresh LRU recency")


def test_objectives_batch_duplicate_counts_as_hit():
    """An in-generation duplicate is a hit (the scalar loop's second call
    would hit the cache) and must not be simulated twice."""
    an = _cache_analyzer(cache_size=64)
    sol_a, sol_b = _distinct_solutions(an, 2)
    out = an.objectives_batch([sol_a, sol_b, sol_a.copy()])
    assert an.objective_cache_misses == 2
    assert an.objective_cache_hits == 1
    assert out[0] == out[2]


# -- run_batch: sharding threshold ----------------------------------------


class _PoisonPool:
    """Stands in for a process pool that must not be used."""

    def map(self, *a, **k):  # pragma: no cover - failure path
        raise AssertionError("sharded below the measured lane threshold")


def test_run_batch_small_batch_stays_in_process():
    """Below SHARD_MIN_LANES, workers > 1 must not engage the (measured
    slower) sharded path; an explicit threshold override re-enables it."""
    an = _cache_analyzer(cache_size=64)
    sols = _distinct_solutions(an, 6)
    lanes = [an._lane(s, 1.0, 4, False) for s in sols]
    assert len(lanes) < SHARD_MIN_LANES
    res = run_batch(lanes, an.scenario.groups, an.processors,
                    workers=4, pool=_PoisonPool())
    ref = run_batch(lanes, an.scenario.groups, an.processors)
    for i in range(len(lanes)):
        assert res.makespans(i) == ref.makespans(i)
    with pytest.raises(AssertionError, match="sharded"):
        run_batch(lanes, an.scenario.groups, an.processors,
                  workers=2, pool=_PoisonPool(), shard_min_lanes=0)


# -- heuristic seed capability (core/chromosome.py) ---------------------------
# Surfaced by the static analyzer (SL010) over every committed
# RESULTS_sweep.json scenario: `seeded_solution(npu)` hardcoded
# (dtype, backend) = (fp32, default), which the NPU does not support — the
# "everything on the NPU" GA seed simulated under the 30x capability
# fallback penalty on all of its layers, making the heuristic seed useless
# exactly where the paper's NPU-heavy schedules come from.

def _seed_analyzer():
    nets = [chain_graph(f"s{i}", [("conv", 4e6, 1000, 4000)] * 4)
            for i in range(2)]
    scen = build_scenario("seed_fix", [["s0"], ["s1"]],
                          {f"s{i}": nets[i] for i in range(2)})
    procs = mobile_processors()
    prof = Profiler(AnalyticMobileBackend(procs))
    return StaticAnalyzer(scen, list(procs), prof, PAPER_COMM_MODEL,
                          AnalyzerConfig())


def test_npu_seed_uses_supported_config():
    """Pre-fix: the NPU seed carried fp32/default (unsupported on the NPU),
    so every layer simulated at the 30x fallback penalty."""
    an = _seed_analyzer()
    npu = next(p for p in an.processors if p.kind == "npu")
    sol = an.factory.seeded_solution(npu.pid)
    from repro_torch.core.chromosome import BACKENDS, DTYPES
    for net in range(len(an.scenario.graphs)):
        dt, be = DTYPES[sol.dtype[net]], BACKENDS[sol.backend[net]]
        assert npu.thr(dt, be) is not None, (
            f"NPU seed pinned to unsupported config ({dt}, {be})")
    # and the analyzer confirms: no capability warning on the seed
    assert an.lint(sol).by_code("SL010") == []


def test_fixed_npu_seed_dominates_prefix_fp32_seed():
    """The supported-config seed must be strictly faster than the pre-fix
    fp32 seed it replaces (which paid the fallback penalty everywhere)."""
    an = _seed_analyzer()
    npu = next(p for p in an.processors if p.kind == "npu")
    fixed = an.factory.seeded_solution(npu.pid)
    prefix = fixed.copy()
    prefix.dtype = [0] * len(an.scenario.graphs)
    prefix.backend = [0] * len(an.scenario.graphs)
    alpha = an.saturation(fixed).alpha_star
    assert alpha < an.saturation(prefix).alpha_star, (
        "fixed seed should saturate at a strictly smaller alpha*")
    assert an.score(fixed, alpha) >= an.score(prefix, alpha)


def test_supported_processor_seeds_unchanged():
    """Behavior-preserving everywhere else: processors that do support
    (fp32, default) keep the exact pre-fix seed genes, and a factory
    without capability knowledge is bit-identical to the old code."""
    an = _seed_analyzer()
    for p in an.processors:
        if p.thr("fp32", "default") is None:
            continue
        sol = an.factory.seeded_solution(p.pid)
        assert sol.dtype == [0] * len(an.scenario.graphs)
        assert sol.backend == [0] * len(an.scenario.graphs)
    blind = SolutionFactory(_nets(), num_processors=3,
                            rng=random.Random(7))
    sol = blind.seeded_solution(2)  # no processors: legacy (0, 0) genes
    assert sol.dtype == [0, 0] and sol.backend == [0, 0]


def test_seed_config_does_not_touch_rng_stream():
    """The capability lookup is deterministic: seeding with and without
    capability knowledge must leave the factory RNG in the same state, so
    downstream random_solution() draws are unperturbed."""
    nets = _nets()
    procs = mobile_processors()
    with_caps = SolutionFactory(nets, num_processors=3,
                                rng=random.Random(11), processors=procs)
    without = SolutionFactory(nets, num_processors=3, rng=random.Random(11))
    for pid in (0, 1, 2):
        with_caps.seeded_solution(pid)
        without.seeded_solution(pid)
    assert with_caps.random_solution().key() == without.random_solution().key()


# -- the port against the reference ---------------------------------------------

@pytest.mark.parametrize("index", [1, 4])
def test_best_mapping_archive_equals_reference(index):
    """The pruned hillclimb's archive on the committed seeds, port and
    reference: the same keys in the same order with the same fitness."""
    def archive(core, exp):
        ctx = exp.default_context()
        spec = exp.generate_scenario_specs(8, seed=0)[index]
        scen = core.build_scenario(spec.name, [list(g) for g in spec.groups], ctx.graphs)
        an = core.StaticAnalyzer(scen, ctx.processors, ctx.profiler, ctx.comm_model,
                                 core.AnalyzerConfig(ga=core.GAConfig(seed=spec.seed)))
        sols = an.best_mapping(max_evals=120, seed=spec.seed)
        return [(s.key(), tuple(s.fitness)) for s in sols], an.objective_cache_misses

    import repro_torch.core as tc
    import repro_torch.experiments as tx
    assert archive(tc, tx) == archive(rc, rx)
