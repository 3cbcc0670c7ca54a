"""The paper's evaluation harness, on the port: one function per table or figure.

Counterpart of the reference's ``benchmarks/run.py``, with its 15 section
names, its ``name,us_per_call,derived`` CSV rows, its row names and its
sizing rules. Sections:

* table2  — CPU execution time across (dtype, backend) configs (paper Table 2)
* table3  — best time per processor (paper Table 3)
* table4  — non-linearity: Σ(per-layer) / whole-graph ratios (paper Table 4),
            plus a live row measured by ``TorchExecBackend`` on the device
* fig5    — host copy microbenchmark + piecewise-linear fit (paper Fig. 5)
* fig12   — single-model-group saturation multipliers: Puzzle vs Best
            Mapping vs NPU Only (paper Fig. 12)
* fig15   — multi-model-group saturation multipliers (paper Fig. 15)
* table5  — runtime ablation: tensor pool / shared buffer, executed on the
            device (paper Table 5 / Fig. 10)
* simspeed — the evaluation engines: DES vs fastsim µs/eval, grid vs
             bisection α*, end-to-end GA speedup, the generation-batched
             numpy tier and the compiled tier (B1, the event-loop kernel
             ``kernels/csrc/batchsim_advance.cu`` on the card, its plain
             pass on the CPU). ``--json`` writes
             ``results/paper_torch/BENCH_simspeed.json``.
* prescreen — the static pre-screen: GA simulations avoided, false prunes
            (must be 0), α*-probe savings. ``--json`` writes
            ``results/paper_torch/BENCH_prescreen.json``.
* conformance — virtual-clock replays against the simulator (zero diff,
            asserted) and the replay cost of both tiers
* sweep   — the randomized scenario sweep (paper §6, Fig. 11)
* arrivals — the sweep under periodic, jittered and Poisson traffic
* faults  — fault injection and recovery on the virtual-clock runtime
* roofline — per (arch × shape) terms from the port's dry-run records
             (``results/dryrun_torch/*__single.json``)
* kernels — the three Pallas kernels' counterparts (K1, K2, K3) against
            their oracles and plain versions, with the route each took
            and its launches

Usage::

    python -m repro_torch.experiments.paper [section] [--only S] [--full]
        [--smoke] [--json] [--device D]

The device is the card unless ``--device cpu`` is given; without a card
and without it the harness raises. Host-only sections (the tables, the
simulators, the GA) run on the host either way; the device runs table4's
live row, table5, simspeed's compiled legs, the prescreen's provisioning
and the kernels. On the CPU the kernels section runs the plain versions,
a check of the oracles only.
"""
from __future__ import annotations

import argparse
import gc
import glob
import json
import math
import os
import random
import statistics
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import (
    AnalyticMobileBackend,
    AnalyzerConfig,
    GAConfig,
    PAPER_COMM_MODEL,
    PiecewiseLinearCommModel,
    Profiler,
    Solution,
    StaticAnalyzer,
    TableBackend,
    TorchExecBackend,
    best_model_times,
    build_scenario,
    decode_solution,
    microbenchmark_host,
    mobile_processors,
    random_scenarios,
    whole_model_placement,
)
from ..device import resolve_device
from ..zoo import (
    MODEL_NAMES,
    MODEL_SPECS,
    TABLE4_RATIO,
    ExecutableMobileModel,
    all_cost_graphs,
    paper_profile_tables,
)

ROW = "{name},{us:.2f},{derived}"
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
RESULTS_DIR = os.path.join(ROOT, "results", "paper_torch")
DRYRUN_DIR = os.path.join(ROOT, "results", "dryrun_torch")


def emit(name: str, us: float, derived: str = "") -> None:
    print(ROW.format(name=name, us=us, derived=derived), flush=True)


def device_record(device: torch.device) -> Dict[str, object]:
    """The device a record's numbers come from: on the card, its name and
    power limit as ``nvidia-smi`` prints them."""
    if device.type != "cuda":
        return {"type": device.type}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": smi[device.index or 0]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler():
    procs = mobile_processors()
    backend = TableBackend(
        processors=procs, tables=paper_profile_tables(),
        fallback=AnalyticMobileBackend(procs),
    )
    return procs, Profiler(backend)


def _analyzer(groups, device, name="bench", seed=0):
    graphs = all_cost_graphs()
    procs, prof = _profiler()
    scen = build_scenario(name, groups, graphs)
    cfg = AnalyzerConfig(ga=GAConfig(pop_size=20, max_generations=30,
                                     min_generations=10, seed=seed))
    return StaticAnalyzer(scen, procs, prof, PAPER_COMM_MODEL, cfg, device=device)


def _zoo(names, device, channels: int, spatial: Optional[int]):
    """Executable zoo networks on ``device``: at ``spatial`` when given, else
    at each network's input resolution in the paper (``MODEL_SPECS``)."""
    return {n: ExecutableMobileModel(
        n, channels=channels, spatial=spatial or MODEL_SPECS[n]["input"][1], device=device)
        for n in names}


def _close(a: float, b: float, abs_tol: float, rel_tol: float) -> bool:
    if math.isinf(a) or math.isinf(b):
        return math.isinf(a) and math.isinf(b)
    return abs(a - b) <= abs_tol + rel_tol * max(abs(a), abs(b))


def _write_record(record: Dict[str, object], out_dir: str, name: str) -> str:
    def finite(v):
        if isinstance(v, float) and not np.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: finite(x) for k, x in v.items()}
        if isinstance(v, list):
            return [finite(x) for x in v]
        return v

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(out_dir, name))
    with open(path, "w") as f:
        json.dump({k: finite(v) for k, v in record.items()}, f, indent=2, sort_keys=True)
    return path


# ---------------------------------------------------------------------------

def bench_table2(args, device) -> None:
    """CPU times by (dtype, backend); derived = ratio to the row minimum."""
    tables = paper_profile_tables()
    for model in MODEL_NAMES:
        cpu_rows = {k: v for k, v in tables[model].items() if k[0] == "cpu"}
        best = min(cpu_rows.values())
        for (kind, dt, be), t in sorted(cpu_rows.items()):
            emit(f"table2.{model}.{dt}.{be}", t * 1e6, f"x{t / best:.2f}")


def bench_table3(args, device) -> None:
    """Best configuration per processor; derived = ratio to best processor."""
    procs, prof = _profiler()
    graphs = all_cost_graphs()
    bt = best_model_times(list(graphs.values()), procs, prof)
    for i, model in enumerate(graphs):
        best = min(t for t, _, _ in bt[i].values())
        for pid, (t, di, bi) in sorted(bt[i].items()):
            emit(f"table3.{model}.{procs[pid].name}", t * 1e6,
                 f"x{t / best:.2f}")


def bench_table4(args, device, *, channels: int = 8, spatial: Optional[int] = None) -> None:
    """Non-linearity: Σ single-layer subgraphs vs whole graph (calibrated),
    plus a live measurement on ``device`` (``TorchExecBackend``: CUDA events
    on the card) of selfie_seg at the paper's input resolution unless
    ``spatial`` is given."""
    procs, prof = _profiler()
    graphs = all_cost_graphs()
    for model in MODEL_NAMES:
        g = graphs[model]
        whole = prof.subgraph_time(whole_model_placement(g, 0, 2, 1, 0))
        sol = Solution(partition=[[1] * g.num_edges],
                       mapping=[[2] * g.num_layers],
                       priority=[0], dtype=[1], backend=[0])
        placed = decode_solution(sol, [g])[0]
        summed = sum(prof.subgraph_time(p) for p in placed)
        paper = TABLE4_RATIO[model]["npu"]
        emit(f"table4.{model}.npu", whole * 1e6,
             f"est_ratio={summed / whole:.2f};paper={paper:.2f}")
    zoo = _zoo(["selfie_seg"], device, channels, spatial)
    live = Profiler(TorchExecBackend(zoo, repeats=3))
    g = zoo["selfie_seg"].graph
    whole = live.subgraph_time(whole_model_placement(g, 0, 0, 0, 0))
    sol = Solution(partition=[[1] * g.num_edges], mapping=[[0] * g.num_layers],
                   priority=[0], dtype=[0], backend=[0])
    placed = decode_solution(sol, [g])[0]
    summed = sum(live.subgraph_time(p) for p in placed)
    emit(f"table4.live_{device.type}.selfie_seg", whole * 1e6,
         f"est_ratio={summed / whole:.2f};spatial={zoo['selfie_seg'].spatial};"
         f"channels={channels}")


def bench_fig5(args, device) -> None:
    """Comm microbenchmark of host copies + fitted piecewise model. The
    card's copy bandwidth is ``chip_smoke.py``'s ``lanes`` phase."""
    t0 = time.perf_counter()
    samples = microbenchmark_host()
    fit = PiecewiseLinearCommModel.fit(samples)
    for n, t in samples:
        emit(f"fig5.sample.{int(n)}B", t * 1e6, f"fit={fit.cost(n) * 1e6:.1f}us;host")
    emit("fig5.fit", (time.perf_counter() - t0) * 1e6,
         f"a_lo={fit.a_lo:.2e};b_lo={fit.b_lo:.2e};a_hi={fit.a_hi:.2e};"
         f"b_hi={fit.b_hi:.2e};host")


def _saturation_experiment(num_groups: int, count: int, tag: str, device) -> None:
    scenarios = random_scenarios(
        MODEL_NAMES, count=count, models_per_scenario=6,
        num_groups=num_groups, seed=2025,
    )
    results = {"puzzle": [], "bm": [], "npu": []}
    cap = 6.0
    for i, groups in enumerate(scenarios):
        t0 = time.perf_counter()
        an = _analyzer(groups, device, name=f"{tag}{i}", seed=i)
        ga = an.run_ga()
        pz = an.median_saturation(ga.pareto)
        bm = an.median_saturation(an.best_mapping(max_evals=120))
        npu = an.saturation(an.npu_only()).alpha_star
        vals = {"puzzle": pz, "bm": bm, "npu": npu}
        for k, v in vals.items():
            results[k].append(min(v, cap))
        dt = time.perf_counter() - t0
        emit(f"{tag}.scenario{i}", dt * 1e6,
             f"puzzle={pz};best_mapping={bm};npu_only={npu};"
             f"ga_evals={ga.evaluations}")
    mean = {k: statistics.mean(v) for k, v in results.items()}
    sd = {k: statistics.pstdev(v) for k, v in results.items()}
    emit(f"{tag}.mean_puzzle", mean["puzzle"] * 1e6, f"sd={sd['puzzle']:.2f}")
    emit(f"{tag}.mean_best_mapping", mean["bm"] * 1e6, f"sd={sd['bm']:.2f}")
    emit(f"{tag}.mean_npu_only", mean["npu"] * 1e6, f"sd={sd['npu']:.2f}")
    paper_npu = "3.63x" if num_groups > 1 else "2.00x"
    paper_bm = "2.36x" if num_groups > 1 else "1.50x"
    emit(f"{tag}.freq_gain_vs_npu", 0.0,
         f"{mean['npu'] / mean['puzzle']:.2f}x (paper {paper_npu})")
    emit(f"{tag}.freq_gain_vs_best_mapping", 0.0,
         f"{mean['bm'] / mean['puzzle']:.2f}x (paper {paper_bm})")


def bench_fig12(args, device) -> None:
    """Single model group: saturation multipliers across random scenarios."""
    _saturation_experiment(1, 10 if args.full else 3, "fig12", device)


def bench_fig15(args, device) -> None:
    """Two model groups: saturation multipliers across random scenarios."""
    _saturation_experiment(2, 10 if args.full else 3, "fig15", device)


def bench_table5(args, device, *, channels: int = 8, spatial: Optional[int] = None
                 ) -> List[float]:
    """Runtime ablation: tensor pool / shared buffer, executed on ``device``
    at the paper's input resolutions unless ``spatial`` is given. Returns
    the three mean makespans (seconds)."""
    from ..runtime import PuzzleRuntime, RuntimeConfig
    names = ("face_det", "selfie_seg", "hand_det")
    zoo = _zoo(names, device, channels, spatial)
    graphs = [zoo[n].graph for n in names]
    # split each model in two; mixed dtypes force dtype-boundary staging
    parts = []
    for g in graphs:
        bits = [0] * g.num_edges
        bits[g.num_layers // 2] = 1
        parts.append(bits)
    sol = Solution(
        partition=parts,
        mapping=[[2] * g.num_layers for g in graphs],
        priority=[0, 1, 2], dtype=[0, 1, 0], backend=[0, 0, 0],
    )
    procs = mobile_processors()
    base_ms = None
    makespans = []
    for pool, shared, label in [(False, False, "no_opt"),
                                (True, False, "pool"),
                                (True, True, "pool+shared")]:
        rt = PuzzleRuntime(graphs, sol, procs, zoo,
                           RuntimeConfig(tensor_pool=pool, shared_buffer=shared),
                           device=device)
        try:
            res = rt.run_periodic([[0, 1, 2]], [0.02], num_requests=12)
            ms = statistics.mean(s.makespan for s in res[0])
            stats = rt.stats()
        finally:
            rt.close()
        if base_ms is None:
            base_ms = ms
        makespans.append(ms)
        emit(f"table5.{label}", ms * 1e6,
             f"rel_makespan={ms / base_ms:.3f};mallocs={stats['pool']['mallocs']};"
             f"memcpy_bytes={stats['pool']['memcpy_bytes']};"
             f"staged={stats['transport']['staged_copies']}")
    return makespans


def _r2_ulps(scalar, batch, n: int) -> float:
    """R2's contract between the per-solution objectives and the batch's:
    each group's mean within ``n`` ulps (``n`` requests summed in two
    orders), every p90 equal. Returns the largest gap in ulps."""
    worst = 0.0
    for row_s, row_b in zip(scalar, batch, strict=True):
        for i, (s, b) in enumerate(zip(row_s, row_b, strict=True)):
            if s == b:
                continue
            gap = abs(b - s) / math.ulp(s) if i % 2 == 0 and math.isfinite(s) else math.inf
            assert gap <= n, f"batch objectives outside R2's bound: {s} vs {b} ({gap} ulps)"
            worst = max(worst, gap)
    return worst


def bench_simspeed(args, device, *, generation: int = 40, crossover_lanes: int = 80,
                   out_dir: str = RESULTS_DIR) -> Dict[str, object]:
    """Old-vs-new evaluation engine: parity, µs/eval, end-to-end speedup,
    then the batch tiers on one GA generation of ``2 × generation``
    candidates and the compiled tier on ``crossover_lanes`` lanes of a
    compact scenario. Returns the record."""
    from ..core import batchsim as _batchsim
    from ..core import batchsim_compiled as _bsc
    from ..kernels.batchsim_advance import batchsim_advance as _b1

    groups = random_scenarios(
        MODEL_NAMES, count=1, models_per_scenario=6, num_groups=3, seed=7,
    )[0]
    record: Dict[str, object] = {"scenario": [list(g) for g in groups],
                                 "device": device_record(device)}

    def make_analyzer(engine: str, saturation_mode: str) -> StaticAnalyzer:
        graphs = all_cost_graphs()
        procs, prof = _profiler()
        scen = build_scenario("simspeed", groups, graphs)
        # "reference" emulates the seed path end to end: generator-coroutine
        # DES, per-simulation re-decode, pure-Python NSGA, 117-point α grid.
        cfg = AnalyzerConfig(
            engine=engine, saturation_mode=saturation_mode,
            ga=GAConfig(pop_size=20, max_generations=30, min_generations=10,
                        seed=0, vectorized_nsga=(engine == "fast")),
        )
        return StaticAnalyzer(scen, procs, prof, PAPER_COMM_MODEL, cfg, device=device)

    an = make_analyzer("fast", "bisect")
    an.factory.rng = random.Random(123)
    sols = [an.factory.random_solution() for _ in range(12)]

    # 1) parity: identical makespans on the deterministic scenario, clean
    #    and measured (noisy + dispatch overhead) paths.
    max_diff = 0.0
    for measured in (False, True):
        ref = an.simulate(sols[0], 1.0, 24, measured=measured, seed=5,
                          engine="reference")
        fast = an.simulate(sols[0], 1.0, 24, measured=measured, seed=5,
                           engine="fast")
        pairs = list(zip(ref.makespans(), fast.makespans()))
        assert pairs, "no requests simulated"
        # dropped requests are inf on both sides: inf == inf is agreement
        diff = max(
            0.0 if math.isinf(a) and math.isinf(b) else abs(a - b)
            for a, b in pairs
        )
        max_diff = max(max_diff, diff)
    emit("simspeed.parity", 0.0,
         f"max_makespan_diff={max_diff:.3e};ok={max_diff == 0.0}")
    record["parity_max_diff"] = max_diff

    # 2) µs per objectives() evaluation across distinct solutions (cold
    #    decode each time for both engines).
    def time_evals(engine: str) -> float:
        a = make_analyzer(engine, "bisect")
        t0 = time.perf_counter()
        for s in sols:
            a.objectives(s, engine=engine)
        return (time.perf_counter() - t0) / len(sols)

    ref_us = time_evals("reference") * 1e6
    fast_us = time_evals("fast") * 1e6
    emit("simspeed.eval_reference", ref_us, "per objectives() call")
    emit("simspeed.eval_fastsim", fast_us,
         f"per objectives() call;speedup=x{ref_us / fast_us:.2f}")
    record["eval_us_reference"] = ref_us
    record["eval_us_fastsim"] = fast_us

    # 3) per-α score cost for a fixed solution: the decode cache amortizes
    #    decoding + cost annotation across the whole α sweep.
    alphas = [round(0.5 + 0.25 * i, 4) for i in range(16)]
    t0 = time.perf_counter()
    for a_ in alphas:
        an.score(sols[1], a_)
    sweep_fast_us = (time.perf_counter() - t0) / len(alphas) * 1e6
    an_ref = make_analyzer("reference", "grid")
    t0 = time.perf_counter()
    for a_ in alphas:
        an_ref.score(sols[1], a_)
    sweep_ref_us = (time.perf_counter() - t0) / len(alphas) * 1e6
    emit("simspeed.score_per_alpha_reference", sweep_ref_us, "36-request sims")
    emit("simspeed.score_per_alpha_fastsim", sweep_fast_us,
         f"speedup=x{sweep_ref_us / sweep_fast_us:.2f}")
    record["score_per_alpha_us_reference"] = sweep_ref_us
    record["score_per_alpha_us_fastsim"] = sweep_fast_us

    # 4) α*-search: 117-point grid vs bracket+bisect (both on fastsim).
    sat_sol = an.npu_only()
    t0 = time.perf_counter()
    grid = an.saturation(sat_sol, mode="grid")
    grid_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bis = an.saturation(sat_sol, mode="bisect")
    bis_s = time.perf_counter() - t0
    emit("simspeed.alpha_star_grid", grid_s * 1e6,
         f"alpha_star={grid.alpha_star};evals={len(grid.scores)}")
    emit("simspeed.alpha_star_bisect", bis_s * 1e6,
         f"alpha_star={bis.alpha_star};evals={len(bis.scores)};"
         f"agrees={bis.alpha_star == grid.alpha_star}")
    record["alpha_star_grid"] = grid.alpha_star
    record["alpha_star_bisect"] = bis.alpha_star
    record["alpha_star_evals_grid"] = len(grid.scores)
    record["alpha_star_evals_bisect"] = len(bis.scores)

    # 5) end-to-end: GA search + one saturation sweep, seed path vs fast
    #    path, min-of-2 interleaved, the collector paused in each timed leg.
    def end_to_end(engine: str, mode: str) -> Tuple[float, float, int]:
        a = make_analyzer(engine, mode)
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            ga = a.run_ga()
            sat = a.saturation(ga.pareto[0])
            dt = time.perf_counter() - t0
        finally:
            gc.enable()
        return dt, sat.alpha_star, ga.evaluations

    old_s = new_s = float("inf")
    for _ in range(2):
        t, old_alpha, old_evals = end_to_end("reference", "grid")
        old_s = min(old_s, t)
        t, new_alpha, new_evals = end_to_end("fast", "bisect")
        new_s = min(new_s, t)
    emit("simspeed.e2e_seed_path", old_s * 1e6,
         f"alpha_star={old_alpha};ga_evals={old_evals}")
    emit("simspeed.e2e_fast_path", new_s * 1e6,
         f"alpha_star={new_alpha};ga_evals={new_evals};"
         f"speedup=x{old_s / new_s:.2f}")
    record["e2e_seconds_seed_path"] = old_s
    record["e2e_seconds_fast_path"] = new_s
    record["e2e_speedup"] = old_s / new_s
    record["e2e_alpha_star"] = {"seed_path": old_alpha, "fast_path": new_alpha}

    # 6) one GA generation (parents + offspring) through the per-solution
    #    fast path, one in-process numpy lock-step pass and the pass sharded
    #    across a 2-process pool. The two batch passes are equal; against
    #    the per-solution loop they keep R2's contract (the group means sum
    #    in two orders: n ulps for n requests), the reference's own.
    gen_an = make_analyzer("fast", "bisect")
    gen_an.factory.rng = random.Random(4242)
    parents = [gen_an.factory.random_solution() for _ in range(generation)]
    offspring = []
    for i in range(0, generation - 1, 2):
        a, b = parents[i], parents[i + 1]
        c1, c2 = gen_an.factory.crossover(a, b)
        offspring.append(gen_an.factory.mutate(c1))
        offspring.append(gen_an.factory.mutate(c2))
    population = parents + offspring

    def time_population(fn, an) -> Tuple[float, object]:
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            out = fn(an)
            _sync(device)
            return time.perf_counter() - t0, out
        finally:
            gc.enable()

    loop_an = make_analyzer("fast", "bisect")
    per_s, objs_loop = time_population(
        lambda a: [a.objectives(s) for s in population], loop_an)
    bat_s, objs_batch = time_population(
        lambda a: a.objectives_batch(population),
        make_analyzer("fast", "bisect"))
    # the raw 2-process cost: a generation sits below SHARD_MIN_LANES, so
    # the threshold is lowered for this timing only
    an_sh = make_analyzer("fast", "bisect")
    an_sh.cfg.batch_workers = 2
    an_sh2 = make_analyzer("fast", "bisect")
    an_sh2.cfg.batch_workers = 2
    saved_min = _batchsim.SHARD_MIN_LANES
    _batchsim.SHARD_MIN_LANES = 0
    try:
        an_sh.objectives_batch(population[:4])  # warm the pool + caches
        an_sh2._batch_pool = an_sh._batch_pool  # reuse the live pool
        shard_s, objs_shard = time_population(
            lambda a: a.objectives_batch(population), an_sh2)
    finally:
        _batchsim.SHARD_MIN_LANES = saved_min
        an_sh2._batch_pool = None
        an_sh.close()
    assert objs_batch == objs_shard, "batch parity violated: in-process vs sharded"
    n_req = loop_an.cfg.fast_requests
    r2_ulps = _r2_ulps(objs_loop, objs_batch, n_req)
    n = len(population)
    per_us, bat_us, shard_us = (x / n * 1e6 for x in (per_s, bat_s, shard_s))
    best_us = min(bat_us, shard_us)
    emit("simspeed.pop_eval_per_solution", per_us,
         f"{n}-candidate generation;evals_per_s={1e6 / per_us:.0f}")
    emit("simspeed.pop_eval_batch", bat_us,
         f"one lock-step pass;speedup=x{per_us / bat_us:.2f};"
         f"r2_max_ulps={r2_ulps:g} (bound {n_req})")
    emit("simspeed.pop_eval_batch_sharded", shard_us,
         f"2-process shards (forced below SHARD_MIN_LANES="
         f"{saved_min});speedup=x{per_us / shard_us:.2f}")
    record["eval_us_population_per_solution"] = per_us
    record["eval_us_batch"] = best_us
    record["eval_us_batch_inprocess"] = bat_us
    record["eval_us_batch_sharded"] = shard_us
    record["batch_speedup"] = per_us / best_us
    record["batch_parity_ok"] = True
    record["batch_r2_max_ulps"] = r2_ulps
    record["shard_min_lanes"] = saved_min

    # 6b) the compiled tier on the same generation: B1 on the card (its
    #     plain pass on the CPU). The first pass loads the kernel and is
    #     printed beside the warm one; a fallback to the numpy tier fails
    #     the leg, and every objective is held to both the per-solution
    #     loop (FastSimulator) and the numpy batch (BatchSimulator).
    from ..core import (COMPILED_ABS_TOL, COMPILED_REL_TOL, BatchLane, BatchSimulator,
                        FastSimulator, NoiseModel, SolutionFactory, build_spec, chain_graph)
    from ..core.batchsim_compiled import run_batch_compiled

    fallbacks0 = dict(_bsc.fallbacks)
    launches0 = _b1.launches
    an_c = make_analyzer("fast", "bisect")
    an_c.cfg.batch_engine = "compiled"
    cold_s, objs_cold = time_population(
        lambda a: a.objectives_batch(population), an_c)
    an_c2 = make_analyzer("fast", "bisect")
    an_c2.cfg.batch_engine = "compiled"
    comp_s, objs_comp = time_population(
        lambda a: a.objectives_batch(population), an_c2)
    assert _bsc.last_stats.get("fallback") is False, _bsc.last_stats
    comp_diff = 0.0
    for objs in (objs_cold, objs_comp):
        for want in (objs_loop, objs_batch):
            for row_a, row_b in zip(want, objs, strict=True):
                for x, y in zip(row_a, row_b, strict=True):
                    assert _close(x, y, COMPILED_ABS_TOL, COMPILED_REL_TOL), \
                        f"compiled tolerance violated: {x} vs {y}"
                    if not (math.isinf(x) or math.isinf(y)):
                        comp_diff = max(comp_diff, abs(x - y))
    comp_launches = _b1.launches - launches0
    comp_us = comp_s / n * 1e6
    comp_speedup = per_us / comp_us
    emit("simspeed.pop_eval_batch_compiled", comp_us,
         f"B1 on {device.type};launches={comp_launches};speedup=x{comp_speedup:.2f};"
         f"vs_numpy=x{bat_us / comp_us:.2f};max_diff={comp_diff:.3e};"
         f"cold_us={cold_s / n * 1e6:.2f}")
    record["eval_us_batch_compiled"] = comp_us
    record["eval_us_batch_compiled_cold"] = cold_s / n * 1e6
    record["compiled_speedup_full_scenario"] = comp_speedup
    record["compiled_max_diff"] = comp_diff
    record["compiled_launches_full_scenario"] = comp_launches
    record["eval_us_batch"] = min(best_us, comp_us)

    # 6c) compiled crossover leg: a compact 2-group scenario at GA width
    #     (measured noise + dispatch, 20 requests), timed through all three
    #     batch-capable paths on identical lanes.
    procs_x, prof_x = _profiler()
    nets_x = [
        chain_graph("m0", [("conv", 6e6, 2500, 7500)] * 3),
        chain_graph("m1", [("conv", 9e6, 3000, 9000)] * 4),
        chain_graph("m2", [("fc", 4e6, 2000, 5000)] * 3),
        chain_graph("m3", [("conv", 7e6, 2800, 8000)] * 3),
    ]
    groups_x = [[0, 1], [2, 3]]
    periods_x = (0.033, 0.05)
    fac_x = SolutionFactory(nets_x, num_processors=len(procs_x),
                            rng=random.Random(9), cut_prob=0.3)
    lanes_x = []
    for i in range(crossover_lanes):
        spec_x = build_spec(decode_solution(fac_x.random_solution(), nets_x),
                            procs_x, prof_x, PAPER_COMM_MODEL)
        lanes_x.append(BatchLane(
            spec=spec_x, periods=periods_x, num_requests=20,
            noise=NoiseModel(seed=i), dispatch_overhead=150e-6))
    launches_x0 = _b1.launches
    t0 = time.perf_counter()
    run_batch_compiled(lanes_x, groups_x, procs_x, device=device)
    _sync(device)
    cold_x_s = time.perf_counter() - t0
    gc.collect()
    t0 = time.perf_counter()
    res_x = run_batch_compiled(lanes_x, groups_x, procs_x, device=device)
    _sync(device)
    comp_x_s = time.perf_counter() - t0
    assert res_x is not None, _bsc.last_stats
    assert _bsc.last_stats.get("fallback") is False, _bsc.last_stats
    t0 = time.perf_counter()
    fast_x = [
        FastSimulator(ln.spec, groups=groups_x, periods=ln.periods,
                      num_requests=ln.num_requests, noise=ln.noise,
                      dispatch_overhead=ln.dispatch_overhead).run()
        for ln in lanes_x
    ]
    scal_x_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np_x = BatchSimulator(lanes_x, groups_x, procs_x).run()
    np_x_s = time.perf_counter() - t0
    diff_x = 0.0
    for i, fr in enumerate(fast_x):
        got = [q.makespan for q in res_x.result(i).requests]
        for want in ([q.makespan for q in fr.requests],
                     [q.makespan for q in np_x.result(i).requests]):
            for a, b in zip(want, got, strict=True):
                assert _close(a, b, COMPILED_ABS_TOL, COMPILED_REL_TOL), \
                    f"compiled tolerance violated: {a} vs {b}"
                if not (math.isinf(a) or math.isinf(b)):
                    diff_x = max(diff_x, abs(a - b))
    launches_x = _b1.launches - launches_x0
    fallbacks = {r: _bsc.fallbacks[r] - fallbacks0[r] for r in _bsc.fallbacks}
    assert not any(fallbacks.values()), f"compiled legs fell back: {fallbacks}"
    if device.type == "cuda":
        assert comp_launches > 0 and launches_x > 0, "B1 never launched"
    nx = len(lanes_x)
    emit("simspeed.compiled_crossover", comp_x_s / nx * 1e6,
         f"compact 2-group scenario;B1 on {device.type};launches={launches_x};"
         f"scalar_us={scal_x_s / nx * 1e6:.0f};numpy_us={np_x_s / nx * 1e6:.0f};"
         f"vs_numpy=x{np_x_s / comp_x_s:.2f};vs_scalar=x{scal_x_s / comp_x_s:.2f};"
         f"max_diff={diff_x:.3e};cold_us={cold_x_s / nx * 1e6:.0f}")
    record["compiled_speedup"] = np_x_s / comp_x_s
    record["compiled_speedup_vs_scalar"] = scal_x_s / comp_x_s
    record["compiled_crossover_us_scalar"] = scal_x_s / nx * 1e6
    record["compiled_crossover_us_compiled"] = comp_x_s / nx * 1e6
    record["compiled_crossover_us_compiled_cold"] = cold_x_s / nx * 1e6
    record["compiled_crossover_us_numpy"] = np_x_s / nx * 1e6
    record["compiled_crossover_max_diff"] = diff_x
    record["compiled_launches"] = comp_launches + launches_x
    record["compiled_fallbacks"] = fallbacks

    # batched population α*-search over a candidate set (Pareto-front shape)
    sat_cands = parents[:8]
    k = len(sat_cands)
    sat_per_s, sat_loop = time_population(
        lambda a: [a.saturation(s) for s in sat_cands],
        make_analyzer("fast", "bisect"))
    sat_bat_s, sat_batch = time_population(
        lambda a: a.population_saturation(sat_cands),
        make_analyzer("fast", "bisect"))
    assert [r.alpha_star for r in sat_loop] == \
        [r.alpha_star for r in sat_batch], "saturation parity violated"
    emit("simspeed.pop_alpha_star_per_solution", sat_per_s / k * 1e6,
         "bisect per candidate")
    emit("simspeed.pop_alpha_star_batch", sat_bat_s / k * 1e6,
         f"batched rounds;speedup=x{sat_per_s / sat_bat_s:.2f}")
    record["alpha_star_us_population_per_solution"] = sat_per_s / k * 1e6
    record["alpha_star_us_population_batch"] = sat_bat_s / k * 1e6

    if getattr(args, "json", False):
        record["timestamp"] = time.time()
        emit("simspeed.json", 0.0, _write_record(record, out_dir, "BENCH_simspeed.json"))
    return record


def bench_conformance(args, device) -> None:
    """Runtime↔simulator conformance: zero-diff assertion + replay cost.

    Replays deterministic schedules of a 2-group scenario on the
    virtual-clock PuzzleRuntime and diffs release/start/finish timestamps
    and makespans against FastSimulator under measured (noise + dispatch)
    conditions. The diff must be zero.
    """
    from ..core import SolutionFactory
    from ..runtime.conformance import run_virtual_schedule

    an = _analyzer([["face_det", "selfie_seg"], ["yolov8n", "fast_scnn"]], device,
                   name="conformance", seed=0)
    fac = SolutionFactory(an.scenario.graphs, num_processors=3,
                          rng=random.Random(7))
    solutions = [fac.random_solution() for _ in range(4)]
    nr = 12 if getattr(args, "smoke", False) else 24

    reports = []
    t0 = time.perf_counter()
    for sol in solutions:
        reports.append(an.validate_on_runtime(
            sol, alpha=1.0, num_requests=nr, measured=True, seed=0))
    t_validate = (time.perf_counter() - t0) / len(solutions)
    assert all(r.passed for r in reports), "virtual runtime diverged"
    max_diff = max(max(r.max_release_diff, r.max_start_diff,
                       r.max_finish_diff, r.max_makespan_diff)
                   for r in reports)
    assert max_diff == 0.0, f"virtual runtime differs from the simulator by {max_diff}"
    tasks = sum(r.runtime_tasks for r in reports)

    t0 = time.perf_counter()
    for sol in solutions:
        an.simulate(sol, 1.0, nr, measured=True, collect_tasks=True)
    t_sim = (time.perf_counter() - t0) / len(solutions)
    t0 = time.perf_counter()
    for sol in solutions:
        run_virtual_schedule(
            an.scenario.graphs, sol, an.processors, an.solution_spec(sol),
            an.scenario.groups, an.base_periods, nr,
            noise=an.cfg.noise, dispatch_overhead=an.cfg.dispatch_overhead)
    t_rt = (time.perf_counter() - t0) / len(solutions)

    emit("conformance.zero_diff", t_validate * 1e6,
         f"ok=True;max_abs_diff={max_diff};tasks={tasks}")
    emit("conformance.fastsim_replay", t_sim * 1e6, f"requests={nr}")
    emit("conformance.virtual_runtime_replay", t_rt * 1e6,
         f"overhead=x{t_rt / t_sim:.2f} vs fastsim")


def _sweep_sizing(args, section: str, explicit_count: int,
                  full_count: int = 10):
    """(scenario count, SweepConfig) for a sweep-harness-backed section.

    Full sizing when the section is selected explicitly or ``--full`` asks
    for the paper's full protocol; otherwise (the default all-sections pass,
    or ``--smoke``) a 2-scenario tiny GA keeps the pass quick.
    """
    from . import SweepConfig

    explicit = getattr(args, "full", False) or section in (
        getattr(args, "section", None), getattr(args, "only", None))
    if getattr(args, "smoke", False) or not explicit:
        return 2, SweepConfig(
            pop_size=8, max_generations=6, min_generations=2, bm_max_evals=30,
        )
    return (full_count if args.full else explicit_count), SweepConfig()


def _sweep(specs, config, device, prefix: str):
    import tempfile

    from .sweep import run_sweep

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=prefix) as run_dir:
        doc = run_sweep(specs, config, run_dir=run_dir, workers=1, device=device)
    return doc, time.perf_counter() - t0


def _stars(row) -> str:
    from . import METHODS
    return ";".join(
        f"{m}={'never' if row['alpha_star'][m] is None else row['alpha_star'][m]}"
        for m in METHODS)


def bench_sweep(args, device) -> None:
    """Scenario-sweep harness: per-scenario α* + aggregates, and the
    determinism canary. Smoke sizing on ``--smoke`` and the default pass;
    4 scenarios at the harness's real GA sizing when selected, 10 with
    ``--full``. Always evaluates into a fresh temp run dir."""
    from . import METHODS, generate_scenario_specs

    count, config = _sweep_sizing(args, "sweep", explicit_count=4)
    specs = generate_scenario_specs(count, seed=2025)
    doc, wall = _sweep(specs, config, device, "puzzle_sweep_bench_")
    for row in doc["scenarios"]:
        emit(f"sweep.{row['spec']['name']}", row["wall_s"] * 1e6, _stars(row))
    agg = doc["aggregate"]
    emit("sweep.gain_vs_npu_only", wall * 1e6 / count,
         f"{agg['speedup_geomean']['vs_npu_only']:.2f}x (paper 3.7x)")
    emit("sweep.gain_vs_best_mapping", wall * 1e6 / count,
         f"{agg['speedup_geomean']['vs_best_mapping']:.2f}x (paper 2.2x)")
    sat = agg["satisfaction_rate"]
    emit("sweep.satisfaction", wall * 1e6,
         ";".join(f"{m}={sat[m]:.2f}" for m in METHODS))
    # determinism canary: regenerating the specs must reproduce the stored
    # scenario compositions bit-for-bit
    again = [s.to_json() for s in generate_scenario_specs(count, seed=2025)]
    stored = [row["spec"] for row in doc["scenarios"]]
    emit("sweep.deterministic", 0.0, f"ok={again == stored}")


def bench_arrivals(args, device) -> None:
    """Puzzle vs baselines under bursty load (the arrival-process axis):
    the same compositions under periodic, jittered (±25% of Φ) and Poisson
    traffic; each method's α*, the geo-mean gains and satisfaction."""
    from . import METHODS, generate_scenario_specs

    count, config = _sweep_sizing(args, "arrivals", explicit_count=3,
                                  full_count=6)
    for kind in ("periodic", "jittered", "poisson"):
        specs = generate_scenario_specs(count, seed=2025, arrival=kind)
        doc, wall = _sweep(specs, config, device, f"puzzle_arrivals_{kind}_")
        for row in doc["scenarios"]:
            emit(f"arrivals.{kind}.{row['spec']['name']}",
                 row["wall_s"] * 1e6, _stars(row))
        agg = doc["aggregate"]
        sat = agg["satisfaction_rate"]
        emit(f"arrivals.{kind}.gain", wall * 1e6 / count,
             f"vs_npu={agg['speedup_geomean']['vs_npu_only']:.2f}x;"
             f"vs_bm={agg['speedup_geomean']['vs_best_mapping']:.2f}x;"
             + ";".join(f"sat_{m}={sat[m]:.2f}" for m in METHODS))


def bench_faults(args, device) -> None:
    """Fault injection + graceful degradation on the virtual runtime.

    One deterministic 2-group scenario, one solution that places work on
    processor 2, three virtual-clock runs: ``clean``; ``raw`` (a mid-run
    permanent dropout of processor 2 plus heavy-tailed stragglers, no
    recovery); ``recovered`` (the same with the RecoveryPolicy). Then the
    remap's recovery latency and the analyzer's ``score_under_faults``.
    """
    from ..core import FaultSpec, SolutionFactory
    from ..core.scoring import deadline_satisfaction
    from ..runtime import PuzzleRuntime, RecoveryPolicy, RuntimeConfig

    explicit = getattr(args, "full", False) or "faults" in (
        getattr(args, "section", None), getattr(args, "only", None))
    nr = 16 if explicit and not getattr(args, "smoke", False) else 8

    an = _analyzer([["face_det", "selfie_seg"], ["yolov8n"]], device,
                   name="faults", seed=0)
    graphs = list(an.scenario.graphs)
    groups = [list(g) for g in an.scenario.groups]
    base_periods = list(an.base_periods)

    # a draw that actually uses processor 2, so the dropout bites
    sol = None
    for seed in range(64):
        fac = SolutionFactory(graphs, num_processors=len(an.processors),
                              rng=random.Random(seed))
        cand = fac.random_solution()
        if any(p.processor == 2
               for pl in decode_solution(cand, graphs) for p in pl):
            sol = cand
            break
    assert sol is not None, "no draw places work on processor 2"
    spec = an.solution_spec(sol)

    def run(periods, faults, recovery):
        rt = PuzzleRuntime(
            graphs, sol, an.processors,
            config=RuntimeConfig(virtual=True, faults=faults,
                                 recovery=recovery),
            spec=spec,
        )
        t0 = time.perf_counter()
        with rt:
            states = rt.run_periodic(groups, periods, num_requests=nr)
        return rt, states, time.perf_counter() - t0

    # arrivals stay at the paper's base periods (congested); deadlines are
    # calibrated per group from the clean run
    _, clean_states, t_clean = run(base_periods, None, None)
    deadlines = [1.2 * max(st.makespan for st in gl) for gl in clean_states]
    alpha = round(max(d / p for d, p in zip(deadlines, base_periods)), 2)
    emit("faults.deadlines", 0.0,
         ";".join(f"g{g}={d:.4f}s" for g, d in enumerate(deadlines))
         + f";alpha_equiv={alpha}")

    def sat(states):
        per_group = [[float("inf") if st.makespan is None else st.makespan
                      for st in gl] for gl in states]
        dropped = sum(st.makespan is None for gl in states for st in gl)
        return deadline_satisfaction(per_group, deadlines), dropped

    sat_clean, drop_clean = sat(clean_states)
    horizon = max(st.last_finish or 0.0
                  for gl in clean_states for st in gl)
    t_drop = round(0.35 * horizon, 6)
    faults = FaultSpec(dropouts=((2, t_drop, None),),
                       straggler_prob=0.1, straggler_shape=1.5, seed=2025)

    rt_raw, raw_states, t_raw = run(base_periods, faults, None)
    sat_raw, drop_raw = sat(raw_states)
    rt_rec, rec_states, t_rec = run(base_periods, faults, RecoveryPolicy())
    sat_rec, drop_rec = sat(rec_states)

    emit("faults.clean", t_clean * 1e6,
         f"satisfaction={sat_clean:.2f};dropped={drop_clean};requests={nr * 3}")
    emit("faults.raw", t_raw * 1e6,
         f"satisfaction={sat_raw:.2f};dropped={drop_raw};"
         f"delta_vs_clean={sat_clean - sat_raw:+.2f}")
    remaps = [e for e in rt_rec.recovery_events if e.kind == "remap"]
    retries = [e for e in rt_rec.recovery_events if e.kind == "retry"]
    emit("faults.recovered", t_rec * 1e6,
         f"satisfaction={sat_rec:.2f};dropped={drop_rec};"
         f"delta_vs_clean={sat_clean - sat_rec:+.2f};"
         f"remaps={len(remaps)};retries={len(retries)}")

    # recovery latency: drain time of the requests in flight at the drop
    inflight = [st for gl in rec_states for st in gl
                if st.submitted <= t_drop
                and (st.last_finish is None or st.last_finish > t_drop)]
    if inflight and all(st.last_finish is not None for st in inflight):
        latency = max(st.last_finish for st in inflight) - t_drop
        emit("faults.recovery_latency", latency * 1e6,
             f"t_drop={t_drop};inflight={len(inflight)}")
    else:
        emit("faults.recovery_latency", 0.0,
             f"t_drop={t_drop};inflight={len(inflight)};drained=False")

    # analyzer-side robustness objective (simulator tiers, measured path)
    rep = an.score_under_faults(sol, faults=faults, alpha=alpha,
                                num_requests=nr)
    emit("faults.score_under_faults", 0.0,
         f"sat_clean={rep['satisfaction_clean']:.2f};"
         f"sat_faulted={rep['satisfaction_faulted']:.2f};"
         f"dropped_clean={rep['dropped_clean']:.0f};"
         f"dropped_faulted={rep['dropped_faulted']:.0f};"
         f"score_delta={rep['score_delta']:.3f}")


def bench_roofline(args, device, *, results_dir: str = DRYRUN_DIR) -> None:
    """Roofline terms per (arch × shape) from the port's dry-run records
    (``python -m repro_torch.launch.dryrun``): the largest term and the
    bottleneck of each, for the H100's datasheet rates."""
    files = sorted(glob.glob(os.path.join(results_dir, "*__single.json")))
    if not files:
        emit("roofline.missing", 0.0, "run repro_torch.launch.dryrun first")
        return
    for f in files:
        with open(f) as fh:
            d = json.load(fh)
        if not d.get("ok"):
            emit(f"roofline.{d['arch']}.{d['shape']}", 0.0, "FAILED")
            continue
        dom = max(("t_compute", "t_memory", "t_collective"),
                  key=lambda k: d[k])
        emit(
            f"roofline.{d['arch']}.{d['shape']}",
            d[dom] * 1e6,
            f"bottleneck={d['bottleneck']};compute={d['t_compute']:.4f}s;"
            f"memory={d['t_memory']:.4f}s;collective={d['t_collective']:.4f}s;"
            f"useful={d['useful_ratio']:.2f}",
        )


def _timed_calls(fn, device) -> float:
    """Microseconds per call of ``fn`` over 5 calls (the reference's
    kernels row) after one warm-up, synchronised."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / 5 * 1e6


def bench_kernels(args, device) -> List[Dict[str, object]]:
    """The three Pallas kernels' counterparts against their oracles.

    K2 at the reference's row, q (8, 512, 128), k/v (2, 512, 128), GQA 4,
    causal, in f32 (the ``simt`` route on the card) and bf16 (``sm90``),
    against ``attention_ref`` and ``flash_attention_plain``, timed through
    the production attention path (``models.attention.blockwise_attention``);
    K3 at ``tests/test_kernels.py``'s (4, 128, 64, 32, chunk 32) in f32 and
    bf16 against ``ssd_ref`` and ``ssd_scan_plain``; K1 at its (100, 128)
    against ``quantize_int8_plain``. Each row prints the route, the
    launches it made and the errors. On the CPU the wrappers run the plain
    versions: a check of the oracles only. Returns the rows' numbers, each
    with its ``outputs``: (kernel, plain version) pairs on the host, for a
    caller to hold to its own tolerance."""
    from ..kernels import (attention_ref, flash_attention, flash_attention_plain,
                           quantize_int8, quantize_int8_plain, ssd_ref, ssd_scan,
                           ssd_scan_plain)
    from ..kernels.flash_attention import _route as attention_route
    from ..kernels.int8_quant import _route as quant_route
    from ..kernels.ssd_scan import _route as ssd_route
    from ..models.attention import blockwise_attention

    on_card = device.type == "cuda"
    note = "" if on_card else ";plain version on the CPU: oracle check only"
    rng = np.random.default_rng(0)

    def tensor(shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale
                                ).to(device=device, dtype=dtype)

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    rows: List[Dict[str, object]] = []

    def row(name, kernel, route, launches0, us, outputs, **numbers):
        launches = kernel.launches - launches0
        numbers = dict(numbers, launches=launches,
                       route=route if on_card else "plain")
        rows.append(dict(numbers, name=name, us=us, outputs=[
            (a.detach().cpu(), b.detach().cpu()) for a, b in outputs]))
        emit(name, us, ";".join(f"{k}={v:.2e}" if isinstance(v, float) else f"{k}={v}"
                                for k, v in numbers.items()) + note)

    q32 = tensor((8, 512, 128))
    k32 = tensor((2, 512, 128))
    v32 = tensor((2, 512, 128))
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, ".bf16")):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        launches0 = flash_attention.launches
        got = flash_attention(q, k, v, q_heads_per_kv=4)
        want = attention_ref(q, k, v, q_heads_per_kv=4)
        plain = flash_attention_plain(q, k, v, q_heads_per_kv=4)
        qb = q.reshape(1, 8, 512, 128).transpose(1, 2)
        kb = k.reshape(1, 2, 512, 128).transpose(1, 2)
        us = _timed_calls(lambda: blockwise_attention(qb, kb, kb), device)
        row(f"kernels.flash_attention{suffix}", flash_attention,
            attention_route(dtype, 128), launches0, us, [(got, plain)], dtype=str(dtype)[6:],
            max_err_vs_ref=err(got, want), max_err_vs_plain=err(got, plain))

    bh, s, p, n, chunk = 4, 128, 64, 32, 32
    x32 = tensor((bh, s, p))
    dt = torch.nn.functional.softplus(tensor((bh, s)))
    A = -torch.exp(tensor((bh,), 0.3))
    B32, C32 = tensor((bh, s, n), 0.3), tensor((bh, s, n), 0.3)
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, ".bf16")):
        x, Bm, Cm = (t.to(dtype) for t in (x32, B32, C32))
        launches0 = ssd_scan.launches
        y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        want_y, want_st = ssd_ref(x, dt, A, Bm, Cm)
        plain_y, plain_st = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
        us = _timed_calls(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=chunk), device)
        row(f"kernels.ssd_scan{suffix}", ssd_scan, ssd_route(dtype, p, n, chunk),
            launches0, us, [(y, plain_y), (st, plain_st)], dtype=str(dtype)[6:],
            max_err_vs_ref=max(err(y, want_y), err(st, want_st)),
            max_err_vs_plain=max(err(y, plain_y), err(st, plain_st)))

    xq = tensor((100, 128), 3.0)
    launches0 = quantize_int8.launches
    q8, scale = quantize_int8(xq)
    q8_plain, scale_plain = quantize_int8_plain(xq)
    us = _timed_calls(lambda: quantize_int8(xq), device)
    row("kernels.quantize_int8", quantize_int8, quant_route(xq), launches0, us,
        [(q8, q8_plain), (scale, scale_plain)], dtype="float32", q_mismatches_vs_plain=int((q8 != q8_plain).sum()),
        max_scale_err_vs_plain=err(scale, scale_plain))
    return rows


def bench_prescreen(args, device, *, out_dir: str = RESULTS_DIR) -> Dict[str, object]:
    """Static pre-screen: simulations avoided per GA run.

    One deterministic 2-group scenario, twice: unconstrained (prescreen on
    vs off must give identical fronts and evaluation counts; asserted) and
    with an NPU memory budget that many chromosomes provably exceed (SL020):
    simulations avoided, and every pruned chromosome re-checked by actually
    provisioning it through a capacity-bounded TensorPool on ``device``
    (``false_prunes``, must be 0; asserted). Also the α*-search probe
    savings from the proven deadline floor. ``--json`` writes
    ``BENCH_prescreen.json`` under ``out_dir``. Returns the record.
    """
    import dataclasses

    from ..analysis import provision_memory
    from ..core.graph import chain_graph
    from ..core.scenarios import Scenario

    nets = (
        chain_graph("alpha", [("conv", 4e6, 1000, 4000)] * 4),
        chain_graph("beta", [("fc", 8e6, 2000, 8000)] * 3),
        chain_graph("gamma", [("dw", 1.5e6, 600, 1800)] * 5),
    )
    scenario = Scenario(name="prescreen_bench", graphs=nets,
                        groups=((0, 1), (2,)))
    procs = mobile_processors()
    profiler = Profiler(AnalyticMobileBackend(procs))

    def make_analyzer(processors, prescreen):
        return StaticAnalyzer(
            scenario, processors, profiler, PAPER_COMM_MODEL,
            AnalyzerConfig(
                prescreen=prescreen,
                ga=GAConfig(pop_size=16, max_generations=10,
                            min_generations=5, seed=7, prescreen=prescreen),
            ),
            device=device,
        )

    def front_keys(result):
        return sorted(s.key() for s in result.pareto)

    # 1. unconstrained: the pre-screen must be a no-op
    t0 = time.perf_counter()
    off = make_analyzer(procs, False).run_ga()
    t_off = time.perf_counter() - t0
    t0 = time.perf_counter()
    on = make_analyzer(procs, True).run_ga()
    t_on = time.perf_counter() - t0
    fronts_identical = (front_keys(off) == front_keys(on)
                        and off.evaluations == on.evaluations)
    assert fronts_identical, "prescreen perturbed an unconstrained GA run"
    assert on.prescreen_stats["pruned"] == 0
    emit("prescreen.unconstrained.off", t_off * 1e6,
         f"evals={off.evaluations}")
    emit("prescreen.unconstrained.on", t_on * 1e6,
         f"evals={on.evaluations};checked={on.prescreen_stats['checked']};"
         f"fronts_identical={fronts_identical}")

    # 2. NPU memory budget below what whole-model-resident schedules need
    tight_procs = [
        dataclasses.replace(p, memory_capacity=20480) if p.kind == "npu"
        else p
        for p in procs
    ]
    t0 = time.perf_counter()
    c_off = make_analyzer(tight_procs, False).run_ga()
    tc_off = time.perf_counter() - t0
    an_c = make_analyzer(tight_procs, True)
    linter = an_c.linter()
    pruned_solutions = []
    orig_prescreen = an_c.prescreen_objectives

    def recording_prescreen(sol):
        obj = orig_prescreen(sol)
        if obj is not None:
            pruned_solutions.append(sol)
        return obj

    an_c.prescreen_objectives = recording_prescreen
    t0 = time.perf_counter()
    c_on = an_c.run_ga()
    tc_on = time.perf_counter() - t0
    stats = c_on.prescreen_stats
    # adversarial ground truth: every pruned chromosome must fail to
    # provision through a real capacity-bounded TensorPool
    false_prunes = 0
    for sol in pruned_solutions:
        ok = provision_memory(linter.builder.decode(sol),
                              linter.capacities(), device=device)
        if all(ok.values()):
            false_prunes += 1
    assert false_prunes == 0, f"{false_prunes} pruned chromosomes provisioned"
    avoided_fraction = (stats["simulations_avoided"]
                        / max(1, stats["simulations_avoided"]
                              + c_on.evaluations))
    emit("prescreen.constrained.off", tc_off * 1e6,
         f"evals={c_off.evaluations}")
    emit("prescreen.constrained.on", tc_on * 1e6,
         f"evals={c_on.evaluations};pruned={stats['pruned']};"
         f"checked={stats['checked']}")
    emit("prescreen.simulations_avoided", 0.0,
         f"{stats['simulations_avoided']} ({avoided_fraction * 100:.1f}% "
         f"of GA evaluations)")
    emit("prescreen.false_prunes", 0.0, f"{false_prunes} (gate: 0)")

    # 3. α*-probe skipping: the proven deadline floor answers probes below
    # it as 0.0 without simulating, on a feasible front solution and in an
    # overloaded regime (periods ÷ 8)
    def count_probes(an, sol):
        calls = 0
        orig_score = an.score

        def counting_score(s, alpha, **kw):
            nonlocal calls
            calls += 1
            return orig_score(s, alpha, **kw)

        an.score = counting_score
        sat = an.saturation(sol)
        an.score = orig_score
        return calls, sat.alpha_star

    probe_sol = sorted(off.pareto, key=lambda s: s.key())[0]
    counts = {}
    alpha_stars = {}
    overload = {}
    for label, prescreen in (("off", False), ("on", True)):
        an = make_analyzer(procs, prescreen)
        counts[label], alpha_stars[label] = count_probes(an, probe_sol)
        an_tight = make_analyzer(procs, prescreen)
        an_tight.base_periods = [p / 8.0 for p in an_tight.base_periods]
        overload[label] = count_probes(
            an_tight, an_tight.factory.seeded_solution(0))
    assert alpha_stars["off"] == alpha_stars["on"], \
        "probe skipping changed alpha*"
    assert overload["off"][1] == overload["on"][1] == float("inf")
    emit("prescreen.alpha_probes.front", 0.0,
         f"off={counts['off']};on={counts['on']};"
         f"alpha_star={alpha_stars['on']};identical=True")
    emit("prescreen.alpha_probes.overloaded", 0.0,
         f"off={overload['off'][0]};on={overload['on'][0]};"
         f"alpha_star=inf (proven without simulation)")

    record = {
        "device": device_record(device),
        "unconstrained": {
            "evals_off": off.evaluations,
            "evals_on": on.evaluations,
            "checked": on.prescreen_stats["checked"],
            "fronts_identical": fronts_identical,
        },
        "constrained": {
            "evals_off": c_off.evaluations,
            "evals_on": c_on.evaluations,
            "prescreen_stats": dict(stats),
            "prescreen_false_prunes": false_prunes,
            "simulations_avoided_fraction": avoided_fraction,
        },
        "alpha_probes": {
            "front_off": counts["off"],
            "front_on": counts["on"],
            "front_alpha_star": alpha_stars["on"],
            "overloaded_off": overload["off"][0],
            "overloaded_on": overload["on"][0],
        },
    }
    if getattr(args, "json", False):
        record["timestamp"] = time.time()
        emit("prescreen.json", 0.0, _write_record(record, out_dir, "BENCH_prescreen.json"))
    return record


SECTIONS = {
    "table2": bench_table2,
    "table3": bench_table3,
    "table4": bench_table4,
    "fig5": bench_fig5,
    "fig12": bench_fig12,
    "fig15": bench_fig15,
    "table5": bench_table5,
    "simspeed": bench_simspeed,
    "prescreen": bench_prescreen,
    "conformance": bench_conformance,
    "sweep": bench_sweep,
    "arrivals": bench_arrivals,
    "faults": bench_faults,
    "roofline": bench_roofline,
    "kernels": bench_kernels,
}


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments.paper")
    ap.add_argument("section", nargs="?", choices=sorted(SECTIONS),
                    default=None, help="run just this section")
    ap.add_argument("--only", choices=sorted(SECTIONS), default=None)
    ap.add_argument("--full", action="store_true",
                    help="all 10 random scenarios per group setting")
    ap.add_argument("--smoke", action="store_true",
                    help="sweep-backed sections: 2 scenarios, tiny GA")
    ap.add_argument("--json", action="store_true",
                    help="also write results/paper_torch/BENCH_{simspeed,prescreen}.json")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card); 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    if args.section and args.only and args.section != args.only:
        ap.error(f"conflicting sections: positional {args.section!r} "
                 f"vs --only {args.only!r}")
    return args


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    selected = args.section or args.only
    print("name,us_per_call,derived")
    for name, fn in SECTIONS.items():
        if selected and name != selected:
            continue
        t0 = time.perf_counter()
        fn(args, device)
        emit(f"section.{name}.total", (time.perf_counter() - t0) * 1e6)


if __name__ == "__main__":
    main()
