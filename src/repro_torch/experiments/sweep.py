"""Scenario-sweep harness: the paper's randomized evaluation at scale.

Fans randomly generated scenarios (§6.1 recipe) out across a
``ProcessPoolExecutor``, runs the full pipeline per scenario through
:func:`~repro_torch.experiments.evaluate.evaluate_scenario`, and aggregates the
paper's headline metrics (α* ratios, geo-mean frequency gain vs. each
baseline, deadline-satisfaction rate) into ``RESULTS_sweep.json``.

Determinism contract: every scenario is a pure function of its
:class:`ScenarioSpec` and the :class:`SweepConfig`, with a private
SHA-256-derived RNG stream — so results are identical whatever the worker
count or completion order (``--workers 4`` ≡ ``--workers 1``), and a
re-run with the same seed reproduces the same scenarios and aggregates.

Resumability: each scenario persists to ``<run-dir>/scenario_NNN.json`` as
it completes (atomic rename); a re-run reloads finished scenarios whose
spec matches and evaluates only the remainder. The run directory stores the
sweep config and refuses to resume under a different one unless ``--force``
wipes it.

CLI::

    python -m repro_torch.experiments.sweep --scenarios 30 --seed 0 --workers 4
    python -m repro_torch.experiments.sweep --scenarios 30 --arrival poisson

``--arrival {periodic,jittered,poisson}`` opens the arrival axis: the same
scenario compositions evaluated under bursty traffic instead of the
paper's periodic sources (per-scenario SHA-256 arrival seeds keep the
determinism contract). ``--faults {none,stragglers,mixed}`` opens the
fault axis the same way: every evaluation stage (GA, α*-search,
satisfaction) runs under the scenario's injected fault ensemble — the
robustness objective. See ``--help`` for GA sizing and scenario-shape
knobs. Typical cost on a
laptop-class CPU: a handful of seconds per scenario (GA pop 20 × ≤30
generations plus three bisection α*-searches).

Port of ``repro.experiments.sweep``. ``--batch-engine compiled`` runs the
batched passes as the event-loop kernel on the card (``--device cpu``: its
plain torch pass); the pool's workers are spawned, never forked, so no
CUDA state crosses into them.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from typing import TYPE_CHECKING, Callable, Dict, Optional, Sequence, Union

from .aggregate import aggregate_results
from .evaluate import (
    METHODS,
    ScenarioResult,
    SweepConfig,
    default_context,
    evaluate_scenario,
)
from .specs import ScenarioSpec, generate_scenario_specs

if TYPE_CHECKING:
    import torch

_CONFIG_FILE = "sweep_config.json"

# Per-worker state, set once by the pool initializer so every scenario a
# worker evaluates reuses the same EvalContext (graph zoo + profiler cache).
_WORKER_CONFIG: Optional[SweepConfig] = None
_WORKER_DEVICE: Optional[Union[str, "torch.device"]] = None


def _init_worker(config: SweepConfig,
                 device: Optional[Union[str, "torch.device"]]) -> None:
    global _WORKER_CONFIG, _WORKER_DEVICE
    _WORKER_CONFIG = config
    _WORKER_DEVICE = device
    default_context(device)  # build graphs/profiler once, before the first task


def _eval_in_worker(spec: ScenarioSpec) -> ScenarioResult:
    return evaluate_scenario(spec, _WORKER_CONFIG, default_context(_WORKER_DEVICE))


def _scenario_path(run_dir: str, index: int) -> str:
    return os.path.join(run_dir, f"scenario_{index:03d}.json")


def _write_json(path: str, doc: Dict[str, object]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _load_finished(
    run_dir: str, specs: Sequence[ScenarioSpec]
) -> Dict[int, ScenarioResult]:
    """Reload completed scenarios whose stored spec matches the expected one."""
    done: Dict[int, ScenarioResult] = {}
    for spec in specs:
        path = _scenario_path(run_dir, spec.index)
        if not os.path.exists(path):
            continue
        try:
            with open(path) as f:
                result = ScenarioResult.from_json(json.load(f))
        except (ValueError, KeyError, TypeError):
            continue  # corrupt/partial file: re-evaluate
        if result.spec.to_json() == spec.to_json():
            done[spec.index] = result
    return done


def _check_run_dir(run_dir: str, config: SweepConfig, force: bool) -> None:
    os.makedirs(run_dir, exist_ok=True)
    cfg_path = os.path.join(run_dir, _CONFIG_FILE)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            stored = json.load(f)
        if stored != config.to_json():
            if not force:
                raise RuntimeError(
                    f"run dir {run_dir!r} holds results for a different sweep "
                    f"config; pass force=True/--force to discard them or "
                    f"choose a fresh --run-dir"
                )
            for name in os.listdir(run_dir):
                if name.startswith("scenario_") and name.endswith(".json"):
                    os.remove(os.path.join(run_dir, name))
    _write_json(cfg_path, config.to_json())


def run_sweep(
    specs: Sequence[ScenarioSpec],
    config: Optional[SweepConfig] = None,
    run_dir: str = "results/sweep",
    workers: int = 1,
    force: bool = False,
    log: Optional[Callable[[str], None]] = None,
    device: Optional[Union[str, "torch.device"]] = None,
) -> Dict[str, object]:
    """Evaluate ``specs``, resuming from ``run_dir``, and aggregate.

    ``workers <= 1`` evaluates inline (no process pool — handy under test
    and for debugging); otherwise scenarios fan out over a spawned
    ``ProcessPoolExecutor(workers)`` whose initializer builds one shared
    :class:`EvalContext` per worker. ``device`` is where the compiled batch
    engine runs (``None`` = the card); the other engines ignore it. Returns
    the full results document (``{"config", "scenarios", "aggregate"}``)
    with scenarios in index order; per-scenario wall times are in seconds.
    """
    config = config or SweepConfig()
    log = log or (lambda msg: None)
    _check_run_dir(run_dir, config, force)

    results = _load_finished(run_dir, specs)
    if results:
        log(f"resumed {len(results)}/{len(specs)} scenarios from {run_dir}")
    pending = [s for s in specs if s.index not in results]

    def record(result: ScenarioResult) -> None:
        results[result.spec.index] = result
        _write_json(_scenario_path(run_dir, result.spec.index),
                    result.to_json())
        stars = "  ".join(
            f"{m}={result.alpha_star[m]:.2f}" for m in METHODS
        )
        log(f"[{len(results)}/{len(specs)}] {result.spec.name} "
            f"groups={[len(g) for g in result.spec.groups]} {stars} "
            f"({result.wall_s:.1f}s)")

    if pending and workers <= 1:
        context = default_context(device)
        for spec in pending:
            record(evaluate_scenario(spec, config, context))
    elif pending:
        with ProcessPoolExecutor(
            max_workers=min(workers, len(pending)),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker, initargs=(config, device),
        ) as pool:
            futures = {pool.submit(_eval_in_worker, s) for s in pending}
            while futures:
                finished, futures = wait(futures, return_when=FIRST_COMPLETED)
                for fut in finished:
                    record(fut.result())

    ordered = [results[s.index] for s in specs]
    return {
        "config": config.to_json(),
        "scenarios": [r.to_json() for r in ordered],
        "aggregate": aggregate_results(ordered, alpha_cap=config.alpha_cap),
    }


def format_summary(doc: Dict[str, object]) -> str:
    """Human-readable recap of a results document (one string, multi-line)."""
    agg = doc["aggregate"]
    lines = [f"scenarios: {agg['num_scenarios']}"]
    if not agg["num_scenarios"]:
        return lines[0]
    for m in METHODS:
        st = agg["alpha_star"][m]
        lines.append(
            f"  {m:12s} α* mean={st['mean_capped']:.2f} "
            f"median={st['median_capped']:.2f} "
            f"saturated={st['saturated_fraction'] * 100:.0f}% "
            f"satisfaction@α=1: {agg['satisfaction_rate'][m] * 100:.0f}%"
        )
    lines.append(
        f"frequency gain (geo-mean α* ratio): "
        f"{agg['speedup_geomean']['vs_npu_only']:.2f}× vs NPU Only (paper 3.7×), "
        f"{agg['speedup_geomean']['vs_best_mapping']:.2f}× vs Best Mapping "
        f"(paper 2.2×)"
    )
    best = agg["speedup_geomean_best"]
    lines.append(
        f"frequency gain (best-schedule convention): "
        f"{best['vs_npu_only']:.2f}× vs NPU Only, "
        f"{best['vs_best_mapping']:.2f}× vs Best Mapping"
    )
    stats = [s["prescreen_stats"] for s in doc["scenarios"]
             if s.get("prescreen_stats") is not None]
    if stats:
        checked = sum(s["checked"] for s in stats)
        pruned = sum(s["pruned"] for s in stats)
        lines.append(
            f"prescreen: {pruned}/{checked} offspring pruned without "
            f"simulation across {len(stats)} scenarios"
        )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.sweep",
        description="Randomized scenario sweep reproducing the paper's "
                    "headline comparison (Puzzle vs NPU Only vs Best Mapping).",
    )
    ap.add_argument("--scenarios", type=int, default=30,
                    help="number of random scenarios (default 30)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sweep seed; fully determines scenarios and results")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool size; results are identical for any value")
    ap.add_argument("--run-dir", default=None,
                    help="resumable per-scenario output dir "
                         "(default results/sweep_s<seed>_n<scenarios>)")
    ap.add_argument("--out", default="RESULTS_sweep.json",
                    help="aggregate results file (default RESULTS_sweep.json)")
    ap.add_argument("--force", action="store_true",
                    help="discard run-dir results from a different config")
    ap.add_argument("--min-groups", type=int, default=1)
    ap.add_argument("--max-groups", type=int, default=3)
    ap.add_argument("--min-models", type=int, default=1)
    ap.add_argument("--max-models", type=int, default=4)
    ap.add_argument("--arrival", default="periodic",
                    choices=["periodic", "jittered", "poisson"],
                    help="request arrival process per group (default: "
                         "periodic, the paper's sources); non-periodic "
                         "scenarios carry per-scenario SHA-256 arrival "
                         "seeds, so results stay worker-count-invariant")
    ap.add_argument("--arrival-jitter", type=float, default=0.25,
                    help="jittered arrivals: max offset as a fraction of "
                         "the group period (default 0.25)")
    ap.add_argument("--arrival-distribution", default="uniform",
                    choices=["uniform", "lognormal"],
                    help="jitter distribution (default uniform)")
    ap.add_argument("--faults", default="none",
                    choices=["none", "stragglers", "mixed"],
                    help="injected fault ensemble per scenario (default "
                         "none): 'stragglers' = heavy-tailed per-task "
                         "inflation only, 'mixed' adds the dropout and "
                         "throttle windows; straggler draws use per-"
                         "scenario SHA-256 fault seeds, so results stay "
                         "worker-count-invariant")
    ap.add_argument("--fault-straggler-prob", type=float, default=0.1,
                    help="per-task straggler probability (default 0.1)")
    ap.add_argument("--fault-straggler-shape", type=float, default=1.5,
                    help="Pareto tail shape; smaller = heavier (default 1.5)")
    ap.add_argument("--fault-dropout", default="2:0.02:0.05",
                    help="mixed mode dropout window PID:T0[:T1] in seconds "
                         "(omit T1 for a permanent dropout; default "
                         "2:0.02:0.05); 'none' disables it")
    ap.add_argument("--fault-throttle", default="0:0.01:0.03:2.0",
                    help="mixed mode throttle window PID:T0:T1:FACTOR "
                         "(default 0:0.01:0.03:2.0); 'none' disables it")
    ap.add_argument("--pop-size", type=int, default=20, help="GA population")
    ap.add_argument("--max-generations", type=int, default=30)
    ap.add_argument("--min-generations", type=int, default=10)
    ap.add_argument("--bm-evals", type=int, default=120,
                    help="Best Mapping evaluation budget")
    ap.add_argument("--use-batch", action="store_true",
                    help="route α*-search + satisfaction sims through the "
                         "generation-batched engine (identical results; "
                         "see BENCH_simspeed.json for when it pays)")
    ap.add_argument("--batch-workers", type=int, default=1,
                    help="process shards per batched pass (with --use-batch)")
    ap.add_argument("--batch-engine", default="numpy",
                    choices=["numpy", "compiled"],
                    help="batched-pass engine (with --use-batch): 'numpy' "
                         "is bit-exact; 'compiled' runs the event-loop "
                         "kernel on --device (documented float tolerance, "
                         "counted numpy fallback)")
    ap.add_argument("--device", default=None,
                    help="where --batch-engine compiled runs (default: the "
                         "card; 'cpu' runs its plain torch pass)")
    ap.add_argument("--prescreen", action="store_true",
                    help="route GA offspring through the static schedule "
                         "linter (repro_torch.analysis) before simulation and "
                         "skip α* probes below each solution's proven "
                         "infeasibility bound; records per-scenario prune "
                         "stats and a lint summary of the chosen schedule")
    ap.add_argument("--validate-runtime", action="store_true",
                    help="replay each scenario's best Puzzle schedule on the "
                         "virtual-clock PuzzleRuntime and record the "
                         "zero-tolerance trace diff vs the simulator")
    args = ap.parse_args(argv)
    if args.scenarios < 1:
        ap.error("--scenarios must be >= 1")

    def parse_window(text: str, parts: int, what: str):
        if text == "none":
            return None
        try:
            fields = text.split(":")
            if not (parts <= len(fields) <= parts + (1 if what == "dropout"
                                                     else 0)):
                raise ValueError(text)
            pid = int(fields[0])
            times = [float(x) for x in fields[1:]]
        except ValueError:
            ap.error(f"--fault-{what}: cannot parse {text!r}")
        if what == "dropout":
            return (pid, times[0], times[1] if len(times) > 1 else None)
        return (pid, times[0], times[1], times[2])

    specs = generate_scenario_specs(
        args.scenarios, seed=args.seed,
        min_groups=args.min_groups, max_groups=args.max_groups,
        min_models=args.min_models, max_models=args.max_models,
        arrival=args.arrival, arrival_jitter=args.arrival_jitter,
        arrival_distribution=args.arrival_distribution,
        faults=args.faults,
        fault_straggler_prob=args.fault_straggler_prob,
        fault_straggler_shape=args.fault_straggler_shape,
        fault_dropout=parse_window(args.fault_dropout, 2, "dropout"),
        fault_throttle=parse_window(args.fault_throttle, 4, "throttle"),
    )
    config = SweepConfig(
        pop_size=args.pop_size,
        max_generations=args.max_generations,
        min_generations=args.min_generations,
        bm_max_evals=args.bm_evals,
        use_batch=args.use_batch,
        batch_workers=args.batch_workers,
        batch_engine=args.batch_engine,
        validate_runtime=args.validate_runtime,
        prescreen=args.prescreen,
    )
    run_dir = args.run_dir or (
        f"results/sweep_s{args.seed}_n{args.scenarios}"
        + ("" if args.arrival == "periodic" else f"_a{args.arrival}")
        + ("" if args.faults == "none" else f"_f{args.faults}"))

    t0 = time.perf_counter()
    doc = run_sweep(specs, config, run_dir=run_dir, workers=args.workers,
                    force=args.force, log=lambda m: print(m, flush=True),
                    device=args.device)
    doc["meta"] = {
        "seed": args.seed,
        "scenarios": args.scenarios,
        "workers": args.workers,
        "group_bounds": [args.min_groups, args.max_groups],
        "models_per_group_bounds": [args.min_models, args.max_models],
        "arrival": args.arrival,
        "faults": args.faults,
        "wall_s": time.perf_counter() - t0,
    }
    _write_json(args.out, doc)
    print(format_summary(doc))
    print(f"wrote {os.path.abspath(args.out)} "
          f"(per-scenario files in {run_dir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
