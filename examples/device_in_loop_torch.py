"""Device-in-the-loop evaluation on the port: conformance + measured-cost feedback.

The port of ``examples/device_in_loop.py``, importing only ``repro_torch``:

  1. **virtual-clock conformance** — the best GA schedule executes on the
     ``PuzzleRuntime`` Coordinator/Worker code driven by a virtual clock,
     and its task trace must match the ``FastSimulator`` prediction bit for
     bit (zero max-abs diff on release/start/finish times; asserted);
  2. **measured-cost feedback** — the schedule then runs for real on
     ``--device`` (``TorchExecBackend``-profiled executable models), the
     per-subgraph timings are written back into the ``ProfileDB``, the
     analyzer's caches are invalidated, and the GA's Pareto front is
     re-ranked on the measured costs;
  3. **in-search feedback** — a second GA run with
     ``GAConfig.device_in_loop_interval`` performs the same measurement
     rounds during the search (the paper's §4.2 loop).

Writes the conformance trace diff to ``results/conformance_trace_torch.json``
under the working directory (the port's own file beside the reference's).
The networks run at the paper's input resolutions with 8 channels unless
``--spatial``/``--channels`` make them smaller (the reference's reduced
models are ``--channels 4 --spatial 8``).

Usage: PYTHONPATH=src python examples/device_in_loop_torch.py [--device cpu]
"""
import argparse
import json
import os

from repro_torch.core import (
    AnalyzerConfig,
    GAConfig,
    PAPER_COMM_MODEL,
    Profiler,
    StaticAnalyzer,
    TorchExecBackend,
    mobile_processors,
)
from repro_torch.core.scenarios import Scenario
from repro_torch.device import resolve_device
from repro_torch.zoo import MODEL_SPECS, ExecutableMobileModel

NETWORKS = ("face_det", "selfie_seg")
TRACE = os.path.join("results", "conformance_trace_torch.json")


def build_analyzer(zoo, procs, ga: GAConfig, device) -> StaticAnalyzer:
    graphs = [zoo[n].graph for n in NETWORKS]
    profiler = Profiler(TorchExecBackend(
        zoo, repeats=3,
        # heterogeneity emulation on one device: the device measures one
        # processor; relative per-processor speed factors split it into
        # CPU/GPU/NPU-like profiles
        speed_scale={p.pid: 1.0 + 0.6 * p.pid for p in procs},
    ))
    scenario = Scenario(name="device_in_loop", graphs=graphs, groups=[[0, 1]])
    return StaticAnalyzer(
        scenario, procs, profiler, PAPER_COMM_MODEL,
        AnalyzerConfig(ga=ga), executables=zoo, device=device,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--spatial", type=int, default=None,
                    help="default: each network's input resolution in the paper")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    zoo = {n: ExecutableMobileModel(n, channels=args.channels,
                                    spatial=args.spatial or MODEL_SPECS[n]["input"][1],
                                    device=device)
           for n in NETWORKS}
    procs = mobile_processors()
    analyzer = build_analyzer(
        zoo, procs, GAConfig(pop_size=8, max_generations=6,
                             min_generations=2, seed=0), device)
    print(f"base period: {analyzer.base_periods[0] * 1000:.2f} ms")

    result = analyzer.run_ga()
    best = min(result.pareto, key=lambda s: sum(s.fitness))
    print(f"GA: {result.generations} generations, "
          f"{len(result.pareto)} Pareto solutions")

    # 1 -- virtual-clock conformance: runtime trace == simulator trace
    report = analyzer.validate_on_runtime(
        best, alpha=1.0, num_requests=8, measured=True, seed=0)
    trace_diff = max(report.max_release_diff, report.max_start_diff,
                     report.max_finish_diff, report.max_makespan_diff)
    print(f"\nvirtual conformance: passed={report.passed} "
          f"tasks={report.runtime_tasks}/{report.sim_tasks} "
          f"max|Δrelease|={report.max_release_diff} "
          f"max|Δstart|={report.max_start_diff} "
          f"max|Δfinish|={report.max_finish_diff}")
    assert report.passed and trace_diff == 0.0, \
        "virtual-clock runtime diverged from the simulator"
    os.makedirs("results", exist_ok=True)
    with open(TRACE, "w") as f:
        json.dump(report.to_json(), f, indent=1)
    print(f"wrote {TRACE}")

    # 2 -- measured-cost feedback: real execution -> ProfileDB -> re-rank.
    # Candidate set = GA front + the Best Mapping archive, so the re-ranking
    # has real competition to reorder.
    candidates = list(result.pareto) + analyzer.best_mapping(max_evals=40)
    objs_before = [analyzer.objectives(s, num_requests=12, measured=True)
                   for s in candidates]
    order_before = sorted(range(len(candidates)),
                          key=lambda i: sum(objs_before[i]))
    db = analyzer.profiler.db
    before_updates = db.measured_updates
    measurements = analyzer.measure_on_runtime(best, num_requests=4, alpha=2.0)
    changed = analyzer.apply_measured_costs(measurements)
    print(f"\nmeasured {len(measurements)} subgraph timings on the runtime "
          f"({device}); {changed} ProfileDB entries updated "
          f"(db.measured_updates {before_updates} -> {db.measured_updates})")
    assert changed > 0, "device-in-the-loop run updated no ProfileDB entry"

    front = analyzer.rerank_pareto(candidates, num_requests=12)
    objs_after = [s.fitness for s in candidates]
    order_after = sorted(range(len(candidates)),
                         key=lambda i: sum(objs_after[i]))
    moved = sum(1 for a, b in zip(objs_before, objs_after) if a != b)
    print(f"re-ranked {len(candidates)} candidates on measured costs: "
          f"{moved} objective vectors changed, new first front has "
          f"{len(front)} members, ordering changed: "
          f"{order_before != order_after}")
    assert moved > 0, "measured costs changed no objective"

    # 3 -- the same loop inside the search (paper §4.2)
    analyzer2 = build_analyzer(
        zoo, procs, GAConfig(pop_size=6, max_generations=4, min_generations=2,
                             patience=4, seed=1, device_in_loop_interval=2), device)
    result2 = analyzer2.run_ga()
    rounds = ", ".join(f"gen {g}: {n} entries" for g, n in
                       result2.device_updates)
    print(f"\nGA with device_in_loop_interval=2: measurement rounds "
          f"updated the ProfileDB at [{rounds}]")
    assert result2.device_updates, "no in-search device measurement round ran"

    # real-execution conformance is informational: the simulator predicts
    # from (now measured) costs, the runtime re-executes
    rep_real = analyzer.validate_on_runtime(
        best, alpha=2.0, num_requests=4, mode="real", rel_tol=2.0)
    print(f"\nreal-exec conformance on {device}: makespan rel err "
          f"{rep_real.max_makespan_rel_err:.2f} "
          f"(tasks {rep_real.runtime_tasks}/{rep_real.sim_tasks})")
    return {"trace_diff": trace_diff, "tasks": report.runtime_tasks,
            "profile_updates": changed, "moved": moved,
            "in_search_rounds": len(result2.device_updates),
            "real_makespan_rel_err": rep_real.max_makespan_rel_err}


if __name__ == "__main__":
    main()
