"""End-to-end driver on the port: schedule THEN serve multiple real models.

The port of ``examples/serve_multimodel.py``, importing only ``repro_torch``:
  1. the Static Analyzer finds a schedule for two model groups
     (camera group: face+selfie+hand; heavy group: pose+yolo), profiling
     every subgraph it meets by executing it (``TorchExecBackend``: CUDA
     events on the card),
  2. the PuzzleRuntime loads the solution (Coordinator/Workers/Engines,
     tensor pool + shared buffer) on ``--device``,
  3. periodic requests are served and XRBench scores computed from the
     measured makespans.

The networks run at the paper's input resolutions with 8 channels unless
``--spatial``/``--channels`` make them smaller (the reference's reduced
models are ``--channels 4 --spatial 8``).

Usage: PYTHONPATH=src python examples/serve_multimodel_torch.py [--device cpu]
"""
import argparse
import statistics

from repro_torch.core import (
    AnalyzerConfig,
    GAConfig,
    PAPER_COMM_MODEL,
    Profiler,
    StaticAnalyzer,
    TorchExecBackend,
    build_scenario,
    mobile_processors,
)
from repro_torch.core.scoring import group_scores
from repro_torch.device import resolve_device
from repro_torch.runtime import PuzzleRuntime, RuntimeConfig
from repro_torch.zoo import MODEL_SPECS, ExecutableMobileModel

MODELS = ["face_det", "selfie_seg", "hand_det", "pose_det", "yolov8n"]
GROUPS = [["face_det", "selfie_seg", "hand_det"], ["pose_det", "yolov8n"]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--spatial", type=int, default=None,
                    help="default: each network's input resolution in the paper")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # real models; the profiler literally executes subgraphs
    zoo = {n: ExecutableMobileModel(n, channels=args.channels,
                                    spatial=args.spatial or MODEL_SPECS[n]["input"][1],
                                    device=device)
           for n in MODELS}
    graphs = {name: zoo[name].graph for name in MODELS}
    procs = mobile_processors()
    profiler = Profiler(TorchExecBackend(zoo, repeats=2))
    scenario = build_scenario("serve", GROUPS, graphs)
    analyzer = StaticAnalyzer(
        scenario, procs, profiler, PAPER_COMM_MODEL,
        AnalyzerConfig(ga=GAConfig(pop_size=12, max_generations=10,
                                   min_generations=6, seed=1)),
        device=device,
    )
    print(f"device-in-the-loop profiling + GA search on {device} (real executions)...")
    result = analyzer.run_ga()
    best = min(result.pareto, key=lambda s: sum(s.fitness))
    print(f"GA done: {result.evaluations} evaluations, "
          f"{len(result.pareto)} Pareto solutions; profile DB has "
          f"{len(profiler.db)} measured subgraphs")

    rt = PuzzleRuntime(list(scenario.graphs), best, procs, zoo,
                       RuntimeConfig(tensor_pool=True, shared_buffer=True),
                       device=device)
    try:
        periods = [0.05, 0.08]
        states = rt.run_periodic(
            [list(g) for g in scenario.groups], periods, num_requests=8)
        for gid, glist in enumerate(states):
            ms = [s.makespan for s in glist]
            rt_score, qoe = group_scores(ms, periods[gid])
            print(f"group {gid}: mean makespan "
                  f"{statistics.mean(ms) * 1000:.2f} ms  "
                  f"p90 {sorted(ms)[int(0.9 * (len(ms) - 1))] * 1000:.2f} ms  "
                  f"RtScore {rt_score:.3f}  QoE {qoe:.3f}")
        print("runtime stats:", rt.stats())
    finally:
        rt.close()


if __name__ == "__main__":
    main()
