"""Quickstart on the port: schedule six DL models across heterogeneous processors.

The port of ``examples/quickstart.py``, importing only ``repro_torch``:
  1. build model graphs (paper zoo) + the paper-calibrated profiler,
  2. run the GA Static Analyzer,
  3. compare the Pareto solution against the NPU-Only / Best-Mapping
     baselines via the XRBench saturation multiplier.

The scheduler runs on the host; the analyzer is bound to ``--device`` (the
card unless ``--device cpu``), where its compiled batch engine and its
device-in-the-loop rounds would run.

Usage: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core import (
    AnalyticMobileBackend,
    AnalyzerConfig,
    GAConfig,
    PAPER_COMM_MODEL,
    Profiler,
    StaticAnalyzer,
    TableBackend,
    build_scenario,
    decode_solution,
    mobile_processors,
)
from repro_torch.device import resolve_device
from repro_torch.zoo import all_cost_graphs, paper_profile_tables


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    graphs = all_cost_graphs()
    procs = mobile_processors()
    profiler = Profiler(TableBackend(
        processors=procs, tables=paper_profile_tables(),
        fallback=AnalyticMobileBackend(procs),
    ))
    scenario = build_scenario(
        "quickstart",
        [["face_det", "selfie_seg", "yolov8n", "fast_scnn", "pose_det",
          "hand_det"]],
        graphs,
    )
    analyzer = StaticAnalyzer(
        scenario, procs, profiler, PAPER_COMM_MODEL,
        AnalyzerConfig(ga=GAConfig(pop_size=20, max_generations=24, seed=0)),
        device=device,
    )
    print(f"base period: {analyzer.base_periods[0] * 1000:.2f} ms")

    result = analyzer.run_ga()
    print(f"GA: {result.generations} generations, {result.evaluations} "
          f"evaluations, {len(result.pareto)} Pareto solutions")

    best = min(result.pareto, key=lambda s: s.fitness[0])
    placed = decode_solution(best, scenario.graphs)
    for net, plist in enumerate(placed):
        desc = ", ".join(
            f"sg{p.subgraph.sg_index}->{procs[p.processor].name}"
            f"/{p.dtype}/{p.backend}" for p in plist
        )
        print(f"  {scenario.graphs[net].name:12s}: {desc}")

    pz = analyzer.median_saturation(result.pareto)
    npu = analyzer.saturation(analyzer.npu_only()).alpha_star
    bm = analyzer.median_saturation(analyzer.best_mapping(max_evals=100))
    print("\nsaturation multiplier α* (lower = sustains higher load):")
    print(f"  Puzzle       : {pz}")
    print(f"  Best Mapping : {bm}")
    print(f"  NPU Only     : {npu}")
    print(f"  -> Puzzle sustains {npu / pz:.2f}x the request frequency of "
          f"NPU Only (paper: 3.7x multi-group avg / 2.0x single)")


if __name__ == "__main__":
    main()
