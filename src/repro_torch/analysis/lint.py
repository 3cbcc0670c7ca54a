"""Schedule lint CLI: ``python -m repro_torch.analysis.lint``.

Runs the static analyzer (:mod:`repro_torch.analysis.schedlint`) over concrete
(scenario, schedule) pairs without simulating anything, and prints / writes
the typed ``SL0xx`` findings:

* ``--demo`` — a small built-in two-network scenario with a random and a
  per-processor-pinned schedule (quickstart; no artifacts needed).
* ``--results PATH`` — every scenario of a committed sweep artifact
  (``RESULTS_sweep.json``): rebuilds each scenario from its replayable
  spec and lints the reconstructable schedules (the per-processor GA seed
  solutions and the NPU-Only baseline).
* ``--golden`` — the committed golden-trace scenarios: lints the exact
  (scenario, schedule) pairs behind ``tests/golden/*.json`` at their
  recorded periods. The reference imports its test module for them; the
  port builds them itself (:func:`golden_setup`), so it needs no test
  directory and no ``repro``.

``--alpha A`` additionally evaluates the per-α deadline proofs
(SL030/SL031) at period multiplier ``A``. ``--out PATH`` writes the full
JSON report; ``--strict`` exits nonzero when any error-severity finding
(not warnings) is present — the CI soundness step runs the golden mode
strict, because the committed goldens are known-feasible schedules.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.chromosome import Solution
from ..core.graph import ModelGraph
from .diagnostics import LintReport
from .schedlint import ScheduleLinter

Entry = Tuple[str, str, LintReport]  # (scenario, schedule label, report)


def _demo_entries(alpha: Optional[float]) -> List[Entry]:
    import random

    from ..core.analyzer import AnalyzerConfig, StaticAnalyzer
    from ..core.chromosome import SolutionFactory
    from ..core.comm import PAPER_COMM_MODEL
    from ..core.graph import chain_graph
    from ..core.processors import mobile_processors
    from ..core.profiler import AnalyticMobileBackend, Profiler
    from ..core.scenarios import Scenario

    nets = (
        chain_graph("alpha", [("conv", 4e6, 1000, 4000)] * 4),
        chain_graph("beta", [("fc", 8e6, 2000, 8000)] * 3),
    )
    scenario = Scenario(name="demo", graphs=nets, groups=((0,), (1,)))
    processors = mobile_processors()
    analyzer = StaticAnalyzer(
        scenario, processors, Profiler(AnalyticMobileBackend(processors)),
        PAPER_COMM_MODEL, AnalyzerConfig(),
    )
    linter = analyzer.linter()
    factory = SolutionFactory(
        nets, num_processors=len(processors), rng=random.Random(0))
    entries: List[Entry] = [
        ("demo", "random", linter.lint(factory.random_solution(), alpha=alpha)),
    ]
    for proc in processors:
        entries.append((
            "demo", f"seed_{proc.name.lower()}",
            linter.lint(analyzer.factory.seeded_solution(proc.pid),
                        alpha=alpha),
        ))
    return entries


def _results_entries(
    path: str, alpha: Optional[float], max_scenarios: Optional[int]
) -> List[Entry]:
    from ..core.analyzer import AnalyzerConfig, StaticAnalyzer
    from ..core.scenarios import build_scenario
    from ..experiments.evaluate import default_context
    from ..experiments.specs import ScenarioSpec

    with open(path) as fh:
        doc = json.load(fh)
    records = doc["scenarios"] if isinstance(doc, dict) else doc
    if max_scenarios is not None:
        records = records[:max_scenarios]
    ctx = default_context()
    entries: List[Entry] = []
    for record in records:
        spec = ScenarioSpec.from_json(record["spec"])
        scenario = build_scenario(
            spec.name, [list(g) for g in spec.groups], ctx.graphs,
            arrival=spec.arrival, faults=spec.faults,
        )
        analyzer = StaticAnalyzer(
            scenario, ctx.processors, ctx.profiler, ctx.comm_model,
            AnalyzerConfig(),
        )
        linter = analyzer.linter()
        schedules: Dict[str, Solution] = {
            f"seed_pid{p.pid}": analyzer.factory.seeded_solution(p.pid)
            for p in ctx.processors
        }
        schedules["npu_only"] = analyzer.npu_only()
        for label, sol in schedules.items():
            entries.append((spec.name, label, linter.lint(sol, alpha=alpha)))
    return entries


#: The six golden traces of ``tests/golden/``, in the reference's order.
GOLDENS = ("tri_chain_clean", "diamond_mix_measured", "diamond_mix_overload",
           "runtime_conformance", "poisson_burst_measured", "fault_dropout_mix")


def _golden_nets(kind: str) -> List[ModelGraph]:
    from ..core.graph import branching_graph, chain_graph

    if kind == "tri_chain":
        return [
            chain_graph("alpha", [("conv", 4e6, 1000, 4000)] * 4),
            chain_graph("beta", [("fc", 8e6, 2000, 8000)] * 3),
            chain_graph("gamma", [("dw", 1.5e6, 600, 1800)] * 5),
        ]
    if kind == "diamond_mix":
        return [
            chain_graph("a", [("conv", 4e6, 1000, 4000)] * 5),
            branching_graph("b", [("conv", 2e6, 800, 2000)] * 4,
                            [(0, 1), (0, 2), (1, 3), (2, 3)]),
            chain_graph("c", [("fc", 8e6, 2000, 8000)] * 3),
            branching_graph("d", [("conv", 3e6, 500, 1500)] * 5,
                            [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4)]),
        ]
    return [
        chain_graph("p", [("conv", 3e6, 900, 3000)] * 7),
        branching_graph("q", [("conv", 2.5e6, 700, 2200)] * 8,
                        [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (4, 5),
                         (3, 6), (5, 7), (6, 7)]),
        chain_graph("r", [("fc", 6e6, 1500, 6000)] * 5),
    ]


def golden_setup(name: str) -> Tuple:
    """One golden trace's setup: ``(nets, groups, periods, num_requests,
    noise seed, dispatch overhead, pin, arrivals, faults)``, built from the
    recipe of ``tests/test_golden_traces.py``."""
    from ..core.arrivals import ArrivalSpec
    from ..core.faults import FaultSpec

    return {
        "tri_chain_clean": (
            _golden_nets("tri_chain"), [[0, 1, 2]], [0.005], 8, None, 0.0,
            None, None, None),
        "diamond_mix_measured": (
            _golden_nets("diamond_mix"), [[0, 1], [2, 3]], [0.004, 0.006], 6,
            7, 150e-6, None, None, None),
        "diamond_mix_overload": (
            _golden_nets("diamond_mix"), [[0, 1], [2, 3]], [2e-6, 2e-6], 30,
            None, 0.0, 0, None, None),
        "runtime_conformance": (
            _golden_nets("conformance"), [[0, 2], [1]], [0.035, 0.05], 8, 3,
            150e-6, None, None, None),
        "poisson_burst_measured": (
            _golden_nets("diamond_mix"), [[0, 1], [2, 3]], [0.004, 0.006], 8,
            5, 150e-6, None, ArrivalSpec(kind="poisson", seed=42), None),
        "fault_dropout_mix": (
            _golden_nets("diamond_mix"), [[0, 1], [2, 3]], [0.004, 0.006], 8,
            7, 150e-6, None, None,
            FaultSpec(
                dropouts=((2, 0.012, None),),
                throttles=((0, 0.002, 0.008, 3.0),),
                straggler_prob=0.2, straggler_shape=1.5, seed=13,
            )),
    }[name]


def golden_solution(nets: Sequence[ModelGraph], pin: Optional[int] = None,
                    seed: int = 11) -> Solution:
    """The golden traces' schedule: a random solution from ``seed`` on the
    mobile processors; with ``pin``, every layer cut apart and mapped to that
    processor (maximal queueing)."""
    import random

    from ..core.chromosome import SolutionFactory
    from ..core.processors import mobile_processors

    fac = SolutionFactory(nets, num_processors=len(mobile_processors()),
                          rng=random.Random(seed), cut_prob=0.35)
    sol = fac.random_solution()
    if pin is not None:
        sol.partition = [[1] * g.num_edges for g in nets]
        sol.mapping = [[pin] * g.num_layers for g in nets]
    return sol


def _golden_entries(alpha: Optional[float]) -> List[Entry]:
    from ..core.comm import PAPER_COMM_MODEL
    from ..core.processors import mobile_processors
    from ..core.profiler import AnalyticMobileBackend, Profiler
    from ..core.simulator import NoiseModel

    procs = mobile_processors()
    profiler = Profiler(AnalyticMobileBackend(procs))
    entries: List[Entry] = []
    for name in GOLDENS:
        (nets, groups, periods, num_requests, noise_seed, _dispatch,
         pin, arrivals, faults) = golden_setup(name)
        sol = golden_solution(nets, pin=pin)
        linter = ScheduleLinter(
            graphs=nets, groups=groups, processors=procs,
            profiler=profiler, comm_model=PAPER_COMM_MODEL,
            base_periods=periods,
            noise=(NoiseModel(seed=noise_seed)
                   if noise_seed is not None else None),
            faults=faults, arrival=arrivals,
            score_requests=num_requests,
            noise_seed=noise_seed if noise_seed is not None else 0,
        )
        entries.append((name, "golden", linter.lint(sol, alpha=alpha)))
    return entries


def _print_entries(entries: Iterable[Entry], verbose: bool) -> int:
    errors = 0
    for scenario, label, rep in entries:
        counts = rep.counts()
        flag = "INFEASIBLE" if rep.infeasible else (
            "errors" if rep.errors() else "clean")
        lb = (f" alpha_lb={rep.alpha_lower_bound:.4g}"
              if rep.alpha_lower_bound > 0.0 else "")
        print(f"{scenario}/{label}: {flag} {counts or '{}'}{lb}")
        errors += len(rep.errors())
        if verbose:
            for d in rep.findings:
                proof = " [proof]" if d.proof else ""
                print(f"  {d.code} {d.severity}{proof}: {d.message}")
    return errors


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Static feasibility lint over decoded schedules "
                    "(zero simulation).",
    )
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--demo", action="store_true",
                        help="lint a small built-in demo scenario")
    source.add_argument("--results", metavar="PATH",
                        help="lint every scenario of a sweep artifact "
                             "(RESULTS_sweep.json)")
    source.add_argument("--golden", action="store_true",
                        help="lint the committed golden-trace schedules")
    parser.add_argument("--alpha", type=float, default=None,
                        help="also run the SL030/SL031 deadline proofs at "
                             "this period multiplier")
    parser.add_argument("--max-scenarios", type=int, default=None,
                        help="limit --results to the first N scenarios")
    parser.add_argument("--out", metavar="PATH",
                        help="write the full JSON report here")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 when any error-severity finding exists")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="print every finding, not just per-schedule "
                             "counts")
    args = parser.parse_args(argv)

    if args.demo:
        entries = _demo_entries(args.alpha)
        mode = "demo"
    elif args.results:
        entries = _results_entries(args.results, args.alpha,
                                   args.max_scenarios)
        mode = "results"
    else:
        entries = _golden_entries(args.alpha)
        mode = "golden"

    errors = _print_entries(entries, args.verbose)
    total = sum(len(rep.findings) for _, _, rep in entries)
    print(f"linted {len(entries)} schedules: {total} findings, "
          f"{errors} errors")

    if args.out:
        doc = {
            "mode": mode,
            "alpha": args.alpha,
            "schedules": [
                {"scenario": scenario, "schedule": label,
                 "report": rep.to_json()}
                for scenario, label, rep in entries
            ],
            "total_findings": total,
            "total_errors": errors,
        }
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        print(f"wrote {args.out}")

    return 1 if (args.strict and errors) else 0


if __name__ == "__main__":
    sys.exit(main())
