"""Single-scenario evaluation: the one entry point the sweep harness drives.

``evaluate_scenario(spec, config, context)`` runs the full pipeline the
paper applies to every randomly generated scenario:

1. materialize the scenario's model graphs and derive base periods (§6.1),
2. GA search on the fast evaluation engine (Puzzle),
3. the NPU Only and Best Mapping baselines (§6.1),
4. bisection α*-search (saturation multiplier, §6.2) for all three,
5. deadline-satisfaction rate at the base period (α = 1.0) for all three.

All times are **seconds**. Every stochastic stage is explicitly seeded: the
GA stream, the baseline's neighbor shuffle, and the satisfaction-rate noise
stream all derive from ``spec.seed``; the request *arrival* stream (when
``spec.arrival`` selects a non-periodic process) carries its own SHA-256
per-scenario seed inside the spec; and the measured-noise stream inside
the α*-search uses the analyzer's fixed default (identical across
scenarios). Either way a scenario's result is a pure function of ``(spec,
config)`` — the property the multi-process sweep relies on for
worker-count-independent output.

Deadlines are per-request: request *i* must finish by ``arrival_i + Φ``
with Φ the group's α-scaled base period — equivalent to checking the
arrival-relative makespan against Φ, which is what the scoring layer does,
so the same code is correct for periodic and bursty traffic alike.

Port of ``repro.experiments.evaluate``, verbatim in what it computes. The
device the compiled batch engine runs on goes beside the config, in
:class:`EvalContext` (``None`` = the card); only the compiled batch tier
resolves it, so the scalar and numpy paths need no card.
"""
from __future__ import annotations

import math
import time
from dataclasses import asdict, dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Union

from ..core import (
    AnalyzerConfig,
    GAConfig,
    PAPER_COMM_MODEL,
    Profiler,
    Solution,
    StaticAnalyzer,
    TableBackend,
    build_scenario,
    deadline_satisfaction,
    mobile_processors,
    percentile,
)
from ..core.profiler import AnalyticMobileBackend
from ..zoo import all_cost_graphs, paper_profile_tables
from .specs import ScenarioSpec

if TYPE_CHECKING:
    import torch

#: Method keys used throughout results, in reporting order.
METHODS = ("puzzle", "best_mapping", "npu_only")


@dataclass(frozen=True)
class SweepConfig:
    """Knobs for one sweep run (picklable; shipped to pool workers).

    GA sizing defaults match the repo's benchmark protocol (pop 20 × ≤30
    generations). ``alpha_cap`` bounds unsaturated α* (``inf``) when forming
    ratios, mirroring the capped mean in ``benchmarks/run.py``.
    ``satisfaction_alpha`` is the period multiplier at which the
    deadline-satisfaction rate is measured (1.0 = the §6.1 base period).
    """

    pop_size: int = 20
    max_generations: int = 30
    min_generations: int = 10
    bm_max_evals: int = 120
    engine: str = "fast"
    saturation_mode: str = "bisect"
    alpha_cap: float = 6.0
    satisfaction_alpha: float = 1.0
    satisfaction_requests: int = 36
    # Route the α*-searches and satisfaction sims through the
    # generation-batched engine (repro_torch.core.batchsim): every bisection round
    # evaluates the whole candidate population as one lock-step batch, and
    # the three satisfaction sims share a batch. Per-scenario results are
    # bit-identical either way (tests assert it); on CPU the per-solution
    # loop is currently faster at typical candidate-set widths, so the
    # default stays off — see BENCH_simspeed.json's batch section.
    use_batch: bool = False
    batch_workers: int = 1
    # Batched-engine selection: "numpy" (bit-exact lock-step) or "compiled"
    # (the event-loop kernel on EvalContext.device; documented float
    # tolerance, falls back to numpy when the workload is unsupported). See
    # repro_torch.core.batchsim_compiled.
    batch_engine: str = "numpy"
    # Device-in-the-loop conformance: after picking Puzzle's best schedule,
    # execute it on the virtual-clock PuzzleRuntime and diff the task trace
    # against the simulator at zero tolerance; the scalar diff summary lands
    # in ``ScenarioResult.runtime_conformance``. Adds one runtime replay per
    # scenario (~ms); results are otherwise unchanged.
    validate_runtime: bool = False
    # Static pre-screening (repro_torch.analysis): route GA offspring through the
    # schedule linter before simulation (proven-infeasible chromosomes get
    # worst-rank fitness without simulating) and let the α*-searches skip
    # probes below each solution's proven infeasibility bound. Sound-only:
    # results can differ from a non-prescreened run only by excluding
    # chromosomes the linter *proves* can never score feasible. Also records
    # per-scenario ``prescreen_stats`` and a lint summary of Puzzle's chosen
    # schedule in the results.
    prescreen: bool = False

    def to_json(self) -> Dict[str, object]:
        return asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "SweepConfig":
        return cls(**d)


class EvalContext:
    """Shared immutable problem context: graphs, processors, profiler, comm.

    Built once per process (per sweep worker) and reused across scenarios —
    the profiler's ProfileDB cache and the cost-graph zoo then amortize
    across every scenario the worker evaluates. Sharing is safe because the
    profiler is deterministic per profile key: cache state affects speed,
    never values. ``device`` is where the compiled batch engine runs
    (``None`` = the card).
    """

    def __init__(self, device: Optional[Union[str, "torch.device"]] = None) -> None:
        self.device = device
        self.graphs = all_cost_graphs()
        self.processors = mobile_processors()
        self.profiler = Profiler(TableBackend(
            processors=self.processors,
            tables=paper_profile_tables(),
            fallback=AnalyticMobileBackend(self.processors),
        ))
        self.comm_model = PAPER_COMM_MODEL


_DEFAULT_CONTEXTS: Dict[str, EvalContext] = {}


def default_context(
    device: Optional[Union[str, "torch.device"]] = None,
) -> EvalContext:
    """Process-wide :class:`EvalContext` for ``device`` (lazy, one each)."""
    key = str(device)
    if key not in _DEFAULT_CONTEXTS:
        _DEFAULT_CONTEXTS[key] = EvalContext(device)
    return _DEFAULT_CONTEXTS[key]


@dataclass
class ScenarioResult:
    """Everything the sweep records for one scenario.

    ``alpha_star`` maps method → saturation multiplier under the paper's
    §6.2 convention (the **median** over the method's candidate set: GA
    Pareto front, Best Mapping archive, or the single NPU Only solution);
    ``alpha_star_best`` is the **minimum** over the same set — what the
    method achieves if the deployer picks its single best schedule. Both may
    be ``inf`` when the score never saturates up to the search ceiling
    (serialized as JSON ``null``). ``ratios`` maps baseline →
    ``α*_baseline / α*_puzzle`` (median convention) with
    both sides capped at ``alpha_cap`` first — the per-scenario frequency
    gain (higher = Puzzle sustains proportionally shorter periods).
    ``satisfaction`` maps method → pooled fraction of requests meeting their
    deadline at ``satisfaction_alpha``. ``base_periods_s`` is φ̄ per group in
    seconds. ``wall_s`` is the scenario's evaluation wall-clock in seconds.
    """

    spec: ScenarioSpec
    base_periods_s: List[float]
    alpha_star: Dict[str, float]
    alpha_star_best: Dict[str, float]
    ratios: Dict[str, float]
    satisfaction: Dict[str, float]
    ga_generations: int
    ga_evaluations: int
    pareto_size: int
    wall_s: float
    # scalar summary of the runtime↔simulator conformance check (only when
    # SweepConfig.validate_runtime; see ConformanceReport.summary())
    runtime_conformance: Optional[Dict[str, object]] = None
    # GA pre-screen counters {checked, pruned, simulations_avoided} and the
    # lint summary of Puzzle's chosen schedule (only when
    # SweepConfig.prescreen; see repro_torch.analysis)
    prescreen_stats: Optional[Dict[str, int]] = None
    lint: Optional[Dict[str, object]] = None

    def __post_init__(self) -> None:
        # NaN has no JSON representation and poisons every downstream
        # aggregate (min/percentile/geomean all propagate it silently), so
        # reject it at construction instead of serializing garbage.
        nan_fields = [
            f"{name}[{k}]"
            for name, mapping in (("alpha_star", self.alpha_star),
                                  ("alpha_star_best", self.alpha_star_best),
                                  ("ratios", self.ratios),
                                  ("satisfaction", self.satisfaction))
            for k, v in mapping.items() if math.isnan(v)
        ] + [f"base_periods_s[{i}]" for i, v in enumerate(self.base_periods_s)
             if math.isnan(v)]
        if nan_fields:
            raise ValueError(
                f"NaN in ScenarioResult({self.spec.name}): "
                + ", ".join(nan_fields))

    def to_json(self) -> Dict[str, object]:
        return {
            "spec": self.spec.to_json(),
            "base_periods_s": list(self.base_periods_s),
            "alpha_star": {
                k: (None if math.isinf(v) else v)
                for k, v in self.alpha_star.items()
            },
            "alpha_star_best": {
                k: (None if math.isinf(v) else v)
                for k, v in self.alpha_star_best.items()
            },
            "ratios": dict(self.ratios),
            "satisfaction": dict(self.satisfaction),
            "ga_generations": self.ga_generations,
            "ga_evaluations": self.ga_evaluations,
            "pareto_size": self.pareto_size,
            "wall_s": self.wall_s,
            **({"runtime_conformance": dict(self.runtime_conformance)}
               if self.runtime_conformance is not None else {}),
            **({"prescreen_stats": dict(self.prescreen_stats)}
               if self.prescreen_stats is not None else {}),
            **({"lint": dict(self.lint)} if self.lint is not None else {}),
        }

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "ScenarioResult":
        return cls(
            spec=ScenarioSpec.from_json(d["spec"]),
            base_periods_s=[float(x) for x in d["base_periods_s"]],
            alpha_star={
                k: (float("inf") if v is None else float(v))
                for k, v in d["alpha_star"].items()
            },
            alpha_star_best={
                k: (float("inf") if v is None else float(v))
                for k, v in d["alpha_star_best"].items()
            },
            ratios={k: float(v) for k, v in d["ratios"].items()},
            satisfaction={k: float(v) for k, v in d["satisfaction"].items()},
            ga_generations=int(d["ga_generations"]),
            ga_evaluations=int(d["ga_evaluations"]),
            pareto_size=int(d["pareto_size"]),
            wall_s=float(d["wall_s"]),
            runtime_conformance=d.get("runtime_conformance"),
            prescreen_stats=d.get("prescreen_stats"),
            lint=d.get("lint"),
        )


def capped_ratio(baseline: float, puzzle: float, cap: float) -> float:
    """``min(baseline, cap) / min(puzzle, cap)``, the per-scenario frequency
    gain; 1.0 when both sides are unsaturated (both capped)."""
    return min(baseline, cap) / min(puzzle, cap)


def evaluate_scenario(
    spec: ScenarioSpec,
    config: Optional[SweepConfig] = None,
    context: Optional[EvalContext] = None,
) -> ScenarioResult:
    """Run the full per-scenario pipeline; see the module docstring.

    Puzzle's α* is the **median** over its Pareto front (paper §6.2); the
    baselines' α* are the median over the Best Mapping archive and the
    single NPU Only solution respectively. Satisfaction rates are measured
    on each method's best (lowest-α*) solution under the measured (noisy)
    simulator, with the noise stream seeded from ``spec.seed``.
    """
    config = config or SweepConfig()
    context = context or default_context()
    t0 = time.perf_counter()

    # a spec carrying faults threads its ensemble into every evaluation
    # path below (GA, α*-search, satisfaction) via the analyzer — the
    # robustness objective: the GA optimizes under the faulted simulator
    scenario = build_scenario(spec.name, [list(g) for g in spec.groups],
                              context.graphs, arrival=spec.arrival,
                              faults=spec.faults)
    analyzer = StaticAnalyzer(
        scenario, context.processors, context.profiler, context.comm_model,
        AnalyzerConfig(
            engine=config.engine,
            saturation_mode=config.saturation_mode,
            batch_workers=config.batch_workers,
            batch_engine=config.batch_engine,
            prescreen=config.prescreen,
            ga=GAConfig(
                pop_size=config.pop_size,
                max_generations=config.max_generations,
                min_generations=config.min_generations,
                seed=spec.seed,
                prescreen=config.prescreen,
            ),
        ),
        device=context.device,
    )

    try:
        return _evaluate_with(analyzer, scenario, spec, config, context, t0)
    finally:
        analyzer.close()  # batch process pool, if one was spun up


def _evaluate_with(
    analyzer: StaticAnalyzer,
    scenario,
    spec: ScenarioSpec,
    config: SweepConfig,
    context: EvalContext,
    t0: float,
) -> ScenarioResult:
    # The Best Mapping archive doubles as GA seed material (Puzzle's search
    # space strictly contains the mapping-only space), so run the hillclimb
    # once and share it between the baseline and the GA's seed population.
    bm_solutions = analyzer.best_mapping(
        max_evals=config.bm_max_evals, seed=spec.seed)
    ga_seeds = [analyzer.factory.seeded_solution(p.pid)
                for p in context.processors]
    ga = analyzer.run_ga(seeds=ga_seeds + bm_solutions)
    candidates: Dict[str, List[Solution]] = {
        "puzzle": list(ga.pareto),
        "best_mapping": bm_solutions,
        "npu_only": [analyzer.npu_only()],
    }

    alpha_star: Dict[str, float] = {}
    alpha_star_best: Dict[str, float] = {}
    best_solution: Dict[str, Solution] = {}
    if config.use_batch:
        # one batched bisection over the whole candidate population (all
        # methods at once): every round's α probes run as one lock-step pass
        flat = [(m, s) for m in METHODS for s in candidates[m]]
        sat_results = analyzer.population_saturation([s for _, s in flat])
        per_method: Dict[str, List[float]] = {m: [] for m in METHODS}
        for (method, _), sat in zip(flat, sat_results):
            per_method[method].append(sat.alpha_star)
        for method, sats in per_method.items():
            alpha_star[method] = percentile(sats, 50.0)
            alpha_star_best[method] = min(sats)
            best_solution[method] = candidates[method][sats.index(min(sats))]
    else:
        for method, sols in candidates.items():
            sats = [analyzer.saturation(s).alpha_star for s in sols]
            alpha_star[method] = percentile(sats, 50.0)
            alpha_star_best[method] = min(sats)
            best_solution[method] = sols[sats.index(min(sats))]

    satisfaction: Dict[str, float] = {}
    deadlines = [config.satisfaction_alpha * p for p in analyzer.base_periods]
    methods_order = list(best_solution)
    if config.use_batch:
        batch = analyzer.simulate_batch(
            [(best_solution[m], config.satisfaction_alpha)
             for m in methods_order],
            config.satisfaction_requests, measured=True, seed=spec.seed,
        )
        for ix, method in enumerate(methods_order):
            per_group = [batch.makespans(ix, g)
                         for g in range(scenario.num_groups)]
            satisfaction[method] = deadline_satisfaction(per_group, deadlines)
    else:
        for method, sol in best_solution.items():
            res = analyzer.simulate(
                sol, config.satisfaction_alpha, config.satisfaction_requests,
                measured=True, seed=spec.seed, collect_tasks=False,
            )
            per_group = [[] for _ in range(scenario.num_groups)]
            for r in res.requests:
                per_group[r.group].append(r.makespan)
            satisfaction[method] = deadline_satisfaction(per_group, deadlines)

    ratios = {
        m: capped_ratio(alpha_star[m], alpha_star["puzzle"], config.alpha_cap)
        for m in ("npu_only", "best_mapping")
    }

    conformance = None
    if config.validate_runtime:
        # execute Puzzle's chosen schedule on the virtual-clock runtime under
        # the same measured conditions as the satisfaction check; the diff
        # against the simulator must be exact (report.passed)
        report = analyzer.validate_on_runtime(
            best_solution["puzzle"], alpha=config.satisfaction_alpha,
            num_requests=config.satisfaction_requests, measured=True,
            seed=spec.seed,
        )
        conformance = report.summary()

    prescreen_stats = None
    lint_summary = None
    if config.prescreen:
        prescreen_stats = dict(ga.prescreen_stats)
        # lint the deployed schedule at the satisfaction α: findings and the
        # proven α lower bound land next to the α* it constrains from below
        report = analyzer.lint(best_solution["puzzle"],
                               alpha=config.satisfaction_alpha)
        lint_summary = {
            "counts": report.counts(),
            "errors": len(report.errors()),
            "warnings": len(report.warnings()),
            "infeasible": report.infeasible,
            "alpha_lower_bound": report.alpha_lower_bound,
        }

    return ScenarioResult(
        spec=spec,
        base_periods_s=list(analyzer.base_periods),
        alpha_star=alpha_star,
        alpha_star_best=alpha_star_best,
        ratios=ratios,
        satisfaction=satisfaction,
        ga_generations=ga.generations,
        ga_evaluations=ga.evaluations,
        pareto_size=len(ga.pareto),
        wall_s=time.perf_counter() - t0,
        runtime_conformance=conformance,
        prescreen_stats=prescreen_stats,
        lint=lint_summary,
    )
