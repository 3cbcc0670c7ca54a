"""Experiment harnesses: the paper's randomized evaluation, reproducible.

The sweep harness turns the repo's single-scenario pipeline into the
paper's §6 protocol — many randomly generated scenarios, three methods
each, aggregated into the headline frequency-gain numbers::

    python -m repro_torch.experiments.sweep --scenarios 30 --seed 0 --workers 4

Layers (each importable on its own):

* :mod:`.specs`     — :class:`ScenarioSpec` + the §6.1 random generator
* :mod:`.evaluate`  — :func:`evaluate_scenario`, the one per-scenario entry
  point (GA + baselines + α*-search + satisfaction)
* :mod:`.aggregate` — headline-metric reduction (geo-mean α* ratios, …)
* :mod:`.sweep`     — process-pool fan-out, resumable run dir, CLI
"""
from .aggregate import aggregate_results, geometric_mean
from .evaluate import (
    METHODS,
    EvalContext,
    ScenarioResult,
    SweepConfig,
    default_context,
    evaluate_scenario,
)
from .specs import (
    ScenarioSpec,
    arrival_stream_seed,
    fault_stream_seed,
    generate_scenario_specs,
    scenario_stream_seed,
)

__all__ = [
    "METHODS",
    "EvalContext",
    "ScenarioResult",
    "ScenarioSpec",
    "SweepConfig",
    "aggregate_results",
    "arrival_stream_seed",
    "default_context",
    "evaluate_scenario",
    "fault_stream_seed",
    "format_summary",
    "generate_scenario_specs",
    "geometric_mean",
    "run_sweep",
    "scenario_stream_seed",
]


def __getattr__(name):
    # .sweep is imported lazily so ``python -m repro_torch.experiments.sweep``
    # doesn't trip runpy's found-in-sys.modules RuntimeWarning.
    if name in ("run_sweep", "format_summary"):
        from . import sweep as _sweep
        return getattr(_sweep, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
