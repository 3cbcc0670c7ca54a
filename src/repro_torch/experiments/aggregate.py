"""Sweep aggregation: the paper's headline metrics from per-scenario results.

The paper's central numbers (§6, Fig. 11) are *aggregate* request-frequency
gains over randomly generated scenarios: Puzzle sustains 3.7× / 2.2× higher
request frequency than NPU Only / Best Mapping on average. Since request
frequency is the inverse of the sustainable period, the per-scenario gain
is the α* ratio ``α*_baseline / α*_puzzle``; this module reduces a list of
:class:`~repro_torch.experiments.evaluate.ScenarioResult` to:

* per-method α* statistics (capped mean, median, fraction saturated),
* the **geometric mean** of per-scenario α* ratios vs. each baseline
  (the right mean for ratios: invariant to which side is the numerator),
* the arithmetic mean ratio (what a "N× on average" headline usually is),
* mean deadline-satisfaction rate per method at the base period.

Pure math on plain data — no simulation — so it is cheap to re-run over a
sweep directory and easy to unit-test on canned results.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

from ..core.scoring import percentile
from .evaluate import METHODS, ScenarioResult


def geometric_mean(values: Sequence[float]) -> float:
    """Geometric mean of positive values; 0.0 for an empty sequence.

    ``inf`` inputs propagate to ``inf`` (callers cap α* before forming
    ratios, so finite output is the normal case).
    """
    if not values:
        return 0.0
    if any(math.isinf(v) for v in values):
        return float("inf")
    return math.exp(sum(math.log(v) for v in values) / len(values))


def aggregate_results(
    results: Sequence[ScenarioResult],
    alpha_cap: float = 6.0,
) -> Dict[str, object]:
    """Reduce per-scenario results to the sweep's headline metrics.

    α* means/medians are computed with unsaturated scenarios capped at
    ``alpha_cap`` (matching the per-scenario ratio convention), and
    ``saturated_fraction`` reports how often each method saturated at all so
    the capping is visible rather than silent. Ratios come pre-capped from
    :class:`ScenarioResult`; ``speedup_geomean["vs_npu_only"]`` is the
    sweep-level analogue of the paper's 3.7× (and ``vs_best_mapping`` of the
    2.2×).
    """
    out: Dict[str, object] = {"num_scenarios": len(results)}
    if not results:
        return out

    alpha_stats: Dict[str, Dict[str, float]] = {}
    for m in METHODS:
        vals = [min(r.alpha_star[m], alpha_cap) for r in results]
        finite = [r.alpha_star[m] for r in results
                  if not math.isinf(r.alpha_star[m])]
        alpha_stats[m] = {
            "mean_capped": sum(vals) / len(vals),
            "median_capped": percentile(vals, 50.0),
            "saturated_fraction": len(finite) / len(results),
        }
    out["alpha_star"] = alpha_stats

    out["speedup_geomean"] = {
        "vs_npu_only": geometric_mean([r.ratios["npu_only"] for r in results]),
        "vs_best_mapping": geometric_mean(
            [r.ratios["best_mapping"] for r in results]),
    }
    # same gain under the pick-your-best-schedule convention (min over each
    # method's candidate set instead of the §6.2 median)
    out["speedup_geomean_best"] = {
        f"vs_{m}": geometric_mean([
            min(r.alpha_star_best[m], alpha_cap)
            / min(r.alpha_star_best["puzzle"], alpha_cap)
            for r in results
        ])
        for m in ("npu_only", "best_mapping")
    }
    out["speedup_mean"] = {
        "vs_npu_only": sum(r.ratios["npu_only"] for r in results) / len(results),
        "vs_best_mapping": sum(r.ratios["best_mapping"] for r in results)
        / len(results),
    }
    out["satisfaction_rate"] = {
        m: sum(r.satisfaction[m] for r in results) / len(results)
        for m in METHODS
    }
    out["total_wall_s"] = sum(r.wall_s for r in results)
    out["total_ga_evaluations"] = sum(r.ga_evaluations for r in results)
    return out
