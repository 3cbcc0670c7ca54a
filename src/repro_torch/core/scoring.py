"""XRBench-style scoring (paper §6.2).

Implements makespan aggregation, QoE score, Realtime score (k = 15),
the combined scenario score, and the *saturation multiplier*
α* = min{α | Score(α, S) = 1.0} used as the headline comparison metric.

Deadline semantics under pluggable arrivals
-------------------------------------------
Request *i* of a group must finish by the **absolute** deadline
``arrival_i + Φ`` where Φ is the group's (α-scaled) period — under
periodic arrivals that degenerates to "finish before the next request",
but the per-request form is what generalizes to jittered / Poisson /
traced sources (:mod:`repro_torch.core.arrivals`). Every function here takes
*makespans*, which the simulators measure **relative to each request's own
arrival** (``Θ_i = last_finish_i − arrival_i``; a task can never start
before its request arrives), so the check ``Θ_i ≤ Φ`` is exactly the
absolute-deadline check for any arrival process. ``deadline`` arguments
throughout are therefore the *relative* deadline Φ, never an absolute
timestamp; :func:`absolute_deadlines` materializes the per-request
absolute form when a caller needs it (reports, trace tooling).

Copy of ``repro.core.scoring``, verbatim in its arithmetic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Generator, List, Optional, Sequence, Tuple

RT_K = 15.0  # sigmoid sharpness, same as XRBench

#: The paper's α lattice: 0.2 .. 6.0 in 0.05 steps. Shared by the grid scan,
#: the bisection defaults and the batched population search so they always
#: probe the same points.
ALPHA_GRID = tuple(round(0.2 + 0.05 * i, 4) for i in range(117))


def absolute_deadlines(arrivals: Sequence[float], phi: float) -> List[float]:
    """Per-request absolute deadlines ``arrival_i + Φ``.

    The explicit form of the scoring contract above: request *i* arriving
    at ``arrival_i`` must finish by ``arrival_i + Φ``. Equivalent to
    checking the arrival-relative makespan against Φ, which is what the
    scoring functions do; this helper exists for callers that work with
    absolute trace timestamps instead of makespans.
    """
    return [a + phi for a in arrivals]


def qoe_score(makespans: Sequence[float], deadline: float) -> float:
    """Fraction of requests finishing within the relative deadline Φ
    (equivalently: by their absolute deadline ``arrival_i + Φ``)."""
    if not makespans:
        return 0.0
    ok = sum(1 for m in makespans if m <= deadline)
    return ok / len(makespans)


def rt_score(makespan: float, deadline: float, k: float = RT_K) -> float:
    """Sigmoid realtime score of one request.

    XRBench's sigmoid is deadline-normalized — the argument is the slack
    *ratio* ``Θ/Φ − 1``, not an absolute time difference (otherwise k = 15
    could never saturate at millisecond scales).
    """
    if math.isinf(makespan):
        return 0.0
    if deadline <= 0:
        return 0.0
    x = k * (makespan / deadline - 1.0)
    if x > 60:
        return 0.0
    if x < -60:
        return 1.0
    return 1.0 / (1.0 + math.exp(x))


def group_scores(
    makespans: Sequence[float], deadline: float, k: float = RT_K
) -> Tuple[float, float]:
    """(mean RtScore, QoE) for one model group."""
    if not makespans:
        return 0.0, 0.0
    rt = sum(rt_score(m, deadline, k) for m in makespans) / len(makespans)
    return rt, qoe_score(makespans, deadline)


def scenario_score(
    per_group_makespans: Sequence[Sequence[float]],
    per_group_deadlines: Sequence[float],
    k: float = RT_K,
) -> float:
    """Score(α, S) = (1/N) Σ_G mean-RtScore(G) × QoE(G)."""
    n = len(per_group_makespans)
    if n == 0:
        return 0.0
    total = 0.0
    for ms, dl in zip(per_group_makespans, per_group_deadlines):
        rt, qoe = group_scores(ms, dl, k)
        total += rt * qoe
    return total / n


def deadline_satisfaction(
    per_group_makespans: Sequence[Sequence[float]],
    per_group_deadlines: Sequence[float],
) -> float:
    """Fraction of *all* requests (pooled across groups) meeting their
    group's deadline.

    Unlike :func:`scenario_score` this is a plain hit rate — no sigmoid, no
    per-group averaging — so it is the "satisfying the equivalent level of
    real-time requirements" check of the paper's headline claim. Makespans
    and deadlines are in the same unit (seconds throughout this repo);
    dropped requests (``inf`` makespan) count as misses. Returns 0.0 for an
    empty scenario. Raises ``ValueError`` when the number of makespan groups
    and deadlines disagree (a silently truncating ``zip`` would under-count).
    """
    if len(per_group_makespans) != len(per_group_deadlines):
        raise ValueError(
            f"group count mismatch: {len(per_group_makespans)} makespan "
            f"groups vs {len(per_group_deadlines)} deadlines")
    total = 0
    ok = 0
    for ms, dl in zip(per_group_makespans, per_group_deadlines):
        for m in ms:
            total += 1
            # the isinf guard matters only for an infinite deadline, where
            # `inf <= inf` would count a dropped request as a hit
            if m <= dl and not math.isinf(m):
                ok += 1
    return ok / total if total else 0.0


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]).

    inf-safe: when q lands exactly on a sample, that sample is returned
    directly instead of interpolating (``vals[lo] + 0.0 * inf`` would be
    NaN when the next sample is ``inf``, e.g. an unsaturated α*).
    """
    vals = sorted(values)
    if not vals:
        return float("inf")
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    if frac == 0.0 or vals[lo] == vals[hi]:
        return vals[lo]
    return vals[lo] * (1 - frac) + vals[hi] * frac


@dataclass
class SaturationResult:
    alpha_star: float
    scores: List[Tuple[float, float]]  # (alpha, score) samples


def saturation_multiplier(
    evaluate: Callable[[float], float],
    alphas: Optional[Sequence[float]] = None,
    threshold: float = 0.995,
) -> SaturationResult:
    """α* = min α with Score(α) ≥ threshold (paper treats 1.0 as saturated).

    ``evaluate(alpha)`` must return the scenario score when every group's
    period is ``alpha × base_period``. Scans a grid ascending; scores are
    typically monotone in α but contention noise can wiggle them, so we
    return the first α from which the score stays saturated.
    """
    if alphas is None:
        alphas = ALPHA_GRID
    samples: List[Tuple[float, float]] = []
    sat_from: Optional[float] = None
    for a in alphas:
        s = evaluate(a)
        samples.append((a, s))
        if s >= threshold:
            if sat_from is None:
                sat_from = a
        else:
            sat_from = None
    return SaturationResult(
        alpha_star=sat_from if sat_from is not None else float("inf"),
        scores=samples,
    )


def bisect_alpha_probes(
    lo: float = 0.2,
    hi: float = 6.0,
    step: float = 0.05,
    threshold: float = 0.995,
    confirm: int = 4,
    skip_below: float = 0.0,
) -> Generator[float, float, float]:
    """Generator core of the bracket-then-bisect α*-search.

    Yields the α value to evaluate next; the caller sends back the score.
    Returns (via ``StopIteration.value``) the final
    :class:`SaturationResult`. Factoring the probe *sequence* out of the
    evaluation lets the scalar search and the population-batched search
    (``StaticAnalyzer.population_saturation``) share one algorithm, so they
    probe identical lattice points and return identical results by
    construction.

    ``skip_below`` is the static analyzer's proven infeasibility bound: the
    caller guarantees ``score(α) < threshold`` for every ``α < skip_below``
    (repro.analysis deadline lower bounds). Probes strictly below it are
    answered with score 0.0 without yielding — i.e. without simulating —
    which cannot change α* as long as the guarantee holds (the skipped
    probes appear in ``scores`` as 0.0 samples).
    """
    n = int(round((hi - lo) / step))
    cache: Dict[int, float] = {}

    def ev(i: int) -> Generator[float, float, float]:
        s = cache.get(i)
        if s is None:
            if round(lo + step * i, 4) < skip_below:
                s = 0.0  # proven < threshold by the caller; don't simulate
            else:
                s = yield round(lo + step * i, 4)
            cache[i] = s
        return s

    def result(alpha_star: float) -> SaturationResult:
        samples = sorted((round(lo + step * i, 4), s) for i, s in cache.items())
        return SaturationResult(alpha_star=alpha_star, scores=samples)

    if (yield from ev(n)) < threshold:
        return result(float("inf"))
    floor = -1  # highest lattice index known (or assumed) unsaturated
    while True:
        a, b = floor, n  # invariant: ev(b) >= threshold
        while b - a > 1:
            mid = (a + b) // 2
            if (yield from ev(mid)) >= threshold:
                b = mid
            else:
                a = mid
        dip = None
        for j in range(b + 1, min(b + confirm + 1, n)):
            if (yield from ev(j)) < threshold:
                dip = j
                break
        if dip is None:
            return result(round(lo + step * b, 4))
        floor = dip  # dip strictly above the previous bracket → terminates


def saturation_multiplier_bisect(
    evaluate: Callable[[float], float],
    lo: float = 0.2,
    hi: float = 6.0,
    step: float = 0.05,
    threshold: float = 0.995,
    confirm: int = 4,
    skip_below: float = 0.0,
) -> SaturationResult:
    """Bracket-then-bisect α*-search over the (near-monotone) score curve.

    Evaluates on the same ``lo + step·i`` lattice as the linear scan of
    :func:`saturation_multiplier` so results are directly comparable, but
    needs ~15 ``evaluate`` calls instead of ~117:

    1. If the score at ``hi`` is unsaturated, no α saturates → inf (matches
       the grid semantics, where a dip at the last sample clears ``sat_from``).
    2. Bisect for the smallest lattice point with score ≥ threshold.
    3. Confirmation scan: check the next ``confirm`` lattice points above the
       candidate; contention noise can wiggle the curve, so a dip there
       restarts the bracket above the dip (the paper's "stays saturated"
       semantics). Dips wider than ``confirm`` grid points between the
       candidate and ``hi`` can be missed — that is the accuracy/speed
       trade-off versus the exhaustive scan.

    The probe sequence itself lives in :func:`bisect_alpha_probes`; this
    wrapper drives it with a plain callable. ``skip_below`` forwards the
    analyzer's proven infeasibility bound (see :func:`bisect_alpha_probes`).
    """
    gen = bisect_alpha_probes(lo, hi, step, threshold, confirm, skip_below)
    try:
        alpha = next(gen)
        while True:
            alpha = gen.send(evaluate(alpha))
    except StopIteration as stop:
        return stop.value
