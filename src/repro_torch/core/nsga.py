"""NSGA-II/III machinery (Deb & Jain 2013) used for population replacement.

The paper updates its population with NSGA-III (§4.3). DEAP is unavailable
offline, so this is a from-scratch implementation:

* fast non-dominated sorting,
* Das–Dennis structured reference points,
* normalization with ideal point + extreme-point intercepts,
* association + niching for the boundary front.

All objectives are minimized.

Copy of ``repro.core.nsga``, verbatim in its arithmetic.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff ``a`` Pareto-dominates ``b`` (minimization)."""
    not_worse = all(x <= y for x, y in zip(a, b))
    strictly_better = any(x < y for x, y in zip(a, b))
    return not_worse and strictly_better


def fast_non_dominated_sort(
    fits: Sequence[Sequence[float]], vectorized: bool = True
) -> List[List[int]]:
    """Return fronts (lists of indices), best front first.

    The O(M·N²) pairwise domination test is vectorized into one broadcasted
    comparison — this runs on ``pop + offspring`` every GA generation, so it
    is on the search hot path. Front peeling preserves the classic Deb
    ordering (indices within a front ascend in discovery order).
    ``vectorized=False`` selects the original pure-Python implementation,
    kept as the reference oracle (differential-tested in the suite) and for
    seed-path benchmarking.
    """
    n = len(fits)
    if n == 0:
        return []
    if vectorized:
        F = np.asarray(fits, dtype=np.float64)
        # dom[p, q] = fits[p] dominates fits[q]
        le = np.all(F[:, None, :] <= F[None, :, :], axis=2)
        lt = np.any(F[:, None, :] < F[None, :, :], axis=2)
        dom = le & lt
        dom_count = dom.sum(axis=0).tolist()   # times each q is dominated
        S: List[List[int]] = [np.flatnonzero(row).tolist() for row in dom]
    else:
        S = [[] for _ in range(n)]
        dom_count = [0] * n
        for p in range(n):
            for q in range(n):
                if p == q:
                    continue
                if dominates(fits[p], fits[q]):
                    S[p].append(q)
                elif dominates(fits[q], fits[p]):
                    dom_count[p] += 1
    fronts: List[List[int]] = [[p for p in range(n) if dom_count[p] == 0]]
    i = 0
    while fronts[i]:
        nxt: List[int] = []
        for p in fronts[i]:
            for q in S[p]:
                dom_count[q] -= 1
                if dom_count[q] == 0:
                    nxt.append(q)
        i += 1
        fronts.append(nxt)
    fronts.pop()
    return fronts


def das_dennis(n_obj: int, divisions: int) -> List[Tuple[float, ...]]:
    """Structured reference points on the unit simplex."""
    pts: List[Tuple[float, ...]] = []

    def rec(prefix: List[float], left: int, dims: int) -> None:
        if dims == 1:
            pts.append(tuple(prefix + [left / divisions]))
            return
        for i in range(left + 1):
            rec(prefix + [i / divisions], left - i, dims - 1)

    rec([], divisions, n_obj)
    return pts


def _normalize_py(fits: List[Sequence[float]]) -> List[List[float]]:
    """Pure-Python reference for :func:`_normalize` (seed implementation)."""
    n_obj = len(fits[0])
    ideal = [min(f[k] for f in fits) for k in range(n_obj)]
    translated = [[f[k] - ideal[k] for k in range(n_obj)] for f in fits]
    intercepts = []
    for k in range(n_obj):
        weights = [1e-6] * n_obj
        weights[k] = 1.0
        ext = min(translated, key=lambda t: max(t[j] / weights[j] for j in range(n_obj)))
        intercepts.append(max(ext[k], 1e-12))
    return [[t[k] / intercepts[k] for k in range(n_obj)] for t in translated]


def _associate_py(norm: List[List[float]], refs: List[Tuple[float, ...]]
                  ) -> Tuple[List[int], List[float]]:
    """Pure-Python reference for :func:`_associate` (seed implementation)."""
    assoc, dist = [], []
    for p in norm:
        best_r, best_d = 0, float("inf")
        for r_i, r in enumerate(refs):
            rn = math.sqrt(sum(x * x for x in r)) or 1.0
            dot = sum(p[k] * r[k] for k in range(len(r))) / rn
            d2 = sum((p[k] - dot * r[k] / rn) ** 2 for k in range(len(r)))
            if d2 < best_d:
                best_d, best_r = d2, r_i
        assoc.append(best_r)
        dist.append(math.sqrt(best_d))
    return assoc, dist


def _normalize(fits: List[Sequence[float]]) -> List[List[float]]:
    """Ideal-point translation + intercept normalization (NSGA-III §IV-C)."""
    F = np.asarray(fits, dtype=np.float64)
    translated = F - F.min(axis=0)
    # extreme points via achievement scalarizing function
    n_obj = F.shape[1]
    weights = np.full((n_obj, n_obj), 1e-6)
    np.fill_diagonal(weights, 1.0)
    # asf[k, i] = max_j translated[i, j] / weights[k, j]
    asf = (translated[None, :, :] / weights[:, None, :]).max(axis=2)
    ext = translated[asf.argmin(axis=1)]            # (n_obj, n_obj)
    intercepts = np.maximum(np.diagonal(ext), 1e-12)
    # Gaussian-elimination-based hyperplane intercepts are ideal; extreme-point
    # axis values are a robust fallback that behaves identically for the 2-3
    # objective cases used here and cannot produce degenerate planes.
    return (translated / intercepts).tolist()


def _associate(norm: List[List[float]], refs: List[Tuple[float, ...]]
               ) -> Tuple[List[int], List[float]]:
    """Associate each point with its closest reference line (vectorized).

    Perpendicular distance² to the line through a unit reference ``u`` is
    ``|p|² − (p·u)²``; runs on every niching call, so it is broadcast over
    all (point, reference) pairs at once.
    """
    P = np.asarray(norm, dtype=np.float64)
    R = np.asarray(refs, dtype=np.float64)
    rn = np.sqrt((R * R).sum(axis=1))
    rn[rn == 0.0] = 1.0
    U = R / rn[:, None]
    dot = P @ U.T                                   # (n_points, n_refs)
    d2 = (P * P).sum(axis=1)[:, None] - dot * dot
    np.maximum(d2, 0.0, out=d2)                     # clamp fp cancellation
    assoc = d2.argmin(axis=1)
    dist = np.sqrt(d2[np.arange(len(norm)), assoc])
    return assoc.tolist(), dist.tolist()


def nsga3_select(
    fits: Sequence[Sequence[float]],
    k: int,
    rng: Optional[random.Random] = None,
    divisions: Optional[int] = None,
    vectorized: bool = True,
) -> List[int]:
    """Select ``k`` indices from ``fits`` by NSGA-III environmental selection."""
    rng = rng or random.Random(0)
    if k >= len(fits):
        return list(range(len(fits)))
    n_obj = len(fits[0])
    fronts = fast_non_dominated_sort(fits, vectorized=vectorized)
    chosen: List[int] = []
    last_front: List[int] = []
    for front in fronts:
        if len(chosen) + len(front) <= k:
            chosen.extend(front)
            if len(chosen) == k:
                return chosen
        else:
            last_front = front
            break
    # niche the boundary front
    if divisions is None:
        divisions = {1: 12, 2: 12, 3: 12, 4: 8, 5: 6}.get(n_obj, 4)
    refs = das_dennis(n_obj, divisions)
    pool = chosen + last_front
    fits_pool = [fits[i] for i in pool]
    if vectorized:
        norm = _normalize(list(fits_pool))
        assoc, dist = _associate(norm, refs)
    else:
        norm = _normalize_py(list(fits_pool))
        assoc, dist = _associate_py(norm, refs)
    niche_count: Dict[int, int] = {}
    for j in range(len(chosen)):
        niche_count[assoc[j]] = niche_count.get(assoc[j], 0) + 1
    candidates = list(range(len(chosen), len(pool)))  # indices into pool
    while len(chosen) < k and candidates:
        # pick the reference with the fewest members among candidate refs
        cand_refs = {assoc[c] for c in candidates}
        min_count = min(niche_count.get(r, 0) for r in cand_refs)
        ref_pool = [r for r in cand_refs if niche_count.get(r, 0) == min_count]
        r = rng.choice(sorted(ref_pool))
        members = [c for c in candidates if assoc[c] == r]
        if niche_count.get(r, 0) == 0:
            pick = min(members, key=lambda c: dist[c])  # closest to the ref line
        else:
            pick = rng.choice(sorted(members))
        chosen.append(pool[pick])
        candidates.remove(pick)
        niche_count[r] = niche_count.get(r, 0) + 1
    return chosen


def crowding_distance(fits: Sequence[Sequence[float]], front: List[int]) -> Dict[int, float]:
    """NSGA-II crowding distance (used by tests & as a tie-breaker utility)."""
    dist = {i: 0.0 for i in front}
    if len(front) <= 2:
        for i in front:
            dist[i] = float("inf")
        return dist
    n_obj = len(fits[front[0]])
    for k in range(n_obj):
        ordered = sorted(front, key=lambda i: fits[i][k])
        dist[ordered[0]] = dist[ordered[-1]] = float("inf")
        span = fits[ordered[-1]][k] - fits[ordered[0]][k] or 1.0
        for a, b, c in zip(ordered, ordered[1:], ordered[2:]):
            dist[b] += (fits[c][k] - fits[a][k]) / span
    return dist
