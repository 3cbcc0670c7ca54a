"""The port's scoring and NSGA machinery against the JAX package's.

``repro_torch.core.scoring`` and ``repro_torch.core.nsga`` are copies of
``repro.core``'s: on the same seeded inputs (the recipes of
``tests/test_scoring_comm.py``, ``test_scoring_properties.py``,
``test_nsga_chromosome.py`` and ``test_fastsim.py``) every function returns
the same value, compared with ``==`` (tolerance: none), and the same
selections from the same ``random.Random`` stream.
"""
import math
import random

import pytest

import repro.core as rc
import repro.core.scoring as r_scoring
import repro_torch.core as tc
import repro_torch.core.scoring as t_scoring
from repro_torch.core.scoring import ALPHA_GRID


def _makespan_groups(rng, drop=0.1):
    return [
        [rng.uniform(1e-4, 5e-2) if rng.random() > drop else float("inf")
         for _ in range(rng.randint(1, 8))]
        for _ in range(rng.randint(1, 4))
    ]


@pytest.mark.parametrize("seed", range(4))
def test_scores_match(seed):
    rng = random.Random(seed)
    groups = _makespan_groups(rng)
    base = [rng.uniform(1e-3, 2e-2) for _ in groups]
    out = {}
    for tag, pkg in (("ref", rc), ("port", tc)):
        vals = []
        for alpha in (0.2, 0.5, 1.0, 2.0, 6.0):
            dls = [alpha * p for p in base]
            vals.append((pkg.scenario_score(groups, dls),
                         pkg.deadline_satisfaction(groups, dls),
                         [pkg.group_scores(ms, d) for ms, d in zip(groups, dls)],
                         [pkg.qoe_score(ms, d) for ms, d in zip(groups, dls)],
                         [pkg.rt_score(ms[0], d) for ms, d in zip(groups, dls)]))
        vals.append(pkg.absolute_deadlines([0.0, 0.01, 0.025], base[0]))
        out[tag] = vals
    assert out["port"] == out["ref"]


def test_percentile_matches():
    rng = random.Random(5)
    inf = float("inf")
    cases = [list(range(1, 11)), [1.0, 2.0, inf], [1.0, inf, inf], [inf],
             [1.0, inf], [1.0, 2.0, 3.0, inf, inf], []]
    cases += [[rng.uniform(0, 1) for _ in range(rng.randint(1, 30))]
              for _ in range(20)]
    for vals in cases:
        for q in (0.0, 10.0, 50.0, 90.0, 99.0, 100.0):
            got, want = tc.percentile(vals, q), rc.percentile(vals, q)
            assert got == want or (math.isnan(got) and math.isnan(want)), (vals, q)
    assert tc.percentile(list(range(1, 11)), 90) == 9.1 == rc.percentile(
        list(range(1, 11)), 90)


def _random_curve(rng, confirm=4):
    """``_random_curve`` of ``tests/test_scoring_properties.py``."""
    n = len(ALPHA_GRID)
    scores = []
    sat = rng.random() < 0.3
    while len(scores) < n:
        if sat:
            length = rng.randint(1, confirm)
            scores.extend(rng.uniform(0.996, 1.0) for _ in range(length))
        else:
            length = rng.randint(1, 30)
            scores.extend(rng.uniform(0.0, 0.99) for _ in range(length))
        sat = not sat
    scores = scores[:n]
    if rng.random() < 0.6:
        tail = rng.randint(1, 60)
        for i in range(n - tail, n):
            scores[i] = rng.uniform(0.996, 1.0)
    return scores


@pytest.mark.parametrize("seed", range(6))
def test_saturation_and_bisect_match(seed):
    curve = dict(zip(ALPHA_GRID, _random_curve(random.Random(seed))))
    out = {}
    for tag, mod in (("ref", r_scoring), ("port", t_scoring)):
        grid = mod.saturation_multiplier(lambda a: curve[a])
        bis = mod.saturation_multiplier_bisect(lambda a: curve[a])
        skip = mod.saturation_multiplier_bisect(lambda a: curve[a],
                                                skip_below=1.0)
        sub = mod.saturation_multiplier(lambda a: curve[a],
                                        alphas=ALPHA_GRID[::7])
        out[tag] = [(r.alpha_star, r.scores) for r in (grid, bis, skip, sub)]
    assert out["port"] == out["ref"]
    assert t_scoring.ALPHA_GRID == r_scoring.ALPHA_GRID
    assert t_scoring.RT_K == r_scoring.RT_K


def test_bisect_probe_sequence_matches():
    """The generator core shared by the scalar and population searches."""
    def probes(mod, curve):
        gen = mod.bisect_alpha_probes()
        seq = []
        try:
            a = next(gen)
            while True:
                seq.append(a)
                a = gen.send(curve(a))
        except StopIteration as stop:
            return seq, stop.value.alpha_star
    for mid in (0.3, 1.17, 2.5, 5.95):
        def curve(a, _mid=mid):
            return 1.0 / (1.0 + math.exp(-40.0 * (a - _mid)))
        assert probes(t_scoring, curve) == probes(r_scoring, curve)


def test_score_edge_cases_match():
    for mod in (t_scoring, r_scoring):
        with pytest.raises(ValueError):
            mod.deadline_satisfaction([[1.0], [2.0]], [1.0])
    assert tc.deadline_satisfaction([], []) == rc.deadline_satisfaction([], [])
    assert tc.qoe_score([], 1.0) == rc.qoe_score([], 1.0) == 0.0
    assert tc.rt_score(float("inf"), 1.0) == 0.0
    assert tc.rt_score(0.5, 0.0) == rc.rt_score(0.5, 0.0)


# -- NSGA --------------------------------------------------------------------

def _fits(rng, n, n_obj):
    return [[rng.choice([rng.uniform(0, 1), rng.uniform(0, 1), 1e6])
             for _ in range(n_obj)] for _ in range(n)]


@pytest.mark.parametrize("n_obj", [2, 4, 6])
@pytest.mark.parametrize("vectorized", [True, False])
def test_non_dominated_sort_and_selection_match(n_obj, vectorized):
    rng = random.Random(n_obj)
    for _ in range(3):
        fits = _fits(rng, 40, n_obj)
        fronts = tc.fast_non_dominated_sort(fits, vectorized=vectorized)
        assert fronts == rc.fast_non_dominated_sort(fits, vectorized=vectorized)
        assert fronts == tc.fast_non_dominated_sort(fits, vectorized=not vectorized)
        for k in (5, 15, 39):
            sel_t = tc.nsga3_select(fits, k, rng=random.Random(k),
                                    vectorized=vectorized)
            sel_r = rc.nsga3_select(fits, k, rng=random.Random(k),
                                    vectorized=vectorized)
            assert sel_t == sel_r
        assert tc.crowding_distance(fits, fronts[0]) == \
            rc.crowding_distance(fits, fronts[0])


def test_das_dennis_and_dominates_match():
    for n_obj in range(1, 7):
        for div in (1, 2, 4, 8):
            assert tc.das_dennis(n_obj, div) == rc.das_dennis(n_obj, div)
    rng = random.Random(3)
    for _ in range(200):
        a = [rng.choice((0.0, 1.0, 2.0)) for _ in range(3)]
        b = [rng.choice((0.0, 1.0, 2.0)) for _ in range(3)]
        assert tc.dominates(a, b) == rc.dominates(a, b)


def test_nsga3_small_cases_match():
    front0 = [(1.0, 4.0), (2.0, 3.0), (3.0, 2.0), (4.0, 1.0), (5.0, 5.0),
              (6.0, 6.0)]
    spread = [(i, 7 - i) for i in range(8)]
    for fits, k in ((front0, 4), (spread, 4), (spread, 8), (spread, 3)):
        assert tc.nsga3_select(fits, k, rng=random.Random(0)) == \
            rc.nsga3_select(fits, k, rng=random.Random(0))
    assert sorted(tc.nsga3_select(front0, 4, rng=random.Random(0))) == [0, 1, 2, 3]
