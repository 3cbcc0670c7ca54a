"""The port's arrival-process layer (``repro_torch.core.arrivals``): the
cases of ``tests/test_arrivals.py`` on the port (determinism, the periodic
byte-identity guarantee, the strictly-increasing realized-event-time
invariant, spec validation, canonical JSON, distribution sanity,
deadlines, horizons), each draw and each canonical JSON also held to
``repro.core``'s on the same spec, equal.
"""
import json
import random
import statistics

import pytest

import repro.core as ref
from repro_torch.core import (
    ArrivalSpec,
    absolute_deadlines,
    arrival_horizon,
)
from repro_torch.core import draw_arrivals as _draw


def _ref_spec(spec):
    return None if spec is None else ref.ArrivalSpec.from_json(spec.to_json())


def draw_arrivals(spec, periods, n):
    """The port's draw, held to the reference's of the same spec, equal."""
    got = _draw(spec, periods, n)
    assert got == ref.draw_arrivals(_ref_spec(spec), periods, n)
    return got


# -- spec construction / serialization ---------------------------------------

def test_torch_spec_validation():
    with pytest.raises(ValueError, match="unknown arrival kind"):
        ArrivalSpec(kind="bursty")
    with pytest.raises(ValueError, match="unknown jitter distribution"):
        ArrivalSpec(kind="jittered", distribution="pareto")
    with pytest.raises(ValueError, match="explicit timestamps"):
        ArrivalSpec(kind="trace")


def test_torch_spec_canonicalization_and_equality():
    # fields the kind does not consume are canonicalized, so specs compare
    # (and hash, and cache-key) by what they actually mean
    assert ArrivalSpec(kind="poisson", jitter=0.4, seed=1) == \
        ArrivalSpec(kind="poisson", jitter=0.9, seed=1)
    assert ArrivalSpec(kind="jittered", jitter=0.2, sigma=0.7) == \
        ArrivalSpec(kind="jittered", jitter=0.2, sigma=0.1)  # uniform: no σ
    assert ArrivalSpec(kind="jittered", jitter=0.2) != \
        ArrivalSpec(kind="jittered", jitter=0.3)
    a = ArrivalSpec(kind="trace", trace=[[0.0, 1.0]], seed=5)
    assert a.trace == ((0.0, 1.0),)  # normalized to tuples -> hashable
    hash(a)
    assert a.key() != ArrivalSpec(kind="poisson", seed=5).key()


@pytest.mark.parametrize("spec", [
    ArrivalSpec(),
    ArrivalSpec(kind="jittered", jitter=0.3, seed=2),
    ArrivalSpec(kind="jittered", jitter=0.2, distribution="lognormal",
                sigma=0.4, seed=3),
    ArrivalSpec(kind="poisson", seed=9),
    ArrivalSpec(kind="trace", trace=((0.0, 0.004, 0.005), (0.001,))),
])
def test_torch_spec_json_roundtrip(spec):
    wire = json.loads(json.dumps(spec.to_json()))
    assert ArrivalSpec.from_json(wire) == spec
    assert json.dumps(spec.to_json(), sort_keys=True) == json.dumps(
        _ref_spec(spec).to_json(), sort_keys=True)
    assert spec.key() == _ref_spec(spec).key()


# -- draw_arrivals contract ---------------------------------------------------

def test_torch_periodic_is_exactly_rid_times_period():
    """The default path must be byte-identical to the pre-arrival engines,
    which computed ``arrival = rid * period`` inline."""
    periods = [0.005, 0.0037]
    for spec in (None, ArrivalSpec()):
        tables = draw_arrivals(spec, periods, 9)
        for gid, period in enumerate(periods):
            assert tables[gid] == [rid * period for rid in range(9)]


def test_torch_draw_is_deterministic_and_seeded():
    spec = ArrivalSpec(kind="poisson", seed=11)
    a = draw_arrivals(spec, [0.004, 0.006], 12)
    b = draw_arrivals(spec, [0.004, 0.006], 12)
    assert a == b
    c = draw_arrivals(ArrivalSpec(kind="poisson", seed=12), [0.004, 0.006], 12)
    assert a != c
    # group-major draw order: a one-group draw equals the first group of a
    # two-group draw (prefix property of the shared stream)
    solo = draw_arrivals(spec, [0.004], 12)
    assert solo[0] == a[0]


@pytest.mark.parametrize("spec", [
    ArrivalSpec(kind="jittered", jitter=0.9, seed=4),
    ArrivalSpec(kind="jittered", jitter=2.5, seed=4),  # wider than Φ
    ArrivalSpec(kind="jittered", distribution="lognormal", jitter=0.8,
                sigma=1.0, seed=4),
    ArrivalSpec(kind="poisson", seed=4),
    ArrivalSpec(kind="trace", trace=((0.003, 0.001, 0.001, 0.002),
                                     (0.0, 0.0, 0.0))),
])
def test_torch_realized_event_chain_strictly_increases(spec):
    """The invariant every engine's float recurrence relies on: arrivals
    are non-negative and ``t_e(i) = t_e(i-1) + (a_i - t_e(i-1))`` strictly
    increases, even for regressing/tied raw timestamps."""
    for tab in draw_arrivals(spec, [0.004, 0.002], 30):
        assert tab[0] >= 0.0
        te = tab[0]
        for a in tab[1:]:
            assert a > te
            nxt = te + (a - te)
            assert nxt > te
            te = nxt


def test_torch_poisson_mean_interarrival_matches_period():
    phi = 0.01
    tab = draw_arrivals(ArrivalSpec(kind="poisson", seed=0), [phi], 4000)[0]
    gaps = [b - a for a, b in zip(tab, tab[1:])]
    assert statistics.mean(gaps) == pytest.approx(phi, rel=0.1)
    # bursty: the gap distribution has exponential spread, not a spike
    assert statistics.pstdev(gaps) == pytest.approx(phi, rel=0.2)
    assert tab[0] == 0.0


def test_torch_uniform_jitter_bounded():
    phi = 0.01
    j = 0.3
    spec = ArrivalSpec(kind="jittered", jitter=j, seed=1)
    tab = draw_arrivals(spec, [phi], 500)[0]
    offsets = [t - i * phi for i, t in enumerate(tab)]
    assert max(abs(o) for o in offsets[1:]) <= j * phi * (1 + 1e-12)
    assert min(offsets[1:]) < 0 < max(offsets[1:])  # two-sided


def test_torch_lognormal_jitter_positive_delay():
    spec = ArrivalSpec(kind="jittered", jitter=0.5,
                       distribution="lognormal", sigma=0.4, seed=2)
    tab = draw_arrivals(spec, [0.01], 200)[0]
    offsets = [t - i * 0.01 for i, t in enumerate(tab)]
    assert all(o >= 0.0 for o in offsets)
    assert statistics.mean(offsets) == pytest.approx(0.5 * 0.01, rel=0.25)


def test_torch_trace_extension_and_truncation():
    spec = ArrivalSpec(kind="trace", trace=((0.0, 0.005), ()))
    tabs = draw_arrivals(spec, [0.01, 0.02], 4)
    # short trace extends periodically past its last timestamp
    assert tabs[0] == [0.0, 0.005, 0.005 + 0.01, 0.005 + 0.01 + 0.01]
    # empty group trace degenerates to the periodic lattice from t=0
    assert tabs[1][0] == 0.0
    assert all(b > a for a, b in zip(tabs[1], tabs[1][1:]))
    long = ArrivalSpec(kind="trace", trace=((0.0, 0.1, 0.2, 0.3, 0.4),))
    assert len(draw_arrivals(long, [0.01], 2)[0]) == 2


# -- deadlines ----------------------------------------------------------------

def test_torch_absolute_deadlines_match_relative_check():
    """``absolute_deadlines`` is the explicit form of the scoring contract:
    last_finish ≤ arrival_i + Φ  ⟺  arrival-relative makespan ≤ Φ."""
    phi = 0.01
    tab = draw_arrivals(ArrivalSpec(kind="poisson", seed=3), [phi], 50)[0]
    deadlines = absolute_deadlines(tab, phi)
    assert deadlines == [a + phi for a in tab] == ref.absolute_deadlines(tab, phi)
    rng = random.Random(0)
    for arrival, deadline in zip(tab, deadlines):
        last_finish = arrival + rng.uniform(0.0, 2.0 * phi)
        makespan = last_finish - arrival
        assert (last_finish <= deadline) == (makespan <= phi)


# -- horizon ------------------------------------------------------------------

def test_torch_horizon_periodic_matches_historical_expression():
    periods = [0.005, 0.0037]
    nr = 12
    tables = draw_arrivals(None, periods, nr)
    assert arrival_horizon(tables, periods, nr) == \
        max((nr + 2) * max(periods) * 4.0, 1.0) == ref.arrival_horizon(tables, periods, nr)


def test_torch_horizon_extends_past_late_arrivals():
    periods = [0.001]
    nr = 3
    spec = ArrivalSpec(kind="trace", trace=((0.0, 0.5, 9.0),))
    tables = draw_arrivals(spec, periods, nr)
    h = arrival_horizon(tables, periods, nr)
    assert h == ref.arrival_horizon(tables, periods, nr)
    assert h >= 9.0 + 8 * 0.001
    # but never shrinks below the periodic expression
    assert h >= max((nr + 2) * max(periods) * 4.0, 1.0)
