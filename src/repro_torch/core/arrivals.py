"""Pluggable arrival processes for the request sources of every engine tier
(copy of ``repro.core.arrivals``; the port's real-mode runtime draws its
request times from :func:`draw_arrivals`).

The paper's evaluation drives each model group with a strictly periodic
source (arrival_i = i·Φ). Real mobile traffic is burstier — sensor
pipelines jitter, event-driven models (voice, touch) arrive Poisson-like,
and replayed field traces follow neither — and both the multi-DNN
co-execution literature (arXiv:2503.21109) and the mobile-processor
variability study (arXiv:2405.01851) treat arrival structure as a
first-class workload axis. This module generalizes the request sources
into one shared, seeded arrival-timestamp generator that all **four**
engine tiers consume identically:

* :class:`~repro.core.simulator.RuntimeSimulator` (reference DES),
* :class:`~repro.core.fastsim.FastSimulator` (lean + full loops),
* :class:`~repro.core.batchsim.BatchSimulator` (lock-step lanes),
* the virtual-clock :class:`~repro.runtime.PuzzleRuntime`
  (``run_periodic``).

Supported processes (:class:`ArrivalSpec.kind`):

``periodic``
    ``arrival_i = i · Φ`` — the paper's sources and the default. Draws
    nothing from the RNG and reproduces the pre-arrival-layer engines
    byte for byte (same ``int · float`` expression, same event times).
``jittered``
    Periodic base plus per-request jitter. ``distribution="uniform"``
    offsets each arrival by ``U(−j·Φ, +j·Φ)`` with ``j = jitter``;
    ``distribution="lognormal"`` *delays* each arrival by a mean-one
    lognormal (shape ``sigma``) scaled to ``j·Φ`` — the §6.3 noise shape
    applied to the traffic instead of the execution times.
``poisson``
    Exponential inter-arrivals at rate ``1/Φ`` (first request at t = 0),
    so the mean load matches the periodic source at the same α while the
    instantaneous load is bursty.
``trace``
    Explicit per-group timestamp lists (JSON-serializable), replayed
    verbatim. Shorter traces are extended periodically past their last
    timestamp; longer ones are truncated to ``num_requests``.

Exactness contract
------------------
:func:`draw_arrivals` is the *single* source of arrival timestamps: every
tier calls it with the same ``(spec, periods, num_requests)`` and receives
the same floats, drawn from one seeded ``random.Random(spec.seed)``
consumed in a fixed order (group-major, request-minor — the same
convention as the engines' shared noise stream). The engines then schedule
each source event through the same float recurrence the periodic sources
always used (``next_time = now + (arrival − now)``), so their event heaps
stay bit-identical to the last ulp.

Two invariants make that recurrence safe for arbitrary processes and are
enforced here rather than in the four engines:

* arrivals are **non-negative** (the first timestamp is clamped to 0.0);
* the *realized event-time chain* ``t_e(i) = t_e(i−1) + (a_i − t_e(i−1))``
  is **strictly increasing** — raw timestamps that would regress or tie
  (possible under wide uniform jitter or adversarial traces) are bumped to
  ``math.nextafter`` of the previous realized time. Without this, the
  reference DES would clamp a late arrival to ``env.now`` synchronously
  while the heap-based tiers would push a stale event, and parity would
  break exactly one ulp at a time.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

ARRIVAL_KINDS = ("periodic", "jittered", "poisson", "trace")


@dataclass(frozen=True)
class ArrivalSpec:
    """Replayable identity of one arrival process.

    Frozen + hashable so it can participate in evaluation-cache keys
    (:meth:`key`) and in frozen scenario specs. ``seed`` feeds the one
    shared ``random.Random`` stream; two equal specs always draw identical
    timestamps for the same ``(periods, num_requests)``.
    """

    kind: str = "periodic"
    #: jittered: max offset (uniform) / mean delay (lognormal) as a
    #: fraction of the group period Φ
    jitter: float = 0.1
    #: jittered: "uniform" (bounded ±jitter·Φ) or "lognormal" (mean-one
    #: lognormal delay of shape ``sigma``, scaled to jitter·Φ)
    distribution: str = "uniform"
    sigma: float = 0.25
    seed: int = 0
    #: trace: per-group timestamp tuples (seconds); required iff
    #: ``kind == "trace"``
    trace: Optional[Tuple[Tuple[float, ...], ...]] = None

    def __post_init__(self) -> None:
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"unknown arrival kind {self.kind!r}; expected one of "
                f"{ARRIVAL_KINDS}")
        if self.distribution not in ("uniform", "lognormal"):
            raise ValueError(
                f"unknown jitter distribution {self.distribution!r}")
        if self.kind == "trace" and self.trace is None:
            raise ValueError("trace arrivals need explicit timestamps")
        # canonicalize fields the kind does not consume, so equality,
        # hashing, cache keys and JSON round-trips all agree on one
        # representation per process
        if self.kind != "jittered":
            object.__setattr__(self, "jitter", 0.0)
            object.__setattr__(self, "distribution", "uniform")
            object.__setattr__(self, "sigma", 0.0)
        elif self.distribution == "uniform":
            object.__setattr__(self, "sigma", 0.0)
        if self.kind != "trace":
            object.__setattr__(self, "trace", None)
        if self.trace is not None:
            # normalize to tuples so the spec stays hashable after
            # from_json (lists) or direct construction with sequences
            object.__setattr__(
                self, "trace", tuple(tuple(float(t) for t in g)
                                     for g in self.trace))

    def key(self) -> Tuple:
        """Hashable content key for evaluation caches.

        An arrival spec *must* participate in any cache key derived from a
        simulation (the analyzer's objective memo, batched dedup) — two
        runs of the same solution under different arrivals produce
        different results, and a key without the arrival axis would
        silently serve one process's results for the other.
        """
        return (self.kind, self.jitter, self.distribution, self.sigma,
                self.seed, self.trace)

    def to_json(self) -> Dict[str, object]:
        doc: Dict[str, object] = {"kind": self.kind, "seed": self.seed}
        if self.kind == "jittered":
            doc["jitter"] = self.jitter
            doc["distribution"] = self.distribution
            if self.distribution == "lognormal":
                doc["sigma"] = self.sigma
        if self.trace is not None:
            doc["trace"] = [list(g) for g in self.trace]
        return doc

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "ArrivalSpec":
        return cls(
            kind=str(d.get("kind", "periodic")),
            jitter=float(d.get("jitter", 0.1)),
            distribution=str(d.get("distribution", "uniform")),
            sigma=float(d.get("sigma", 0.25)),
            seed=int(d.get("seed", 0)),
            trace=(tuple(tuple(float(t) for t in g) for g in d["trace"])
                   if d.get("trace") is not None else None),
        )


#: The default process. ``None`` everywhere means "periodic": the engines
#: treat both identically and the default path stays byte-for-byte what it
#: was before the arrival layer existed.
PERIODIC = ArrivalSpec()


def _raw_timestamps(
    spec: ArrivalSpec,
    gid: int,
    period: float,
    num_requests: int,
    rng: random.Random,
) -> List[float]:
    """Unclamped per-group timestamps; RNG consumed request-minor."""
    if spec.kind == "periodic":
        return [rid * period for rid in range(num_requests)]
    if spec.kind == "jittered":
        out = []
        for rid in range(num_requests):
            if spec.distribution == "uniform":
                off = (2.0 * rng.random() - 1.0) * spec.jitter * period
            else:
                # mean-one lognormal delay (same shape as the §6.3
                # execution-noise multiplier), scaled to jitter·Φ
                off = spec.jitter * period * math.exp(
                    rng.gauss(-0.5 * spec.sigma * spec.sigma, spec.sigma))
            out.append(rid * period + off)
        return out
    if spec.kind == "poisson":
        out = []
        t = 0.0
        for rid in range(num_requests):
            out.append(t)
            if rid + 1 < num_requests and period > 0.0:
                t = t + rng.expovariate(1.0 / period)
        return out
    # trace: replay verbatim; extend periodically past the last timestamp
    # (an empty group trace degenerates to the periodic lattice from t=0),
    # truncate past num_requests
    tab = list(spec.trace[gid]) if gid < len(spec.trace) else []
    while len(tab) < num_requests:
        tab.append(tab[-1] + period if tab else 0.0)
    return tab[:num_requests]


def draw_arrivals(
    spec: Optional[ArrivalSpec],
    periods: Sequence[float],
    num_requests: int,
) -> List[List[float]]:
    """Per-group arrival timestamps, identical for every engine tier.

    One ``random.Random(spec.seed)`` stream drives all groups, consumed
    group-major then request-minor (the engines' noise-stream convention),
    so group *g*'s timestamps depend on the draws of groups ``< g`` — the
    whole table is a pure function of ``(spec, periods, num_requests)``.

    The returned timestamps are non-negative and chosen so the realized
    event-time chain ``t_e(i) = t_e(i−1) + (a_i − t_e(i−1))`` — the exact
    float recurrence every engine's source uses — is strictly increasing
    (see the module docstring). ``spec=None`` means periodic.
    """
    if spec is None:
        spec = PERIODIC
    rng = random.Random(spec.seed)
    tables: List[List[float]] = []
    for gid, period in enumerate(periods):
        raw = _raw_timestamps(spec, gid, period, num_requests, rng)
        out: List[float] = []
        prev_te: Optional[float] = None
        for t in raw:
            if prev_te is None:
                t = max(t, 0.0)
                te = t
            else:
                if t <= prev_te:
                    t = math.nextafter(prev_te, math.inf)
                te = prev_te + (t - prev_te)
                while te <= prev_te:  # pathological rounding: bump again
                    t = math.nextafter(t, math.inf)
                    te = prev_te + (t - prev_te)
            out.append(t)
            prev_te = te
        tables.append(out)
    return tables


def arrival_horizon(
    tables: Sequence[Sequence[float]],
    periods: Sequence[float],
    num_requests: int,
) -> float:
    """Quiescence horizon shared by all engine tiers.

    For periodic arrivals this returns the engines' historical expression
    ``max((num_requests + 2) · max(periods) · 4.0, 1.0)`` **unchanged**
    (same floats, so default-path results stay byte-identical). Bursty or
    traced arrivals can push the last request past that window, so the
    horizon is extended to the last arrival plus the same relative slack
    (``8 · max(periods)``) whenever that is later — every tier computes
    this from the same tables, so overloaded schedules drop the same
    requests everywhere.
    """
    base = max((num_requests + 2) * max(periods) * 4.0, 1.0)
    last = 0.0
    for tab in tables:
        if tab and tab[-1] > last:
            last = tab[-1]
    extra = last + max(periods) * 8.0
    return base if extra <= base else extra
