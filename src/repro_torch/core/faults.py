"""Deterministic fault injection shared by every engine tier.

Puzzle's evaluation assumes processors behave as profiled, but mobile SoCs
do not: thermal/DVFS throttling slows accelerators mid-run
(arXiv:2405.01851 measures sustained multi-× slowdowns), co-execution
contention produces heavy-tailed per-task stragglers (arXiv:2503.21109),
and device software occasionally drops an accelerator outright. This module defines
one seeded, replayable description of such faults — :class:`FaultSpec` —
and one shared realization of it — :class:`FaultStream` — that all **four**
parity-enforced engine tiers consume identically:

* :class:`~repro_torch.core.simulator.RuntimeSimulator` (reference DES),
* :class:`~repro_torch.core.fastsim.FastSimulator` (full loop; the lean loop is
  bypassed whenever faults are present),
* :class:`~repro_torch.core.batchsim.BatchSimulator` (lock-step lanes), and
* the virtual-clock :class:`~repro_torch.runtime.PuzzleRuntime` (via
  :class:`~repro_torch.runtime.clock.SimCostSource`).

Fault classes (:class:`FaultSpec`):

``dropouts``
    Processor ``pid`` stops serving at time ``start``; ``repair=None``
    means permanent, otherwise the processor resumes after ``repair``
    seconds. A task delivered to a dropped processor stalls until the
    repair time (forever when permanent — the request is dropped at the
    horizon, identically in every tier).
``throttles``
    Multiplicative slowdown ``factor`` (> 1 = slower) applied to every
    execution on ``pid`` that *starts* inside ``[t0, t1)`` — a piecewise-
    constant DVFS/thermal curve.
``straggler_prob`` / ``straggler_shape``
    Per-task stragglers: with probability ``p`` a delivered task's
    execution time is inflated by a Pareto(shape) multiplier ≥ 1 —
    heavy-tailed, mean-unbounded for ``shape <= 1``.

Exactness contract
------------------
The stream draws from one ``random.Random(spec.seed)``, consumed in
**global delivery order** — exactly the convention of the engines' shared
noise stream, and the reason all four tiers realize the same faults: their
delivery orders are already proven identical by the golden-trace and
differential machinery. :meth:`FaultStream.service` is the *only*
sampler; every tier calls it once per delivered real task (dispatch
tokens are exempt — they model coordinator work, not accelerator work),
after the noise multiplier and before the ``total = exec + quant + comm``
sum, and applies the returned ``stall`` as ``total = stall + total``.
Fault state is sampled at delivery time: the model is non-preemptive, so
a task that *starts* before a dropout completes normally — matching the
runtime, where an in-flight kernel cannot be recalled.

The stream itself is recovery-agnostic. Recovery (retry, backoff, the
dropout → backup-mapping remap) is a *policy* layered on the runtime and
analyzer (:mod:`repro.runtime.recovery`); parity-oracle runs inject
faults without recovery so the four tiers stay bit-comparable.

Copy of ``repro.core.faults``, verbatim. The port's simulators use it; the
runtime's fault injection comes with slice 6b (ROADMAP).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class FaultSpec:
    """Replayable identity of one fault ensemble.

    Frozen + hashable so it can join evaluation-cache keys (:meth:`key`)
    and frozen scenario specs, exactly like
    :class:`~repro_torch.core.arrivals.ArrivalSpec`. ``seed`` feeds the one
    shared straggler stream; two equal specs always realize identical
    faults for the same delivery sequence.
    """

    #: ``(pid, start, repair)`` triples; ``repair=None`` = permanent.
    dropouts: Tuple[Tuple[int, float, Optional[float]], ...] = ()
    #: ``(pid, t0, t1, factor)`` windows; factor > 1 = slower.
    throttles: Tuple[Tuple[int, float, float, float], ...] = ()
    #: per-task straggler probability in [0, 1).
    straggler_prob: float = 0.0
    #: Pareto tail shape of the straggler multiplier (> 0 when prob > 0).
    straggler_shape: float = 2.0
    seed: int = 0

    def __post_init__(self) -> None:
        drops = []
        for pid, start, repair in self.dropouts:
            start = float(start)
            if start < 0.0:
                raise ValueError(f"dropout start must be >= 0, got {start}")
            if repair is not None:
                repair = float(repair)
                if repair <= 0.0:
                    raise ValueError(
                        f"dropout repair must be > 0, got {repair}")
            drops.append((int(pid), start, repair))
        throts = []
        for pid, t0, t1, factor in self.throttles:
            t0, t1, factor = float(t0), float(t1), float(factor)
            if not t0 < t1:
                raise ValueError(f"throttle window needs t0 < t1, got "
                                 f"[{t0}, {t1})")
            if factor <= 0.0:
                raise ValueError(f"throttle factor must be > 0, got {factor}")
            throts.append((int(pid), t0, t1, factor))
        if not 0.0 <= self.straggler_prob < 1.0:
            raise ValueError(
                f"straggler_prob must be in [0, 1), got {self.straggler_prob}")
        if self.straggler_prob > 0.0 and self.straggler_shape <= 0.0:
            raise ValueError(
                f"straggler_shape must be > 0, got {self.straggler_shape}")
        # canonicalize: sorted windows and one representation per ensemble,
        # so equality/hash/cache keys/JSON round-trips all agree
        object.__setattr__(
            self, "dropouts",
            tuple(sorted(drops, key=lambda d: (d[1], d[0]))))
        object.__setattr__(
            self, "throttles",
            tuple(sorted(throts, key=lambda w: (w[1], w[2], w[0]))))
        object.__setattr__(self, "straggler_prob",
                           float(self.straggler_prob))
        if self.straggler_prob == 0.0:
            # shape is never consumed without stragglers
            object.__setattr__(self, "straggler_shape", 0.0)
        else:
            object.__setattr__(self, "straggler_shape",
                               float(self.straggler_shape))

    @property
    def empty(self) -> bool:
        """True when the spec injects nothing (engines may skip the hook)."""
        return (not self.dropouts and not self.throttles
                and self.straggler_prob == 0.0)

    def dropped_pids(self) -> Tuple[int, ...]:
        """Pids that suffer a *permanent* dropout (recovery targets)."""
        return tuple(sorted({pid for pid, _, repair in self.dropouts
                             if repair is None}))

    def key(self) -> Tuple:
        """Hashable content key for evaluation caches.

        A fault spec *must* participate in any cache key derived from a
        simulation — the same solution under different faults produces
        different results, and a key without the fault axis would silently
        serve one ensemble's results for the other.
        """
        return (self.dropouts, self.throttles, self.straggler_prob,
                self.straggler_shape, self.seed)

    def to_json(self) -> Dict[str, object]:
        doc: Dict[str, object] = {"seed": self.seed}
        if self.dropouts:
            doc["dropouts"] = [list(d) for d in self.dropouts]
        if self.throttles:
            doc["throttles"] = [list(w) for w in self.throttles]
        if self.straggler_prob > 0.0:
            doc["straggler_prob"] = self.straggler_prob
            doc["straggler_shape"] = self.straggler_shape
        return doc

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "FaultSpec":
        return cls(
            dropouts=tuple(
                (int(p), float(s), None if r is None else float(r))
                for p, s, r in d.get("dropouts", ())),
            throttles=tuple(
                (int(p), float(t0), float(t1), float(f))
                for p, t0, t1, f in d.get("throttles", ())),
            straggler_prob=float(d.get("straggler_prob", 0.0)),
            straggler_shape=float(d.get("straggler_shape", 2.0)),
            seed=int(d.get("seed", 0)),
        )


#: The no-fault ensemble. ``None`` everywhere means the same thing: the
#: engines treat both identically and the clean path stays byte-for-byte
#: what it was before the fault layer existed.
NO_FAULTS = FaultSpec()


class FaultStream:
    """Seeded realization of a :class:`FaultSpec` for one simulation run.

    Every engine tier instantiates one stream per run and calls
    :meth:`service` once per delivered real task, in delivery order. The
    straggler draw consumes exactly one ``rng.random()`` per call whenever
    ``straggler_prob > 0`` (regardless of outcome or processor), so the
    stream position is a pure function of the delivery count — the same
    discipline that keeps the engines' noise streams aligned.
    """

    __slots__ = ("spec", "_rng", "_drop", "_throttle", "_prob", "_inv_shape")

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._rng = random.Random(spec.seed)
        self._drop: Dict[int, List[Tuple[float, float]]] = {}
        for pid, start, repair in spec.dropouts:
            end = math.inf if repair is None else start + repair
            self._drop.setdefault(pid, []).append((start, end))
        self._throttle: Dict[int, List[Tuple[float, float, float]]] = {}
        for pid, t0, t1, factor in spec.throttles:
            self._throttle.setdefault(pid, []).append((t0, t1, factor))
        self._prob = spec.straggler_prob
        self._inv_shape = (1.0 / spec.straggler_shape
                           if spec.straggler_shape > 0.0 else 0.0)

    def service(self, pid: int, now: float,
                exec_t: float) -> Tuple[float, float]:
        """Fault-adjusted ``(exec_t, stall)`` for one task delivery.

        Applied in a fixed order so every tier computes identical floats:
        straggler inflation first (one RNG draw per call when enabled),
        then throttle multipliers for windows containing ``now``, then the
        dropout stall (``inf`` for a permanent dropout). The caller adds
        ``stall`` to the task's total service time when positive.
        """
        if self._prob > 0.0:
            u = self._rng.random()
            if u < self._prob:
                # inverse-CDF Pareto(shape) multiplier >= 1, reusing the
                # trigger draw so one call costs exactly one draw
                v = u / self._prob
                if v >= 1.0:  # division rounded up to the open bound
                    v = math.nextafter(1.0, 0.0)
                exec_t *= (1.0 - v) ** (-self._inv_shape)
        windows = self._throttle.get(pid)
        if windows is not None:
            for t0, t1, factor in windows:
                if t0 <= now < t1:
                    exec_t *= factor
        stall = 0.0
        drops = self._drop.get(pid)
        if drops is not None:
            for start, end in drops:
                if start <= now < end:
                    stall = end - now
                    break
        return exec_t, stall
