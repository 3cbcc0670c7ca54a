"""Injectable clocks + simulator-fed cost source for the Puzzle Runtime.

The Runtime normally measures wall time (``WallClock``) and genuinely
executes subgraphs. For the runtime↔simulator conformance tier it instead
runs in **virtual-clock mode**: a :class:`VirtualClock` owns a
``(time, seq)``-ordered event heap that the Coordinator/Workers drive
cooperatively (single-threaded, no sleeping), and a :class:`SimCostSource`
replays the exact per-subgraph ``(comm, quant, exec)`` costs of a
:class:`~repro_torch.core.fastsim.FastSimSpec` — including the §6.3 lognormal
noise stream and the Coordinator dispatch tokens. Copy of
``repro.runtime.clock``, verbatim in its arithmetic.

Bit-for-bit parity with :class:`~repro_torch.core.fastsim.FastSimulator` rests on
two invariants this module owns:

* event ordering is ``(time, push-sequence)`` with the sequence assigned at
  push time, exactly like the simulator's heap entries — two events at one
  timestamp process in push order;
* the noise stream is one shared ``random.Random(seed).gauss`` consumed at
  task-delivery time in global delivery order, with the multiplier computed
  through ``math.exp`` (never a SIMD exp), the same draws in the same order
  as every simulator tier.
"""
from __future__ import annotations

import heapq
import math
import random
import time
from typing import Callable, List, Optional, Sequence, Tuple

from ..core.fastsim import FastSimSpec
from ..core.faults import FaultSpec, FaultStream
from ..core.processors import Processor
from ..core.simulator import NoiseModel


class WallClock:
    """Real time (the default): ``now()`` is ``time.perf_counter()``."""

    virtual = False

    def now(self) -> float:
        return time.perf_counter()


class VirtualClock:
    """Deterministic event scheduler: time advances only through events.

    ``schedule(delay, fn)`` pushes ``fn`` at ``now() + delay`` with a
    monotonically increasing sequence number; ``run(until)`` pops and fires
    events while the earliest one is at or before ``until`` (the simulator's
    horizon semantics — events scheduled past the horizon never fire, which
    is how overload scenarios drop requests).
    """

    virtual = True

    def __init__(self) -> None:
        self._now = 0.0
        self._events: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0

    def now(self) -> float:
        return self._now

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        # the sum below is the only place the fire time is computed, so a
        # caller passing `arrival - now` reproduces the simulator's
        # `now + (arrival - now)` float expression exactly
        heapq.heappush(self._events, (self._now + delay, self._seq, fn))
        self._seq += 1

    def run(self, until: Optional[float] = None) -> None:
        """Fire events in ``(time, seq)`` order; stop past ``until``."""
        while self._events and (until is None or self._events[0][0] <= until):
            t, _, fn = heapq.heappop(self._events)
            self._now = t
            fn()

    @property
    def pending(self) -> int:
        return len(self._events)


class SimCostSource:
    """Per-subgraph costs + noise for virtual execution, from a FastSimSpec.

    The spec must be the same cost arrays the simulator under comparison
    uses (``StaticAnalyzer.solution_spec`` / ``build_spec``) — conformance
    is about *scheduling* semantics, so both sides replay identical costs.
    """

    def __init__(
        self,
        spec: FastSimSpec,
        processors: Sequence[Processor],
        noise: Optional[NoiseModel] = None,
        dispatch_overhead: float = 0.0,
        faults: Optional[FaultSpec] = None,
    ):
        self.spec = spec
        self.dispatch_overhead = dispatch_overhead
        self.noise = noise
        # fault ensemble realized at delivery time (empty → clean path);
        # one shared stream across all workers, same as the noise stream
        self.faults = None if faults is None or faults.empty else faults
        self.fault_stream = (FaultStream(self.faults)
                             if self.faults is not None else None)
        # same construction as the simulators: seed 0 when no noise, and one
        # shared stream across all workers consumed in delivery order
        self._rng_gauss = random.Random(noise.seed if noise else 0).gauss
        n_pid = max(p.pid for p in processors) + 1
        self._sigma_of = [0.0] * n_pid
        for p in processors:
            self._sigma_of[p.pid] = noise.sigma(p.kind) if noise else 0.0
        # per-flat-subgraph cost overrides, installed by the runtime's
        # dropout recovery: a backup solution shares the partition, so its
        # FastSimSpec rows index identically and can replace the primary's
        # costs for exactly the remapped subgraphs
        self.override: dict = {}

    def costs(self, net: int, k: int) -> Tuple[float, float, float]:
        g = self.spec.offsets[net] + k
        ov = self.override.get(g)
        if ov is not None:
            return ov
        return self.spec.comm[g], self.spec.quant[g], self.spec.exec_[g]

    def noisy_exec(self, pid: int, exec_t: float) -> float:
        """Apply the mean-1 lognormal fluctuation draw (§6.3), bit-identical
        to the simulators' ``exp(gauss(-0.5·σ², σ))`` expression."""
        sigma = self._sigma_of[pid]
        if sigma > 0.0:
            exec_t *= math.exp(self._rng_gauss(-0.5 * sigma * sigma, sigma))
        return exec_t
