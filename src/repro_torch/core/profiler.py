"""Device-in-the-loop profiling with a Merkle-keyed database (paper §4.3);
copy of ``repro.core.profiler``.

The Profiler answers "how long does this *subgraph* take on this processor
with this (dtype, backend) configuration" — never by summing per-layer
times (§2.1.2 non-linearity). Results are cached in a :class:`ProfileDB`
keyed by the subgraph's Merkle hash mixed with the execution configuration,
so repeated GA evaluations across generations reuse measurements.

Backends:

* :class:`AnalyticMobileBackend` — calibrated cost model for the paper's
  Galaxy S23U processors (Tables 2–4 magnitudes). Captures non-linearity:
  fragmenting a graph loses fusion/parallelism (``fragmentation_ratio``).
* :class:`TableBackend` — reads the paper's measured model-level times
  (zoo/profiles.py) and distributes them over subgraphs MAC-proportionally
  with the fragmentation penalty; the most paper-faithful option.
* :class:`TorchExecBackend` — genuinely executes the subgraph on the card
  and times it with CUDA events: literal device-in-the-loop for the
  executable zoo models (the reference's ``JaxExecBackend``).

The reference's ``LaneRooflineBackend`` waits for the H100 processor model
(ROADMAP).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Protocol, Sequence, Tuple

import torch

from .chromosome import PlacedSubgraph
from .graph import Subgraph
from .processors import Processor


class ProfileDB:
    """Merkle-hash keyed measurement store with optional JSON persistence."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._data: Dict[str, float] = {}
        self.hits = 0
        self.misses = 0
        self.measured_updates = 0
        if path and os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)

    def get(self, key: str) -> Optional[float]:
        v = self._data.get(key)
        if v is not None:
            self.hits += 1
        return v

    def put(self, key: str, value: float) -> None:
        self.misses += 1
        self._data[key] = value

    def update(self, key: str, value: float) -> bool:
        """Overwrite a profile entry with a *measured* value (the
        device-in-the-loop feedback path); returns True when the stored
        value actually changed. Callers that depend on cached derivations
        of this entry (spec/objective caches) must invalidate them —
        ``StaticAnalyzer.apply_measured_costs`` does both."""
        old = self._data.get(key)
        self._data[key] = value
        changed = old is None or old != value
        if changed:
            self.measured_updates += 1
        return changed

    def save(self) -> None:
        if self.path:
            with open(self.path, "w") as f:
                json.dump(self._data, f)

    def __len__(self) -> int:
        return len(self._data)


class ProfilerBackend(Protocol):
    def measure(self, placed: PlacedSubgraph) -> float: ...


def fragmentation_penalty(proc: Processor, sg: Subgraph) -> float:
    """Per-MAC slowdown of a fragment vs the fully fused graph.

    Interpolates geometrically between 1.0 (whole graph as one subgraph) and
    ``proc.fragmentation_ratio`` (single-layer subgraph), mirroring the
    Σ(layers)/measured ratios of Table 4.
    """
    total = sg.graph.num_layers
    k = len(sg.layer_ids)
    if total <= 1 or k >= total:
        return 1.0
    frac = (total - k) / (total - 1)  # 0 = whole graph, 1 = single layer
    return proc.fragmentation_ratio ** frac


@dataclass
class AnalyticMobileBackend:
    """Closed-form mobile cost model calibrated against the paper's tables."""

    processors: Sequence[Processor]

    def measure(self, placed: PlacedSubgraph) -> float:
        proc = self.processors[placed.processor]
        thr = proc.thr(placed.dtype, placed.backend)
        penalty = 1.0
        if thr is None:
            # Unsupported config: fall back to the slowest supported one
            # with a large penalty (the NNAPI rows of Table 2).
            supported = [v for _, v in proc.throughput]
            thr = min(supported) if supported else 1e9
            penalty = proc.fallback_penalty
        sg = placed.subgraph
        compute = sg.macs / thr * fragmentation_penalty(proc, sg) * penalty
        # memory-bound floor: streaming weights once
        mem = sg.param_bytes / 40e9
        return proc.invocation_overhead + proc.layer_overhead * len(sg.layer_ids) + max(
            compute, mem
        )


@dataclass
class TableBackend:
    """Distributes the paper's measured model-level times over subgraphs.

    ``tables[model_name][(proc_kind, dtype, backend)] = seconds`` for the
    whole model; a subgraph gets its MAC-share with the fragmentation
    penalty, plus the processor invocation overhead. Missing configurations
    fall back to the analytic backend.
    """

    processors: Sequence[Processor]
    tables: Dict[str, Dict[Tuple[str, str, str], float]]
    fallback: Optional[ProfilerBackend] = None

    def measure(self, placed: PlacedSubgraph) -> float:
        proc = self.processors[placed.processor]
        sg = placed.subgraph
        table = self.tables.get(sg.graph.name, {})
        t_model = table.get((proc.kind, placed.dtype, placed.backend))
        if t_model is None:
            if self.fallback is None:
                raise KeyError(
                    f"no profile for {sg.graph.name} on {proc.kind}/{placed.dtype}/{placed.backend}"
                )
            return self.fallback.measure(placed)
        share = sg.macs / max(sg.graph.total_macs, 1.0)
        return (
            proc.invocation_overhead
            + t_model * share * fragmentation_penalty(proc, sg)
        )


@dataclass
class TorchExecBackend:
    """Executes the subgraph for real and times it.

    ``executables[model_name]`` must provide ``build_subgraph_fn(layer_ids,
    dtype) -> (fn, example_inputs)``; the zoo models implement this. Each
    measurement runs once to warm up, then takes the median of ``repeats``
    timed runs — the paper's brief on-device execution. On the card a run
    is timed with CUDA events on the current stream; on the CPU, which
    only a caller that built its models there gets, with the host clock.
    """

    executables: Dict[str, Any]
    repeats: int = 5
    # hardware heterogeneity emulation on a single device: relative speed
    # multipliers per processor id
    speed_scale: Optional[Dict[int, float]] = None

    def measure(self, placed: PlacedSubgraph) -> float:
        model = self.executables[placed.subgraph.graph.name]
        fn, args = model.build_subgraph_fn(placed.subgraph.layer_ids, placed.dtype)
        fn(*args)
        times = [_timed_run(fn, args) for _ in range(self.repeats)]
        t = sorted(times)[len(times) // 2]
        if self.speed_scale:
            t *= self.speed_scale.get(placed.processor, 1.0)
        return t


def _timed_run(fn, args) -> float:
    """Seconds for one ``fn(*args)``: CUDA events on a card, else the host clock."""
    if args[0].device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


class Profiler:
    """Front end: Merkle-cache + backend dispatch (Fig. 4 'Profiler')."""

    def __init__(self, backend: ProfilerBackend, db: Optional[ProfileDB] = None):
        self.backend = backend
        # NB: `db or ProfileDB()` would discard an *empty* ProfileDB
        # (len == 0 is falsy) — compare to None explicitly.
        self.db = db if db is not None else ProfileDB()

    def subgraph_time(self, placed: PlacedSubgraph) -> float:
        key = placed.profile_key()
        cached = self.db.get(key)
        if cached is not None:
            return cached
        t = self.backend.measure(placed)
        self.db.put(key, t)
        return t

    def model_time(self, placed_list: Sequence[PlacedSubgraph]) -> float:
        return sum(self.subgraph_time(p) for p in placed_list)
