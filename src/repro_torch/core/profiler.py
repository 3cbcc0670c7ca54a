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

* :class:`LaneRooflineBackend` — a lane of H100s (``gpu_lanes``): the
  reference's TPU-lane roofline, its efficiency ramp fit to the bf16
  product rates measured on the card.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from .chromosome import PlacedSubgraph
from .graph import Subgraph
from .processors import (H100_EFF_FLOOR, H100_EFF_SCALE, H100_MIN_WORK_PER_CARD,
                         Processor)


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


def fit_efficiency_ramp(rates: Sequence[Tuple[float, float]], peak: float
                        ) -> Tuple[float, float, float]:
    """(min_work_per_chip, eff_scale, eff_floor) of the lane backend's ramp
    ``min(1, work/min_work)·scale + floor`` fit to measured (FLOPs of one
    product, FLOP/s) points over ``peak``: least squares in the relative
    error, the knee searched on a log grid across the points, the floor
    kept at 0 or above."""
    work = np.array([w for w, _ in rates], dtype=np.float64)
    eff = np.array([r for _, r in rates], dtype=np.float64) / peak
    best = None
    for knee in np.geomspace(work[0], work[-1], 2000):
        a = np.stack([np.minimum(1.0, work / knee), np.ones_like(work)], axis=1) / eff[:, None]
        coef, *_ = np.linalg.lstsq(a, np.ones_like(work), rcond=None)
        if coef[1] < 0:                  # no negative rate for tiny work: floor held at 0
            coef = np.array([np.linalg.lstsq(a[:, :1], np.ones_like(work), rcond=None)[0][0], 0.0])
        err = float(np.sum((a @ coef - 1.0) ** 2))
        if best is None or err < best[0]:
            best = (err, float(knee), float(coef[0]), float(coef[1]))
    return best[1:]


@dataclass
class LaneRooflineBackend:
    """H100-lane serving cost: max(compute, memory) roofline + overheads
    (the reference's TPU-lane backend, its formula unchanged).

    Efficiency falls with lane size for small subgraphs (the work per card
    shrinks below the knee of the bf16 product's rate), which is why the
    biggest lane is not the best for every model: the paper's Table 3
    observation carried to lanes of cards. The ramp's constants are the
    card's (:func:`fit_efficiency_ramp` on the rates ``chip_smoke.py``'s
    ``lanes`` phase measured); the reference's are ``2e8``, ``0.55`` and
    ``0.05``.
    """

    lanes: Sequence[Processor]
    dtype_bytes: Tuple[Tuple[str, float], ...] = (("fp32", 4.0), ("fp16", 2.0), ("int8", 1.0))
    min_work_per_chip: float = H100_MIN_WORK_PER_CARD  # FLOPs per card below which efficiency decays
    eff_scale: float = H100_EFF_SCALE
    eff_floor: float = H100_EFF_FLOOR

    def measure(self, placed: PlacedSubgraph) -> float:
        lane = self.lanes[placed.processor]
        sg = placed.subgraph
        flops = 2.0 * sg.macs
        dbytes = dict(self.dtype_bytes)[placed.dtype]
        weight_bytes = sg.param_bytes * (dbytes / 4.0)
        # efficiency: perfect when each card has >= min_work, else linear decay
        per_chip = flops / max(lane.chips, 1)
        eff = min(1.0, per_chip / self.min_work_per_chip) * self.eff_scale + self.eff_floor
        speed = {"fp16": 1.0, "fp32": 0.5, "int8": 2.0}[placed.dtype]
        t_compute = flops / (lane.peak_flops * eff * speed)
        t_memory = weight_bytes / lane.hbm_bw
        return lane.invocation_overhead + max(t_compute, t_memory)


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
