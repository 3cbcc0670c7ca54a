"""PuzzleRuntime: user-facing assembly of Coordinator + Workers + Engines
(paper §5); port of ``repro.runtime.runtime``, real-execution mode.

Threads + genuine PyTorch execution of the executable zoo models on the
card (or the CPU when the caller asks), wall-clock timestamps. The Tensor
Pool and Zero-Copy Shared Buffer optimizations are toggleable for the
§5.3 ablation, and ``int8_staging`` turns on the Worker's int8 round trip
at every boundary input of an ``int8`` subgraph. Engines record
per-Merkle-key execution times; :meth:`PuzzleRuntime.measured_costs`
aggregates them into device-in-the-loop measurements for the ProfileDB
feedback loop.

The reference's virtual-clock mode, fault injection and recovery come
with the virtual-clock runtime (ROADMAP Queue 1, slice 6); asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from ..core.arrivals import ArrivalSpec, draw_arrivals
from ..core.chromosome import Solution, decode_solution
from ..core.graph import ModelGraph
from ..core.processors import Processor
from ..device import resolve_device
from .clock import WallClock
from .coordinator import Coordinator, RequestState
from .engine import ENGINE_REGISTRY, make_engine
from .tensorpool import SharedBufferTransport, TensorPool
from .worker import Worker

_LATER = "comes with the virtual-clock runtime (ROADMAP Queue 1, slice 6)"


@dataclass
class RuntimeConfig:
    tensor_pool: bool = True
    shared_buffer: bool = True
    # the reference's virtual-clock (conformance) mode, fault ensemble and
    # recovery policy: not ported yet, so setting any of them raises
    virtual: bool = False
    faults: Optional[Any] = None
    recovery: Optional[Any] = None
    # quantize every boundary input of an int8 subgraph to int8 and back
    # (the int8 quantizer kernel on the card); off = the reference's path
    int8_staging: bool = False


class PuzzleRuntime:
    """Executes a Static Analyzer solution against real (reduced) models."""

    def __init__(
        self,
        graphs: Sequence[ModelGraph],
        solution: Solution,
        processors: Sequence[Processor],
        executables: Optional[Dict[str, Any]] = None,
        config: Optional[RuntimeConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = config or RuntimeConfig()
        if self.cfg.virtual:
            raise NotImplementedError(f"virtual-clock mode {_LATER}")
        if self.cfg.faults is not None or self.cfg.recovery is not None:
            raise NotImplementedError(f"fault injection and recovery {_LATER}")
        self.device = resolve_device(device)
        executables = executables or {}
        for name, model in executables.items():
            where = getattr(model, "device", self.device)
            if torch.device(where) != self.device:
                raise ValueError(f"executable {name!r} lives on {where}, "
                                 f"the runtime on {self.device}")
        self.placed = decode_solution(solution, graphs)
        self.clock = WallClock()
        self.pool = TensorPool(enabled=self.cfg.tensor_pool, device=self.device)
        self.transport = SharedBufferTransport(
            self.pool, zero_copy=self.cfg.shared_buffer
        )
        self.workers: Dict[int, Worker] = {}
        self._coordinator: Optional[Coordinator] = None
        self._closed = False
        self.measured_cost_skips = 0

        def on_done(payload, result, quant_t, exec_t):
            assert self._coordinator is not None
            self._coordinator.on_task_done(payload, result, quant_t, exec_t)

        def on_start(payload):
            assert self._coordinator is not None
            self._coordinator.on_task_start(payload)

        for proc in processors:
            engines = {name: make_engine(name) for name in ENGINE_REGISTRY}
            self.workers[proc.pid] = Worker(
                proc.pid, proc.name, engines, self.pool, self.transport,
                on_done, clock=self.clock, on_start=on_start,
                device=self.device, int8_staging=self.cfg.int8_staging,
            )
        self._coordinator = Coordinator(
            self.placed, self.workers, executables, clock=self.clock,
        )
        for w in self.workers.values():
            w.start()

    @property
    def coordinator(self) -> Coordinator:
        return self._coordinator

    # -- serving ------------------------------------------------------------
    def infer(self, networks: Sequence[int], group: int = 0) -> RequestState:
        if self._closed:
            raise RuntimeError("PuzzleRuntime is closed")
        return self._coordinator.submit(networks, group)

    def infer_sync(self, networks: Sequence[int], timeout: float = 60.0
                   ) -> RequestState:
        st = self.infer(networks)
        return st.future.result(timeout=timeout)

    def run_periodic(
        self,
        groups: Sequence[Sequence[int]],
        periods: Sequence[float],
        num_requests: int = 10,
        timeout: float = 120.0,
        arrivals: Optional[ArrivalSpec] = None,
    ) -> List[List[RequestState]]:
        """Drive the request sources per model group; returns states per group.

        ``arrivals`` selects the arrival process (``None`` = periodic, the
        paper's sources); all processes draw their timestamps from the
        shared :func:`~repro_torch.core.arrivals.draw_arrivals` generator.
        """
        tables = draw_arrivals(arrivals, periods, num_requests)
        states: List[List[RequestState]] = [[] for _ in groups]
        t0 = time.perf_counter()
        issued = [0] * len(groups)
        total = num_requests * len(groups)
        while sum(issued) < total:
            now = time.perf_counter() - t0
            soonest = None
            for g in range(len(groups)):
                if issued[g] >= num_requests:
                    continue
                due = tables[g][issued[g]]
                if due <= now:
                    states[g].append(self.infer(groups[g], group=g))
                    issued[g] += 1
                else:
                    soonest = min(soonest, due) if soonest is not None else due
            if soonest is not None:
                sleep = soonest - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(min(sleep, 0.01))
        deadline = time.perf_counter() + timeout
        for glist in states:
            for st in glist:
                st.future.result(timeout=max(0.1, deadline - time.perf_counter()))
        return states

    # -- measurement --------------------------------------------------------
    def measured_costs(self) -> Dict[str, float]:
        """Measured execution time per Merkle profile key.

        Aggregated over every engine execution this runtime performed (all
        workers, all requests) — the device-in-the-loop measurements that
        feed back into the :class:`~repro_torch.core.profiler.ProfileDB`.
        Per key the slowest sample is discarded when three or more exist
        and the lower median of the rest is taken — the paper's brief
        on-target execution medians repeats the same way.

        Keys whose sample lists are empty or carry only unusable values
        (non-finite or non-positive) are skipped instead of raising;
        ``self.measured_cost_skips`` counts them.
        """
        per_key: Dict[str, List[float]] = {}
        for w in self.workers.values():
            for eng in w.engines.values():
                for key, ts in eng.exec_times.items():
                    per_key.setdefault(key, []).extend(ts)
        out: Dict[str, float] = {}
        self.measured_cost_skips = 0
        for key, ts in per_key.items():
            ts = sorted(t for t in ts
                        if t is not None and math.isfinite(t) and t > 0.0)
            if not ts:
                self.measured_cost_skips += 1
                continue
            if len(ts) > 2:
                ts = ts[:-1]
            out[key] = ts[(len(ts) - 1) // 2]
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "pool": self.pool.stats.__dict__,
            "transport": self.transport.stats.__dict__,
            "workers": {
                pid: {"busy_s": w.busy_time, "tasks": w.tasks_done}
                for pid, w in self.workers.items()
            },
        }

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Stop and join worker threads, drain queues, fail pending futures.

        Idempotent; safe mid-request (the stop sentinel outranks queued
        tasks). After close no worker thread is alive and every unfinished
        request's future carries a ``RuntimeError``.
        """
        if self._closed:
            return
        self._closed = True
        for w in self.workers.values():
            w.stop(join=True)
        if self._coordinator is not None:
            self._coordinator.cancel_pending("PuzzleRuntime closed")

    def __enter__(self) -> "PuzzleRuntime":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
