"""PuzzleRuntime: user-facing assembly of Coordinator + Workers + Engines
(paper §5); port of ``repro.runtime.runtime``. The Tensor Pool and
Zero-Copy Shared Buffer optimizations are toggleable for the §5.3 ablation.

Two execution modes:

* **real** (default) — threads + genuine PyTorch execution of the
  executable zoo models on the card (or the CPU when the caller asks),
  wall-clock timestamps. ``int8_staging`` turns on the Worker's int8 round
  trip at every boundary input of an ``int8`` subgraph. Engines record
  per-Merkle-key execution times; :meth:`PuzzleRuntime.measured_costs`
  aggregates them into device-in-the-loop measurements for the ProfileDB
  feedback loop.
* **virtual** (``RuntimeConfig(virtual=True)`` + a ``FastSimSpec``) — no
  threads, no execution, no device: a
  :class:`~repro_torch.runtime.clock.VirtualClock` drives the very same
  Coordinator/Worker dispatch logic over the spec's cost arrays, so a run
  is a deterministic, instant replay whose task trace is bit-comparable to
  :class:`~repro_torch.core.fastsim.FastSimulator` (the runtime↔simulator
  conformance tier). It needs no card and allocates no tensor;
  ``int8_staging`` has no effect there (the spec's quant costs stand in
  for it).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

from ..core.arrivals import ArrivalSpec, arrival_horizon, draw_arrivals
from ..core.chromosome import Solution, decode_solution
from ..core.fastsim import FastSimSpec
from ..core.faults import FaultSpec
from ..core.graph import ModelGraph
from ..core.processors import Processor
from ..core.simulator import NoiseModel
from ..device import resolve_device
from .clock import SimCostSource, VirtualClock, WallClock
from .coordinator import Coordinator, RequestState
from .engine import ENGINE_REGISTRY, make_engine
from .recovery import RecoveryEvent, RecoveryPolicy, greedy_remap
from .tensorpool import SharedBufferTransport, TensorPool
from .worker import DISPATCH_TOKEN, Worker


@dataclass
class RuntimeConfig:
    tensor_pool: bool = True
    shared_buffer: bool = True
    # virtual-clock (conformance) mode: replay FastSimSpec costs on an event
    # clock instead of sleeping/executing. The noise/dispatch knobs mirror
    # the simulators' measured-evaluation parameters.
    virtual: bool = False
    noise: Optional[NoiseModel] = None
    dispatch_overhead: float = 0.0
    dispatch_pid: int = 0
    # fault ensemble injected at task delivery (virtual mode), realized by
    # the same shared FaultStream as the three simulator tiers
    faults: Optional[FaultSpec] = None
    # recovery policy: None = serve faults raw (the parity-oracle setting);
    # a RecoveryPolicy enables timeout/retry and the dropout → backup remap
    recovery: Optional[RecoveryPolicy] = None
    # quantize every boundary input of an int8 subgraph to int8 and back
    # (the int8 quantizer kernel on the card); off = the reference's path.
    # Real mode only.
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
        spec: Optional[FastSimSpec] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = config or RuntimeConfig()
        if self.cfg.virtual and spec is None:
            raise ValueError("virtual-clock mode needs a FastSimSpec "
                             "(the cost source)")
        executables = executables or {}
        if self.cfg.virtual:
            # nothing executes: no device is resolved, and the pool sits on
            # the meta device, which holds no data
            self.device = None
        else:
            self.device = resolve_device(device)
            for name, model in executables.items():
                where = getattr(model, "device", self.device)
                if torch.device(where) != self.device:
                    raise ValueError(f"executable {name!r} lives on {where}, "
                                     f"the runtime on {self.device}")
        self.placed = decode_solution(solution, graphs)
        self.spec = spec
        self.clock = VirtualClock() if self.cfg.virtual else WallClock()
        self.pool = TensorPool(enabled=self.cfg.tensor_pool,
                               device=self.device or "meta")
        self.transport = SharedBufferTransport(
            self.pool, zero_copy=self.cfg.shared_buffer
        )
        self.workers: Dict[int, Worker] = {}
        self._coordinator: Optional[Coordinator] = None
        self._closed = False
        # recovery bookkeeping (virtual mode): actions taken, dead pids,
        # optional precomputed backups per dead pid
        self.recovery_events: List[RecoveryEvent] = []
        self.measured_cost_skips = 0
        self._dead: Set[int] = set()
        self._backups: Dict[int, Tuple[Dict[Tuple[int, int], int],
                                       Optional[FastSimSpec]]] = {}

        cost_source = None
        if self.cfg.virtual:
            cost_source = SimCostSource(
                spec, processors, noise=self.cfg.noise,
                dispatch_overhead=self.cfg.dispatch_overhead,
                faults=self.cfg.faults,
            )
        self._cost_source = cost_source
        recovering = (self.cfg.virtual and self.cfg.recovery is not None)
        remapping = (recovering and self.cfg.recovery.remap
                     and cost_source.faults is not None)

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
                on_done, clock=self.clock, cost_source=cost_source,
                on_start=on_start,
                recovery=self.cfg.recovery if recovering else None,
                on_stalled=self._on_stalled if remapping else None,
                on_recovery=self._record_recovery if recovering else None,
                device=self.device, int8_staging=self.cfg.int8_staging,
            )
        self._coordinator = Coordinator(
            self.placed, self.workers, executables,
            clock=self.clock, virtual=self.cfg.virtual,
            dispatch_overhead=self.cfg.dispatch_overhead,
            dispatch_pid=self.cfg.dispatch_pid,
        )
        if remapping:
            # scheduled at init ⇒ smallest heap sequence numbers: at the
            # dropout instant the remap fires *before* any same-time
            # delivery, so no task is handed to the dead worker afterwards
            for pid, start, end in cost_source.faults.dropouts:
                if end is None and pid in self.workers:
                    self.clock.schedule(start,
                                        lambda p=pid: self._on_dropout(p))
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
        if self.cfg.virtual:
            self.clock.run()  # drain the event heap; completes synchronously
            return st.future.result(timeout=0)
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
        Virtual mode reproduces the simulators' request sources exactly —
        group sources fire at the drawn arrival times on the event clock
        and the run stops at the same quiescence horizon, so overloaded
        schedules drop the same requests the simulator drops (``makespan
        is None``).
        """
        if self.cfg.virtual:
            return self._run_sources_virtual(
                groups, periods, num_requests, arrivals)
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

    def _run_sources_virtual(
        self,
        groups: Sequence[Sequence[int]],
        periods: Sequence[float],
        num_requests: int,
        arrivals: Optional[ArrivalSpec] = None,
    ) -> List[List[RequestState]]:
        states: List[List[RequestState]] = [[] for _ in groups]
        clock = self.clock
        tables = draw_arrivals(arrivals, periods, num_requests)

        def make_source(gid: int, rid: int):
            def fire() -> None:
                states[gid].append(self.infer(groups[gid], group=gid))
                if rid + 1 < num_requests:
                    arrival = tables[gid][rid + 1]
                    # same float expression as the simulators' timeout
                    # (`now + (arrival - now)`), keeping tie-breaks identical
                    clock.schedule(arrival - clock.now(),
                                   make_source(gid, rid + 1))
            return fire

        def make_init(gid: int):
            # fires at t=0 like the simulators' source inits; a non-zero
            # first arrival schedules a timeout (same heap-sequence order),
            # a zero one issues synchronously
            def init() -> None:
                first = tables[gid][0]
                if first > clock.now():
                    clock.schedule(first - clock.now(), make_source(gid, 0))
                else:
                    make_source(gid, 0)()
            return init

        for gid in range(len(groups)):
            clock.schedule(0.0, make_init(gid))
        horizon = arrival_horizon(tables, periods, num_requests)
        clock.run(until=horizon)
        return states

    @staticmethod
    def sim_horizon(
        periods: Sequence[float],
        num_requests: int,
        arrivals: Optional[ArrivalSpec] = None,
    ) -> float:
        """The simulators' quiescence horizon, verbatim (arrival-aware)."""
        return arrival_horizon(
            draw_arrivals(arrivals, periods, num_requests),
            periods, num_requests)

    # -- fault recovery (virtual mode) --------------------------------------
    def set_backup(
        self,
        dead_pid: int,
        remap: Dict[Tuple[int, int], int],
        spec: Optional[FastSimSpec] = None,
    ) -> None:
        """Register a precomputed fallback for ``dead_pid``'s dropout.

        ``remap`` maps each ``(net, k)`` placed on ``dead_pid`` to its
        backup processor (``StaticAnalyzer.backup_mapping`` output — the
        next-best placement excluding that processor). ``spec``, when
        given, must be the backup solution's FastSimSpec: it shares the
        partition, so its rows override the primary costs for exactly the
        remapped subgraphs. Without a registered backup the runtime falls
        back to :func:`~repro_torch.runtime.recovery.greedy_remap`.
        """
        bad = [pid for pid in remap.values() if pid == dead_pid]
        if bad:
            raise ValueError(f"backup remap routes back onto dead pid "
                             f"{dead_pid}")
        self._backups[dead_pid] = (dict(remap), spec)

    def _record_recovery(self, kind: str, pid: int, detail: Dict) -> None:
        self.recovery_events.append(RecoveryEvent(
            kind=kind, time=self.clock.now(), pid=pid, detail=detail))

    def _on_dropout(self, pid: int) -> None:
        """Permanent-dropout handler: rewire placement, drain the dead queue.

        Idempotent. Re-places every subgraph owned by ``pid`` onto its
        backup processor (registered via :meth:`set_backup`, else greedy
        least-loaded), installs backup cost overrides when available, and
        redispatches the dead worker's waiting tasks through the new
        placement — in-flight requests keep running, nothing is dropped.
        A task already *executing* on ``pid`` completes (non-preemptive
        model); only queued and future work moves.
        """
        if pid in self._dead:
            return
        self._dead.add(pid)
        survivors = [q for q in self.workers if q != pid
                     and q not in self._dead]
        if not survivors:
            return  # nothing to remap onto; pid's requests will drop
        backup = self._backups.get(pid)
        if backup is not None:
            remap, bspec = backup
        else:
            load = {q: self.workers[q].busy_time for q in survivors}
            remap = greedy_remap(self.placed, pid, survivors, load=load)
            bspec = None
        for (net, k), new_pid in remap.items():
            p = self.placed[net][k]
            self.placed[net][k] = dataclasses.replace(p, processor=new_pid)
        if bspec is not None and self._cost_source is not None:
            for (net, k) in remap:
                g = bspec.offsets[net] + k
                self._cost_source.override[g] = (
                    bspec.comm[g], bspec.quant[g], bspec.exec_[g])
        moved = 0
        dead_w = self.workers[pid]
        while dead_w._vstore:
            _, payload = heapq.heappop(dead_w._vstore)
            if payload is DISPATCH_TOKEN:
                continue  # coordinator work, not tied to the dead processor
            self._coordinator.redispatch(payload)
            moved += 1
        self._record_recovery("remap", pid, {
            "subgraphs": len(remap), "requeued": moved,
            "backup": "registered" if backup is not None else "greedy",
        })

    def _on_stalled(self, pid: int, payload: Dict) -> None:
        """Worker hook: a task was delivered onto a permanently-dead pid.

        Belt-and-braces behind :meth:`_on_dropout` (which normally fires
        first and leaves nothing to stall): make sure the placement is
        rewired, then re-route the task. If no survivor exists the task is
        abandoned — the request drops exactly as the raw fault tiers drop
        it, instead of looping on the dead worker.
        """
        self._on_dropout(pid)
        if self.placed[payload["net"]][payload["sg"]].processor == pid:
            return
        self._coordinator.redispatch(payload)

    # -- measurement --------------------------------------------------------
    def measured_costs(self) -> Dict[str, float]:
        """Measured execution time per Merkle profile key.

        Aggregated over every engine execution this runtime performed (all
        workers, all requests) — the device-in-the-loop measurements that
        feed back into the :class:`~repro_torch.core.profiler.ProfileDB`.
        Per key the slowest sample is discarded when three or more exist
        and the lower median of the rest is taken — the paper's brief
        on-target execution medians repeats the same way. Empty in virtual
        mode (nothing is actually executed).

        Keys whose sample lists are empty or carry only unusable values
        (non-finite or non-positive — a worker that died mid-run, or a
        request dropped by an injected fault, leaves such holes) are skipped
        instead of raising; ``self.measured_cost_skips`` counts them.
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
            reason = "PuzzleRuntime closed"
            faults = self.cfg.faults
            if faults is not None and not faults.empty and faults.dropouts:
                # name the injected fault so a pending future's error says
                # *why* the request never finished, not just that it didn't
                descr = ", ".join(
                    f"processor {pid} dropped at t={start:g}"
                    + ("" if end is None else f" (repaired at t={end:g})")
                    for pid, start, end in faults.dropouts)
                reason += f" with injected faults: {descr}"
            self._coordinator.cancel_pending(reason)

    def __enter__(self) -> "PuzzleRuntime":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
