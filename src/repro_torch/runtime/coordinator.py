"""Coordinator: the Runtime's external interface (paper §5.2, Fig. 9); copy
of ``repro.runtime.coordinator``, real-execution mode.

Workflow: ① client request enters the queue → ② the coordinator finds
subgraphs with resolved dependencies → ③ tasks go to Worker queues →
④ Workers (de)quantize + execute → ⑤ results update request state →
⑥ the final result returns to the client (a Future).

All timestamps come from an injectable clock (wall time by default), and
every released task gets a :class:`~repro_torch.core.simulator.TaskRecord`
appended to ``self.trace`` in release order — the same schema and ordering
the simulators produce. Tasks enter Worker queues with priority
``(0, network-priority, release-seq)``. The virtual-clock mode's dispatch
tokens and the recovery path's ``redispatch`` come with the virtual-clock
runtime (ROADMAP Queue 1, slice 6b).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.chromosome import PlacedSubgraph
from ..core.simulator import TaskRecord
from .clock import WallClock
from .worker import Worker


@dataclass
class RequestState:
    request_id: int
    group: int
    networks: List[int]
    submitted: float
    future: Future = field(default_factory=Future)
    remaining: int = 0
    total_tasks: int = 0
    group_request: int = 0            # per-group request index (rid)
    outputs: Dict[Tuple[int, int], Any] = field(default_factory=dict)
    pending_deps: Dict[Tuple[int, int], int] = field(default_factory=dict)
    first_start: Optional[float] = None
    last_finish: float = 0.0
    finish: Optional[float] = None
    task_records: List[Dict] = field(default_factory=list)

    @property
    def done_tasks(self) -> int:
        return self.total_tasks - self.remaining

    @property
    def makespan(self) -> Optional[float]:
        if self.finish is None:
            return None
        return self.finish - self.submitted


class Coordinator:
    """Dependency-resolving dispatcher over per-processor Workers."""

    def __init__(
        self,
        placed: Sequence[Sequence[PlacedSubgraph]],
        workers: Dict[int, Worker],
        executables: Dict[str, Any],
        clock=None,
    ):
        self.placed = placed
        self.workers = workers
        self.executables = executables
        self.clock = clock if clock is not None else WallClock()
        self._lock = threading.Lock()
        self._requests: Dict[int, RequestState] = {}
        self._next_id = 0
        self._seq = 0                      # release sequence (queue keys)
        self._group_counts: Dict[int, int] = {}
        self.trace: List[TaskRecord] = []  # all released tasks, release order
        # static dependency structure + engine pre-loading (Initialization)
        self._deps: List[List[List[int]]] = []
        self._succs: List[List[List[int]]] = []
        self._owner: List[Dict[int, int]] = []
        for plist in placed:
            owner: Dict[int, int] = {}
            for k, p in enumerate(plist):
                for lid in p.subgraph.layer_ids:
                    owner[lid] = k
            deps = [sorted({owner[e.src] for e in p.subgraph.in_cut_edges()})
                    for p in plist]
            succs: List[List[int]] = [[] for _ in plist]
            for k, d in enumerate(deps):
                for pr in d:
                    succs[pr].append(k)
            self._deps.append(deps)
            self._succs.append(succs)
            self._owner.append(owner)
        for plist in placed:
            for p in plist:
                w = workers[p.processor]
                eng = w.engines[p.backend]
                eng.load(p, executables)

    # -- client API ------------------------------------------------------------
    def submit(self, networks: Sequence[int], group: int = 0) -> RequestState:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            grid = self._group_counts.get(group, 0)
            self._group_counts[group] = grid + 1
            st = RequestState(
                request_id=rid, group=group, networks=list(networks),
                submitted=self.clock.now(), group_request=grid,
            )
            st.remaining = sum(len(self.placed[n]) for n in networks)
            st.total_tasks = st.remaining
            for n in networks:
                for k, d in enumerate(self._deps[n]):
                    st.pending_deps[(n, k)] = len(d)
            self._requests[rid] = st
        for n in networks:
            for k, d in enumerate(self._deps[n]):
                if not d:
                    self._dispatch(st, n, k)
        return st

    def cancel_pending(self, reason: str = "PuzzleRuntime closed") -> int:
        """Fail every unfinished request's future; returns how many."""
        cancelled = 0
        with self._lock:
            states = list(self._requests.values())
        for st in states:
            if not st.future.done():
                st.future.set_exception(RuntimeError(reason))
                cancelled += 1
        return cancelled

    # -- internal -----------------------------------------------------------
    def _dispatch(self, st: RequestState, net: int, k: int) -> None:
        p = self.placed[net][k]
        inputs = None
        if self._deps[net][k]:
            inputs = []
            for pk in self._deps[net][k]:
                prod = self.placed[net][pk]
                out = st.outputs[(net, pk)]
                first = out[0] if isinstance(out, tuple) else out
                inputs.append((first, prod.dtype))
            # boundary inputs must match the subgraph arity; replicate the
            # producer output for multi-input boundaries (the model caches
            # its (fn, example), so this allocates nothing)
            model = self.executables[p.subgraph.graph.name]
            _, example = model.build_subgraph_fn(p.subgraph.layer_ids, p.dtype)
            while len(inputs) < len(example):
                inputs.append(inputs[-1])
            inputs = inputs[: len(example)]
        now = self.clock.now()
        rec = TaskRecord(
            group=st.group, request=st.group_request, network=net, sg_index=k,
            processor=p.processor, released=now,
        )
        with self._lock:
            self.trace.append(rec)
            self._seq += 1
            seq = self._seq
        payload = {
            "request": st.request_id,
            "net": net,
            "sg": k,
            "dtype": p.dtype,
            "backend": p.backend,
            "engine_key": p.profile_key(),
            "inputs": inputs,
            "released": now,
            "record": rec,
        }
        self.workers[p.processor].submit((0, p.priority, seq), payload)

    def on_task_start(self, payload: Dict) -> None:
        """Worker hook at execution start: stamp the record + request."""
        with self._lock:
            st = self._requests[payload["request"]]
            started = payload["started"]
            if st.first_start is None or started < st.first_start:
                st.first_start = started
            rec: TaskRecord = payload["record"]
            rec.started = started
            rec.comm_time = payload.get("comm_s", 0.0)
            rec.quant_time = payload.get("quant_s", 0.0)
            rec.exec_time = payload.get("exec_s", 0.0)

    def on_task_done(self, payload: Dict, result: Any, quant_t: float,
                     exec_t: float) -> None:
        rid, net, k = payload["request"], payload["net"], payload["sg"]
        ready: List[Tuple[RequestState, int, int]] = []
        with self._lock:
            st = self._requests[rid]
            if isinstance(result, Exception):
                if not st.future.done():
                    st.future.set_exception(result)
                return
            now = self.clock.now()
            rec: TaskRecord = payload["record"]
            rec.finished = now
            # quant time is only known at completion
            rec.quant_time = quant_t
            rec.exec_time = payload.get("exec_s", exec_t)
            st.outputs[(net, k)] = result
            st.remaining -= 1
            if now > st.last_finish:
                st.last_finish = now
            st.task_records.append({
                "net": net, "sg": k, "quant_s": quant_t, "exec_s": exec_t,
                "wait_s": rec.started - payload["released"],
            })
            for s in self._succs[net][k]:
                st.pending_deps[(net, s)] -= 1
                if st.pending_deps[(net, s)] == 0:
                    ready.append((st, net, s))
            done = st.remaining == 0
            if done:
                st.finish = now
        for st2, n2, k2 in ready:
            self._dispatch(st2, n2, k2)
        if done and not st.future.done():
            st.future.set_result(st)
