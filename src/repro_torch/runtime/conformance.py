"""Runtime↔simulator conformance: trace extraction, diffing, reporting.

The paper's accuracy claim is *device-in-the-loop* evaluation — predicted
schedules are validated by actually executing them (§4.2/§5). This module
closes that loop for the repo's engine stack: it runs a schedule on
:class:`~repro_torch.runtime.PuzzleRuntime`, extracts a task trace in the exact
schema of the committed golden traces (``tests/golden/``), and diffs it
against a simulator run of the same schedule.

Two conformance regimes:

* **virtual** — the runtime replays :class:`~repro_torch.core.fastsim.FastSimSpec`
  costs on a virtual clock; the comparison is at **zero tolerance** (every
  release/start/finish timestamp, every makespan, the busy times and the
  task ordering must match the simulator bit for bit).
* **real** — the runtime genuinely executes the models with wall-clock
  timing (on the card unless the caller asks for the CPU); thread
  scheduling makes exact ordering unreproducible, so the comparison is
  **bounded relative error** on per-request makespans.

Entry point for users: ``StaticAnalyzer.validate_on_runtime``. Copy of
``repro.runtime.conformance``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.arrivals import ArrivalSpec
from ..core.chromosome import Solution
from ..core.fastsim import FastSimSpec
from ..core.faults import FaultSpec
from ..core.graph import ModelGraph
from ..core.processors import Processor
from ..core.simulator import NoiseModel, RequestRecord, SimResult, TaskRecord
from .runtime import PuzzleRuntime, RuntimeConfig


def serialize_result(res: SimResult) -> Dict[str, object]:
    """Golden-trace schema (``tests/golden/*.json``) of a SimResult.

    Single source of truth for the schema: the golden-trace tests, the
    conformance reports and the CI artifacts all serialize through here.
    """
    return {
        "horizon": res.horizon,
        "busy_time": {str(pid): t for pid, t in sorted(res.busy_time.items())},
        "requests": [
            [r.group, r.request, r.arrival, r.first_start, r.last_finish,
             r.done_tasks, r.total_tasks]
            for r in res.requests
        ],
        "makespans": [
            None if math.isinf(r.makespan) else r.makespan
            for r in res.requests
        ],
        "tasks": [
            [t.group, t.request, t.network, t.sg_index, t.processor,
             t.released, t.started, t.finished,
             t.comm_time, t.quant_time, t.exec_time]
            for t in res.tasks
        ],
    }


def runtime_result(
    runtime: PuzzleRuntime,
    states: Sequence[Sequence[object]],
    periods: Sequence[float],
    num_requests: int,
    rebase: bool = False,
    arrivals: Optional[ArrivalSpec] = None,
) -> SimResult:
    """Build a simulator-comparable :class:`SimResult` from a runtime run.

    ``states`` is ``run_periodic``'s return value (request states per
    group). With ``rebase`` (real-exec mode) all wall-clock timestamps
    (``time.perf_counter`` seconds from the runtime's ``WallClock``) are
    shifted so the earliest submission is t=0, making them comparable to
    simulated time.
    """
    t0 = 0.0
    if rebase:
        submits = [st.submitted for glist in states for st in glist]
        t0 = min(submits) if submits else 0.0

    requests: List[RequestRecord] = []
    for gid, glist in enumerate(states):
        for rid, st in enumerate(glist):
            requests.append(RequestRecord(
                group=gid, request=rid, arrival=st.submitted - t0,
                first_start=(float("inf") if st.first_start is None
                             else st.first_start - t0),
                last_finish=(st.last_finish - t0 if st.last_finish else 0.0),
                done_tasks=st.done_tasks, total_tasks=st.total_tasks,
            ))
    tasks: List[TaskRecord] = []
    for rec in runtime.coordinator.trace:
        if rebase:
            rec = TaskRecord(
                group=rec.group, request=rec.request, network=rec.network,
                sg_index=rec.sg_index, processor=rec.processor,
                released=rec.released - t0,
                started=rec.started - t0 if rec.started else 0.0,
                finished=rec.finished - t0 if rec.finished else 0.0,
                comm_time=rec.comm_time, exec_time=rec.exec_time,
                quant_time=rec.quant_time,
            )
        tasks.append(rec)
    return SimResult(
        requests=sorted(requests, key=lambda r: (r.group, r.request)),
        tasks=tasks,
        busy_time={pid: w.busy_time for pid, w in runtime.workers.items()},
        horizon=PuzzleRuntime.sim_horizon(periods, num_requests,
                                          arrivals=arrivals),
    )


def run_virtual_schedule(
    graphs: Sequence[ModelGraph],
    solution: Solution,
    processors: Sequence[Processor],
    spec: FastSimSpec,
    groups: Sequence[Sequence[int]],
    periods: Sequence[float],
    num_requests: int,
    noise: Optional[NoiseModel] = None,
    dispatch_overhead: float = 0.0,
    dispatch_pid: int = 0,
    arrivals: Optional[ArrivalSpec] = None,
    faults: Optional[FaultSpec] = None,
) -> SimResult:
    """Execute a schedule on the virtual-clock runtime; return its trace.

    This is the fourth engine tier: the *actual* Coordinator/Worker
    dispatch code, replaying the spec's costs deterministically. The result
    is bit-comparable to ``FastSimulator(spec, ...).run(collect_tasks=True)``
    with the same parameters (including the ``arrivals`` process and the
    ``faults`` ensemble — injected raw, with no recovery policy, which is
    the parity-oracle setting).
    """
    rt = PuzzleRuntime(
        graphs, solution, processors,
        config=RuntimeConfig(
            virtual=True, noise=noise,
            dispatch_overhead=dispatch_overhead, dispatch_pid=dispatch_pid,
            faults=faults,
        ),
        spec=spec,
    )
    with rt:
        states = rt.run_periodic(groups, periods, num_requests=num_requests,
                                 arrivals=arrivals)
        return runtime_result(rt, states, periods, num_requests,
                              arrivals=arrivals)


@dataclass
class ConformanceReport:
    """Outcome of one runtime↔simulator conformance run."""

    mode: str                          # "virtual" | "real"
    rel_tol: float
    runtime_tasks: int
    sim_tasks: int
    ordering_match: bool               # identical task release sequences
    max_release_diff: float
    max_start_diff: float
    max_finish_diff: float
    max_makespan_diff: float           # abs; inf when only one side dropped
    max_makespan_rel_err: float
    max_busy_diff: float
    passed: bool
    runtime_trace: Dict[str, object]   # golden-trace schema
    sim_trace: Dict[str, object]

    def summary(self) -> Dict[str, float]:
        """JSON-safe scalar summary (for sweep results / CI artifacts)."""
        def _f(v: float) -> Optional[float]:
            return None if math.isinf(v) else v
        return {
            "mode": self.mode,
            "runtime_tasks": self.runtime_tasks,
            "sim_tasks": self.sim_tasks,
            "ordering_match": bool(self.ordering_match),
            "max_release_diff": _f(self.max_release_diff),
            "max_start_diff": _f(self.max_start_diff),
            "max_finish_diff": _f(self.max_finish_diff),
            "max_makespan_diff": _f(self.max_makespan_diff),
            "max_makespan_rel_err": _f(self.max_makespan_rel_err),
            "max_busy_diff": _f(self.max_busy_diff),
            "passed": bool(self.passed),
        }

    def to_json(self, include_traces: bool = True) -> Dict[str, object]:
        doc: Dict[str, object] = dict(self.summary())
        if include_traces:
            doc["runtime_trace"] = self.runtime_trace
            doc["sim_trace"] = self.sim_trace
        return doc


def _task_key(t: TaskRecord) -> Tuple[int, int, int, int]:
    return (t.group, t.request, t.network, t.sg_index)


def build_report(
    mode: str,
    runtime_res: SimResult,
    sim_res: SimResult,
    rel_tol: float = 0.0,
) -> ConformanceReport:
    """Diff a runtime trace against a simulator trace.

    Virtual mode (``rel_tol = 0``) passes only on an exact match: same
    release ordering, zero max-abs diff on every release/start/finish
    timestamp, identical makespans (dropped requests must be dropped on
    both sides) and identical busy times. Real mode passes when per-request
    makespans agree within ``rel_tol`` relative error and both sides
    release the same task set (ordering is reported but not enforced —
    thread scheduling is not reproducible).
    """
    order_rt = [(t.group, t.request, t.network, t.sg_index, t.processor)
                for t in runtime_res.tasks]
    order_sim = [(t.group, t.request, t.network, t.sg_index, t.processor)
                 for t in sim_res.tasks]
    ordering_match = order_rt == order_sim

    by_key_rt = {_task_key(t): t for t in runtime_res.tasks}
    by_key_sim = {_task_key(t): t for t in sim_res.tasks}
    same_tasks = set(by_key_rt) == set(by_key_sim)
    rel_diff = 0.0
    start_diff = 0.0
    finish_diff = 0.0
    for key in set(by_key_rt) & set(by_key_sim):
        a, b = by_key_rt[key], by_key_sim[key]
        rel_diff = max(rel_diff, abs(a.released - b.released))
        start_diff = max(start_diff, abs(a.started - b.started))
        finish_diff = max(finish_diff, abs(a.finished - b.finished))

    ms_diff = 0.0
    ms_rel = 0.0
    req_rt = {(r.group, r.request): r for r in runtime_res.requests}
    req_sim = {(r.group, r.request): r for r in sim_res.requests}
    for key in set(req_rt) | set(req_sim):
        a, b = req_rt.get(key), req_sim.get(key)
        if a is None or b is None:
            ms_diff = ms_rel = float("inf")
            continue
        ma, mb = a.makespan, b.makespan
        if math.isinf(ma) and math.isinf(mb):
            continue
        if math.isinf(ma) or math.isinf(mb):
            ms_diff = ms_rel = float("inf")
            continue
        ms_diff = max(ms_diff, abs(ma - mb))
        if mb > 0:
            ms_rel = max(ms_rel, abs(ma - mb) / mb)

    busy_diff = 0.0
    for pid in set(runtime_res.busy_time) | set(sim_res.busy_time):
        busy_diff = max(busy_diff, abs(
            runtime_res.busy_time.get(pid, 0.0)
            - sim_res.busy_time.get(pid, 0.0)))

    if mode == "virtual":
        passed = (
            ordering_match and same_tasks
            and rel_diff == 0.0 and start_diff == 0.0 and finish_diff == 0.0
            and ms_diff == 0.0 and busy_diff == 0.0
        )
    else:
        passed = same_tasks and ms_rel <= rel_tol

    return ConformanceReport(
        mode=mode,
        rel_tol=rel_tol,
        runtime_tasks=len(runtime_res.tasks),
        sim_tasks=len(sim_res.tasks),
        ordering_match=ordering_match,
        max_release_diff=rel_diff,
        max_start_diff=start_diff,
        max_finish_diff=finish_diff,
        max_makespan_diff=ms_diff,
        max_makespan_rel_err=ms_rel,
        max_busy_diff=busy_diff,
        passed=passed,
        runtime_trace=serialize_result(runtime_res),
        sim_trace=serialize_result(sim_res),
    )
