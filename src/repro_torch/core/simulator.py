"""Discrete-event simulation of the Puzzle Runtime (paper §4.3 'Simulator').

Replays the Coordinator → Worker → Engine workflow of §5.2 over a candidate
solution: per-group request sources (periodic by default; any
:class:`~repro_torch.core.arrivals.ArrivalSpec` process), subgraph tasks released
when their dependencies resolve, per-processor non-preemptive workers
draining priority queues, communication costs at processor boundaries and
(de)quantization at dtype boundaries.

Computation costs come from the device-in-the-loop :class:`Profiler`;
communication from the piecewise-linear comm model (§4.1).

Copy of ``repro.core.simulator``, verbatim in its arithmetic.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, Generator, List, Optional, Sequence, Tuple

from .arrivals import ArrivalSpec, arrival_horizon, draw_arrivals
from .chromosome import PlacedSubgraph
from .comm import PiecewiseLinearCommModel, quantization_cost
from .des import Environment, PriorityStore
from .faults import FaultSpec, FaultStream
from .processors import Processor
from .profiler import Profiler


def derive_dependencies(
    placed: Sequence[Sequence[PlacedSubgraph]],
) -> Tuple[List[List[List[int]]], List[List[List[int]]], List[Dict[int, int]]]:
    """Static per-network dependency structure over subgraphs.

    Returns ``(deps, succs, owner)`` where ``deps[net][k]`` lists producer
    subgraph ids of subgraph ``k``, ``succs`` is the reverse relation, and
    ``owner[net]`` maps layer id -> owning subgraph index. Shared by the
    reference DES (:class:`RuntimeSimulator`) and the fast array engine
    (:mod:`repro_torch.core.fastsim`) so both see identical structure.
    """
    all_deps: List[List[List[int]]] = []
    all_succs: List[List[List[int]]] = []
    owners: List[Dict[int, int]] = []
    for net_placed in placed:
        owner: Dict[int, int] = {}
        for k, p in enumerate(net_placed):
            for lid in p.subgraph.layer_ids:
                owner[lid] = k
        deps: List[List[int]] = [[] for _ in net_placed]
        succs: List[List[int]] = [[] for _ in net_placed]
        for k, p in enumerate(net_placed):
            prods = sorted({owner[e.src] for e in p.subgraph.in_cut_edges()})
            deps[k] = prods
            for pr in prods:
                succs[pr].append(k)
        all_deps.append(deps)
        all_succs.append(succs)
        owners.append(owner)
    return all_deps, all_succs, owners


def subgraph_task_costs(
    placed: Sequence[Sequence[PlacedSubgraph]],
    net: int,
    k: int,
    owner: Dict[int, int],
    has_deps: bool,
    profiler: Profiler,
    comm_model: PiecewiseLinearCommModel,
    input_home_pid: int,
    exec_cache: Optional[Dict] = None,
    exec_key: Optional[Tuple] = None,
    in_cut: Optional[Sequence] = None,
) -> Tuple[float, float, float]:
    """(comm, quant, exec) seconds for subgraph ``k`` of network ``net``.

    Float operations happen in a fixed order so the reference and fast
    engines compute bit-identical costs. ``exec_cache``/``exec_key`` let the
    fast path memoize the profiler lookup (Merkle hashing dominates it) and
    ``in_cut`` lets it supply the subgraph's precomputed boundary edges; the
    profiler is deterministic per key and the edge list is a pure function
    of the subgraph, so cached values are identical.
    """
    p = placed[net][k]
    comm = 0.0
    quant = 0.0
    if in_cut is None:
        in_cut = p.subgraph.in_cut_edges()
    for e in in_cut:
        prod = placed[net][owner[e.src]]
        if prod.processor != p.processor:
            comm += comm_model.cost(e.bytes_)
        if prod.dtype != p.dtype:
            quant += quantization_cost(e.bytes_, comm_model.bandwidth)
    if not has_deps:
        # model input arrives at the input home processor
        in_bytes = p.subgraph.input_bytes()
        if p.processor != input_home_pid:
            comm += comm_model.cost(in_bytes)
    if exec_cache is not None:
        exec_t = exec_cache.get(exec_key)
        if exec_t is None:
            exec_t = profiler.subgraph_time(p)
            exec_cache[exec_key] = exec_t
    else:
        exec_t = profiler.subgraph_time(p)
    return comm, quant, exec_t


@dataclass(frozen=True)
class NoiseModel:
    """Execution-time fluctuation per processor kind (§6.3).

    The paper observes large run-to-run variance, worst on the CPU (which
    also runs the scheduler/dispatcher and system tasks) and small on the
    NPU. Samples are lognormal multipliers around 1.0. The *fast* simulator
    runs clean (the paper's SimPy model is deterministic too); the
    *measurement* evaluation applies noise — that is the device-in-the-loop
    distinction that let Puzzle reject fluctuation-sensitive solutions.
    """

    sigma_by_kind: Tuple[Tuple[str, float], ...] = (
        ("cpu", 0.22), ("gpu", 0.07), ("npu", 0.03), ("tpu-lane", 0.02),
    )
    seed: int = 0

    def sigma(self, kind: str) -> float:
        for k, s in self.sigma_by_kind:
            if k == kind:
                return s
        return 0.05


@dataclass
class TaskRecord:
    """Execution trace of one subgraph instance."""

    group: int
    request: int
    network: int
    sg_index: int
    processor: int
    released: float = 0.0
    started: float = 0.0
    finished: float = 0.0
    comm_time: float = 0.0
    exec_time: float = 0.0
    quant_time: float = 0.0


@dataclass
class RequestRecord:
    group: int
    request: int
    arrival: float
    first_start: float = float("inf")
    last_finish: float = 0.0
    done_tasks: int = 0
    total_tasks: int = 0

    @property
    def makespan(self) -> float:
        # Θ = max_m T_f − min_m T_s (paper §6.2); T_s is the first actual
        # execution start among the group's models.
        if self.done_tasks < self.total_tasks:
            return float("inf")  # unfinished request at horizon = dropped frame
        return self.last_finish - min(self.first_start, self.arrival)


@dataclass
class SimResult:
    requests: List[RequestRecord]
    tasks: List[TaskRecord]
    busy_time: Dict[int, float]
    horizon: float

    def makespans(self, group: Optional[int] = None) -> List[float]:
        return [
            r.makespan
            for r in self.requests
            if group is None or r.group == group
        ]

    def utilization(self, pid: int) -> float:
        return self.busy_time.get(pid, 0.0) / max(self.horizon, 1e-12)


class RuntimeSimulator:
    """Simulates one scenario execution for a decoded solution."""

    def __init__(
        self,
        placed: Sequence[Sequence[PlacedSubgraph]],   # per network
        processors: Sequence[Processor],
        profiler: Profiler,
        comm_model: PiecewiseLinearCommModel,
        groups: Sequence[Sequence[int]],              # per group: network ids
        periods: Sequence[float],                     # per group
        num_requests: int = 20,
        input_home_pid: int = 0,
        overlap_comm: bool = False,
        noise: Optional[NoiseModel] = None,
        dispatch_overhead: float = 0.0,
        dispatch_pid: int = 0,
        arrivals: Optional[ArrivalSpec] = None,
        faults: Optional[FaultSpec] = None,
    ):
        self.placed = placed
        self.processors = processors
        self.profiler = profiler
        self.comm = comm_model
        self.groups = groups
        self.periods = periods
        self.num_requests = num_requests
        self.input_home_pid = input_home_pid
        self.overlap_comm = overlap_comm
        self.noise = noise
        # request-source arrival process; None = periodic (arrival = rid·Φ)
        self.arrivals = arrivals
        # fault ensemble; an empty spec normalizes to None so the clean
        # path stays byte-for-byte what it was before the fault layer
        self.faults = None if faults is None or faults.empty else faults
        self._noise_rng = random.Random(noise.seed if noise else 0)
        # The Coordinator runs on the CPU (paper §6.3: dispatch/system work
        # makes the CPU a contended, fluctuating resource). Every task
        # dispatch steals `dispatch_overhead` seconds of the dispatch
        # processor's worker time.
        self.dispatch_overhead = dispatch_overhead
        self.dispatch_pid = dispatch_pid
        # Static per-network dependency structure over subgraphs (shared with
        # the fast array engine so both see identical structure).
        self._deps, self._succs, self._producer_of_layer = derive_dependencies(placed)
        # Task costs are request-independent: precompute once per solution.
        self._costs: List[List[Tuple[float, float, float]]] = [
            [
                subgraph_task_costs(
                    placed, net, k, self._producer_of_layer[net],
                    bool(self._deps[net][k]), profiler, comm_model,
                    input_home_pid,
                )
                for k in range(len(net_placed))
            ]
            for net, net_placed in enumerate(placed)
        ]

    # -- simulation -----------------------------------------------------------
    def run(self) -> SimResult:
        env = Environment()
        stores = {proc.pid: PriorityStore(env) for proc in self.processors}
        busy: Dict[int, float] = {proc.pid: 0.0 for proc in self.processors}
        tasks: List[TaskRecord] = []
        req_records: Dict[Tuple[int, int], RequestRecord] = {}
        # pending dep counters per (group, request, net, sg)
        pending: Dict[Tuple[int, int, int, int], int] = {}
        release_seq = [0]

        def release(gid: int, rid: int, net: int, k: int) -> None:
            p = self.placed[net][k]
            rec = TaskRecord(
                group=gid, request=rid, network=net, sg_index=k,
                processor=p.processor, released=env.now,
            )
            tasks.append(rec)
            if self.dispatch_overhead > 0 and self.dispatch_pid in stores:
                # Coordinator dispatch work occupies the dispatch processor
                # before the task can start executing anywhere.
                release_seq[0] += 1
                stores[self.dispatch_pid].put(
                    ("dispatch",), priority=(-1, 0, release_seq[0])
                )
            release_seq[0] += 1
            stores[p.processor].put(
                (rec, net, k, gid, rid), priority=(0, p.priority, release_seq[0])
            )

        def task_done(gid: int, rid: int, net: int, k: int) -> None:
            key = (gid, rid)
            rr = req_records[key]
            rr.done_tasks += 1
            rr.last_finish = max(rr.last_finish, env.now)
            for s in self._succs[net][k]:
                pk = (gid, rid, net, s)
                pending[pk] -= 1
                if pending[pk] == 0:
                    release(gid, rid, net, s)

        fault_stream = FaultStream(self.faults) if self.faults else None

        def worker(proc: Processor) -> Generator:
            store = stores[proc.pid]
            sigma = self.noise.sigma(proc.kind) if self.noise else 0.0
            while True:
                item = yield store.get()
                if item[0] == "dispatch":
                    busy[proc.pid] += self.dispatch_overhead
                    yield env.timeout(self.dispatch_overhead)
                    continue
                rec, net, k, gid, rid = item
                comm, quant, exec_t = self._costs[net][k]
                if sigma > 0.0:
                    # mean-1 lognormal fluctuation (§6.3 run-to-run variance)
                    exec_t *= math.exp(
                        self._noise_rng.gauss(-0.5 * sigma * sigma, sigma)
                    )
                stall = 0.0
                if fault_stream is not None:
                    exec_t, stall = fault_stream.service(
                        proc.pid, env.now, exec_t)
                rec.comm_time, rec.quant_time, rec.exec_time = comm, quant, exec_t
                rec.started = env.now
                rr = req_records[(gid, rid)]
                rr.first_start = min(rr.first_start, env.now)
                total = exec_t + quant + (0.0 if self.overlap_comm else comm)
                if stall > 0.0:
                    # delivered to a dropped processor: wait out the repair
                    # (forever when permanent — the END event at t=inf never
                    # fires, so the request is dropped at the horizon)
                    total = stall + total
                if not math.isinf(total):
                    busy[proc.pid] += total
                yield env.timeout(total)
                rec.finished = env.now
                task_done(gid, rid, net, k)

        def request_source(gid: int, nets: Sequence[int],
                           table: Sequence[float]) -> Generator:
            for rid in range(self.num_requests):
                arrival = table[rid]
                if arrival > env.now:
                    yield env.timeout(arrival - env.now)
                total_tasks = sum(len(self.placed[n]) for n in nets)
                req_records[(gid, rid)] = RequestRecord(
                    group=gid, request=rid, arrival=env.now, total_tasks=total_tasks
                )
                for n in nets:
                    for k in range(len(self.placed[n])):
                        d = len(self._deps[n][k])
                        pending[(gid, rid, n, k)] = d
                        if d == 0:
                            release(gid, rid, n, k)

        # one shared table per run: every engine tier draws the identical
        # arrival timestamps (periodic when self.arrivals is None)
        arrival_tables = draw_arrivals(
            self.arrivals, self.periods, self.num_requests)
        for proc in self.processors:
            env.process(worker(proc))
        for gid, nets in enumerate(self.groups):
            env.process(request_source(gid, nets, arrival_tables[gid]))

        # run to quiescence with a generous horizon: all requests issued plus
        # slack for stragglers (periodic: the historical expression verbatim).
        horizon = arrival_horizon(
            arrival_tables, self.periods, self.num_requests)
        env.run(until=horizon)
        return SimResult(
            requests=sorted(req_records.values(), key=lambda r: (r.group, r.request)),
            tasks=tasks,
            busy_time=busy,
            horizon=env.now,
        )
