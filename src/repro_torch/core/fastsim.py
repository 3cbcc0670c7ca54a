"""Fast array-based search-time simulator (drop-in for :class:`RuntimeSimulator`).

The GA evaluates tens of thousands of candidate schedules per scenario, and
every evaluation replays the runtime in the discrete-event simulator. The
reference implementation (:mod:`repro_torch.core.simulator`) drives generator
coroutines through a SimPy-style :class:`~repro_torch.core.des.Environment`; that
is faithful but slow — every event allocates an ``Event`` object, every
worker step is a generator ``send``, and every solution re-derives its
dependency structure and cost table.

This module splits that work in two:

* :class:`FastSimSpec` — the *static* part of a decoded solution: flattened
  CSR-style dependency arrays and per-subgraph ``(comm, quant, exec)`` cost
  vectors, built once per solution (see ``StaticAnalyzer``'s decode cache)
  and reused across every ``(alpha, num_requests, noise seed)`` evaluation.
* :class:`FastSimulator` — a single ``heapq`` event loop over plain tuples.
  No ``Environment``/``Process``/``Event`` objects, no generator dispatch.

Semantics are *bit-identical* to :class:`RuntimeSimulator` — same
non-preemptive priority queues, same tie-breaking at equal timestamps, same
dispatch-overhead injection, and the same lognormal noise stream for a given
seed — so the measured (noisy) evaluation path can use it too. The parity is
enforced by ``tests/test_fastsim.py`` and the ``simspeed`` benchmark section;
``RuntimeSimulator`` remains the reference oracle.

Copy of ``repro.core.fastsim``, verbatim in its arithmetic.
"""
from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .arrivals import ArrivalSpec, arrival_horizon, draw_arrivals
from .chromosome import BACKENDS, DTYPES, PlacedSubgraph, subgraph_processor
from .comm import PiecewiseLinearCommModel
from .faults import FaultSpec, FaultStream
from .processors import Processor
from .profiler import Profiler
from .simulator import (
    NoiseModel,
    RequestRecord,
    SimResult,
    TaskRecord,
    derive_dependencies,
    subgraph_task_costs,
)

# Event codes. Heap entries are ``(time, seq, code, ...)`` with a globally
# unique ``seq``, so comparison never reaches the payload.
_SRC = 0       # request source fires: release one request of one group
_DELIVER = 1   # a store item is handed to an idle worker
_END = 2       # a worker finishes its current item

_DISPATCH = ("dispatch",)  # sentinel store item, mirrors the reference sim


@dataclass
class FastSimSpec:
    """Static per-solution arrays, reusable across simulator runs.

    ``placed`` is metadata for inspection/debugging; the event loop reads
    only the flat arrays. :class:`SpecBuilder` leaves it ``None`` on its hot
    path (use :meth:`SpecBuilder.decode` when the decoded view is needed).
    """

    placed: Optional[Sequence[Sequence[PlacedSubgraph]]]
    processors: Sequence[Processor]
    # flat subgraph indexing: global id g = offsets[net] + k
    offsets: List[int]
    counts: List[int]
    net_of: List[int]
    k_of: List[int]
    proc_of: List[int]           # processor pid per flat subgraph
    prio_of: List[int]           # decoded network priority rank per subgraph
    comm: List[float]
    quant: List[float]
    exec_: List[float]
    dep_count: List[int]
    succ_indptr: List[int]       # CSR over successors
    succ_flat: List[int]

    @property
    def num_subgraphs(self) -> int:
        return len(self.proc_of)

    def roots(self) -> List[List[int]]:
        """Per-network flat ids of dependency-free subgraphs, cached.

        These are released at every request arrival, so all three engines
        (fast heapq loop, lean loop, batch lock-step pass) need them for
        every run of the same spec — compute once per spec instead.
        """
        r = getattr(self, "_roots", None)
        if r is None:
            r = self._roots = [
                [g for g in range(self.offsets[n],
                                  self.offsets[n] + self.counts[n])
                 if self.dep_count[g] == 0]
                for n in range(len(self.counts))
            ]
        return r

    def signature(self) -> Tuple:
        """Content key: two specs with equal signatures simulate identically.

        Distinct chromosomes often decode to the same placed configuration
        (mapping mutations that flip no majority vote, priority swaps between
        networks with equal rank) — callers can memoize evaluation results on
        this key. Cached on first use.
        """
        sig = getattr(self, "_signature", None)
        if sig is None:
            sig = self._signature = (
                tuple(self.offsets),
                tuple(self.proc_of),
                tuple(self.prio_of),
                tuple(self.comm),
                tuple(self.quant),
                tuple(self.exec_),
                tuple(self.dep_count),
                tuple(self.succ_indptr),
                tuple(self.succ_flat),
            )
        return sig


def build_spec(
    placed: Sequence[Sequence[PlacedSubgraph]],
    processors: Sequence[Processor],
    profiler: Profiler,
    comm_model: PiecewiseLinearCommModel,
    input_home_pid: int = 0,
) -> FastSimSpec:
    """Flatten a decoded solution into the arrays the event loop consumes."""
    deps, succs, owners = derive_dependencies(placed)
    offsets: List[int] = []
    counts: List[int] = []
    net_of: List[int] = []
    k_of: List[int] = []
    proc_of: List[int] = []
    prio_of: List[int] = []
    comm: List[float] = []
    quant: List[float] = []
    exec_: List[float] = []
    dep_count: List[int] = []
    succ_indptr: List[int] = [0]
    succ_flat: List[int] = []
    base = 0
    for net, net_placed in enumerate(placed):
        offsets.append(base)
        counts.append(len(net_placed))
        for k, p in enumerate(net_placed):
            net_of.append(net)
            k_of.append(k)
            proc_of.append(p.processor)
            prio_of.append(p.priority)
            c, q, x = subgraph_task_costs(
                placed, net, k, owners[net], bool(deps[net][k]),
                profiler, comm_model, input_home_pid,
            )
            comm.append(c)
            quant.append(q)
            exec_.append(x)
            dep_count.append(len(deps[net][k]))
            succ_flat.extend(base + s for s in succs[net][k])
            succ_indptr.append(len(succ_flat))
        base += len(net_placed)
    return FastSimSpec(
        placed=placed, processors=processors, offsets=offsets, counts=counts,
        net_of=net_of, k_of=k_of, proc_of=proc_of, prio_of=prio_of,
        comm=comm, quant=quant, exec_=exec_, dep_count=dep_count,
        succ_indptr=succ_indptr, succ_flat=succ_flat,
    )


class SpecBuilder:
    """Builds :class:`FastSimSpec`\\ s for a fixed problem instance, with
    cross-solution caching.

    GA populations share genetic material: distinct solutions frequently
    carry identical partition bit-vectors per network, and the same
    ``(subgraph, processor, dtype, backend)`` execution decisions recur
    constantly. Decoding and cost annotation are the dominant per-candidate
    cost once the event loop itself is fast, so this builder memoizes

    * ``graph.partition(bits)`` per network and bit-pattern, and
    * profiled execution time per ``(net, bits, k, processor, dtype, backend)``

    while recomputing the cheap boundary terms (comm/quant, which depend on
    neighbouring placements) fresh for every solution. Values are identical
    to the uncached path — the profiler is deterministic per profile key —
    so engine parity is unaffected.
    """

    def __init__(
        self,
        graphs: Sequence,
        processors: Sequence[Processor],
        profiler: Profiler,
        comm_model: PiecewiseLinearCommModel,
        input_home_pid: int = 0,
        max_partitions_per_net: int = 8192,
    ):
        self.graphs = list(graphs)
        self.processors = processors
        self.profiler = profiler
        self.comm_model = comm_model
        self.input_home_pid = input_home_pid
        self.max_partitions_per_net = max_partitions_per_net
        self._partitions: List[Dict[Tuple[int, ...], tuple]] = [
            {} for _ in self.graphs
        ]
        self._exec: Dict[Tuple, float] = {}
        # content exec-key -> Merkle profile key, so device-in-the-loop
        # ProfileDB updates can invalidate exactly the affected memo entries
        self._exec_profile_key: Dict[Tuple, str] = {}
        # per-network decode+cost cache: one network's placed subgraphs and
        # cost vectors depend only on its own genes (+ priority rank), so
        # they are reusable across the many solutions that share them.
        self._net_cache: List[Dict[Tuple, tuple]] = [{} for _ in self.graphs]
        # majority-vote memo per (partition bits, mapping genes)
        self._votes: List[Dict[Tuple, Tuple[int, ...]]] = [{} for _ in self.graphs]

    def _structure(self, net: int, bits: Sequence[int]) -> tuple:
        """(subgraphs, deps, succs, owner, in_cuts) for one network's
        partition bits.

        The dependency structure and boundary-edge lists are pure functions
        of the partition, so they cache alongside the subgraph list (same
        derivation as :func:`derive_dependencies`).
        """
        key = tuple(bits)
        cache = self._partitions[net]
        hit = cache.get(key)
        if hit is None:
            if len(cache) >= self.max_partitions_per_net:
                cache.clear()
            sgs = self.graphs[net].partition(list(bits))
            owner: Dict[int, int] = {}
            for k, sg in enumerate(sgs):
                for lid in sg.layer_ids:
                    owner[lid] = k
            in_cuts = [sg.in_cut_edges() for sg in sgs]
            deps = [sorted({owner[e.src] for e in ic}) for ic in in_cuts]
            succs: List[List[int]] = [[] for _ in sgs]
            for k, prods in enumerate(deps):
                for pr in prods:
                    succs[pr].append(k)
            hit = cache[key] = (sgs, deps, succs, owner, in_cuts)
        return hit

    def decode(self, sol: Solution) -> List[List[PlacedSubgraph]]:
        """`decode_solution` with the partition cache."""
        out: List[List[PlacedSubgraph]] = []
        prio_rank = {n: r for r, n in enumerate(sol.priority)}
        for net in range(len(self.graphs)):
            sgs = self._structure(net, sol.partition[net])[0]
            mapping = sol.mapping[net]
            out.append([
                PlacedSubgraph(
                    subgraph=sg,
                    network=net,
                    processor=subgraph_processor(sg, mapping),
                    dtype=DTYPES[sol.dtype[net]],
                    backend=BACKENDS[sol.backend[net]],
                    priority=prio_rank[net],
                )
                for sg in sgs
            ])
        return out

    def _net_entry(self, sol: Solution, net: int) -> tuple:
        """Cached (sgs, procs, dep_counts, succ_indptr, succ_flat, comm,
        quant, exec) for one network under one *decoded* assignment.

        Keyed by the majority-voted processor per subgraph rather than the
        raw mapping genes — many mapping mutations flip no vote, so they all
        share one entry — and priority is deliberately excluded: it only
        shapes queue ordering at run time, never costs.
        """
        bits_key = tuple(sol.partition[net])
        sgs, deps, succs, owner, in_cuts = self._structure(net, bits_key)
        mapping = sol.mapping[net]
        vote_key = (bits_key, tuple(mapping))
        votes = self._votes[net]
        procs = votes.get(vote_key)
        if procs is None:
            if len(votes) >= self.max_partitions_per_net:
                votes.clear()
            procs = votes[vote_key] = tuple(
                subgraph_processor(sg, mapping) for sg in sgs
            )
        key = (bits_key, procs, sol.dtype[net], sol.backend[net])
        cache = self._net_cache[net]
        ent = cache.get(key)
        if ent is not None:
            return ent
        if len(cache) >= self.max_partitions_per_net:
            cache.clear()
        dtype = DTYPES[sol.dtype[net]]
        backend = BACKENDS[sol.backend[net]]
        # cost annotation is priority-independent; priority 0 placeholder
        placed_net = [
            PlacedSubgraph(
                subgraph=sg, network=net, processor=proc,
                dtype=dtype, backend=backend, priority=0,
            )
            for sg, proc in zip(sgs, procs)
        ]
        gkey = id(self.graphs[net])  # graphs list pins the objects, ids stable
        comm: List[float] = []
        quant: List[float] = []
        exec_: List[float] = []
        dep_counts: List[int] = []
        succ_indptr: List[int] = [0]
        succ_flat: List[int] = []
        one_net = [placed_net]  # subgraph_task_costs only reads placed[net]
        for k, p in enumerate(placed_net):
            # content key: the same layer set under the same execution
            # config costs the same across partitions and solutions
            exec_key = (gkey, p.subgraph.layer_ids, p.processor,
                        p.dtype, p.backend)
            if exec_key not in self._exec_profile_key:
                # merkle_hash memoizes on the (shared) Subgraph instance,
                # so this is a dict hit on all but the first computation
                self._exec_profile_key[exec_key] = p.profile_key()
            c, q, x = subgraph_task_costs(
                one_net, 0, k, owner, bool(deps[k]),
                self.profiler, self.comm_model, self.input_home_pid,
                exec_cache=self._exec,
                exec_key=exec_key,
                in_cut=in_cuts[k],
            )
            comm.append(c)
            quant.append(q)
            exec_.append(x)
            dep_counts.append(len(deps[k]))
            succ_flat.extend(succs[k])
            succ_indptr.append(len(succ_flat))
        ent = cache[key] = (
            sgs, procs, dep_counts, succ_indptr, succ_flat,
            comm, quant, exec_,
        )
        return ent

    def invalidate(self, profile_keys: Optional[Sequence[str]] = None) -> int:
        """Drop cost memos stale after a ProfileDB change; returns how many
        exec-cache entries were dropped.

        With ``profile_keys`` only the exec memo entries whose Merkle
        profile key is affected are evicted (the map recorded at memo-fill
        time makes this exact); ``None`` evicts everything. The per-network
        decode+cost entries embed exec times, so they are cleared wholesale
        either way — they rebuild from the surviving partition/vote/exec
        caches on the next ``build``. Structure caches (partitions, votes)
        are cost-independent and always survive.
        """
        if profile_keys is None:
            dropped = len(self._exec)
            self._exec.clear()
            self._exec_profile_key.clear()
        else:
            keys = set(profile_keys)
            stale = [ek for ek, pk in self._exec_profile_key.items()
                     if pk in keys]
            dropped = 0
            for ek in stale:
                del self._exec_profile_key[ek]
                if self._exec.pop(ek, None) is not None:
                    dropped += 1
        for cache in self._net_cache:
            cache.clear()
        return dropped

    def build(self, sol: Solution) -> FastSimSpec:
        prio_rank = {n: r for r, n in enumerate(sol.priority)}
        offsets: List[int] = []
        counts: List[int] = []
        net_of: List[int] = []
        k_of: List[int] = []
        proc_of: List[int] = []
        prio_of: List[int] = []
        comm: List[float] = []
        quant: List[float] = []
        exec_: List[float] = []
        dep_count: List[int] = []
        succ_indptr: List[int] = [0]
        succ_flat: List[int] = []
        base = 0
        for net in range(len(self.graphs)):
            prio = prio_rank[net]
            (sgs, procs, net_dep_counts, net_indptr, net_succ,
             net_comm, net_quant, net_exec) = self._net_entry(sol, net)
            n_sg = len(sgs)
            offsets.append(base)
            counts.append(n_sg)
            net_of.extend([net] * n_sg)
            k_of.extend(range(n_sg))
            proc_of.extend(procs)
            prio_of.extend([prio] * n_sg)
            comm.extend(net_comm)
            quant.extend(net_quant)
            exec_.extend(net_exec)
            dep_count.extend(net_dep_counts)
            succ_flat.extend(base + s for s in net_succ)
            top = succ_indptr[-1]
            succ_indptr.extend(top + o for o in net_indptr[1:])
            base += n_sg
        return FastSimSpec(
            placed=None, processors=self.processors, offsets=offsets,
            counts=counts, net_of=net_of, k_of=k_of, proc_of=proc_of,
            prio_of=prio_of, comm=comm, quant=quant, exec_=exec_,
            dep_count=dep_count, succ_indptr=succ_indptr, succ_flat=succ_flat,
        )


class FastSimulator:
    """Array-based replay of one scenario execution for a prepared solution.

    Constructor mirrors :class:`RuntimeSimulator`'s run-time parameters; the
    solution-static part lives in the :class:`FastSimSpec`.
    """

    def __init__(
        self,
        spec: FastSimSpec,
        groups: Sequence[Sequence[int]],
        periods: Sequence[float],
        num_requests: int = 20,
        overlap_comm: bool = False,
        noise: Optional[NoiseModel] = None,
        dispatch_overhead: float = 0.0,
        dispatch_pid: int = 0,
        arrivals: Optional[ArrivalSpec] = None,
        faults: Optional[FaultSpec] = None,
    ):
        self.spec = spec
        self.groups = groups
        self.periods = periods
        self.num_requests = num_requests
        self.overlap_comm = overlap_comm
        self.noise = noise
        self.dispatch_overhead = dispatch_overhead
        self.dispatch_pid = dispatch_pid
        # request-source arrival process; None = periodic (arrival = rid·Φ)
        self.arrivals = arrivals
        # fault ensemble; empty specs normalize to None (clean path intact)
        self.faults = None if faults is None or faults.empty else faults

    @classmethod
    def from_placed(
        cls,
        placed: Sequence[Sequence[PlacedSubgraph]],
        processors: Sequence[Processor],
        profiler: Profiler,
        comm_model: PiecewiseLinearCommModel,
        groups: Sequence[Sequence[int]],
        periods: Sequence[float],
        num_requests: int = 20,
        input_home_pid: int = 0,
        overlap_comm: bool = False,
        noise: Optional[NoiseModel] = None,
        dispatch_overhead: float = 0.0,
        dispatch_pid: int = 0,
        arrivals: Optional[ArrivalSpec] = None,
        faults: Optional[FaultSpec] = None,
    ) -> "FastSimulator":
        """Build spec + simulator with :class:`RuntimeSimulator`'s signature."""
        spec = build_spec(placed, processors, profiler, comm_model, input_home_pid)
        return cls(
            spec, groups, periods, num_requests=num_requests,
            overlap_comm=overlap_comm, noise=noise,
            dispatch_overhead=dispatch_overhead, dispatch_pid=dispatch_pid,
            arrivals=arrivals, faults=faults,
        )

    def run(self, collect_tasks: bool = True) -> SimResult:
        if (not collect_tasks and self.noise is None
                and self.dispatch_overhead <= 0 and self.faults is None):
            # GA fast-evaluation configuration: no task records, no noise
            # draws, no dispatch injection, no faults — take the lean loop.
            return self._run_lean()
        return self._run_full(collect_tasks)

    def _run_lean(self) -> SimResult:
        """Specialized event loop for clean no-record runs.

        Identical semantics to :meth:`_run_full` with ``collect_tasks=False,
        noise=None, dispatch_overhead=0`` (asserted by the test suite); the
        per-event branches for those features are compiled out because this
        is the innermost loop of the GA search.
        """
        spec = self.spec
        proc_of = spec.proc_of
        prio_of = spec.prio_of
        comm_v, quant_v, exec_v = spec.comm, spec.quant, spec.exec_
        dep_count = spec.dep_count
        indptr, succ = spec.succ_indptr, spec.succ_flat
        counts = spec.counts
        overlap = self.overlap_comm

        pids = [p.pid for p in spec.processors]
        n_pid = max(pids) + 1
        items: List[list] = [[] for _ in range(n_pid)]
        idle: List[bool] = [False] * n_pid
        for pid in pids:
            idle[pid] = True
        busy_v: List[float] = [0.0] * n_pid
        group_tasks = [sum(counts[n] for n in g) for g in self.groups]

        req_records: Dict[Tuple[int, int], RequestRecord] = {}
        roots = spec.roots()

        arrival_tables = draw_arrivals(
            self.arrivals, self.periods, self.num_requests)
        events: list = []
        push = heapq.heappush
        pop = heapq.heappop
        seq = 0
        release_seq = 0
        now = 0.0
        for gid in range(len(self.groups)):
            push(events, (0.0, seq, _SRC, gid, 0))
            seq += 1

        horizon = arrival_horizon(
            arrival_tables, self.periods, self.num_requests)

        while events and events[0][0] <= horizon:
            now, _, code, pid, item = pop(events)
            if code == _DELIVER:
                g, rr, pend = item
                exec_t = exec_v[g]
                if now < rr.first_start:
                    rr.first_start = now
                total = exec_t + quant_v[g] + (0.0 if overlap else comm_v[g])
                busy_v[pid] += total
                push(events, (now + total, seq, _END, pid, item))
                seq += 1
            elif code == _END:
                g, rr, pend = item
                rr.done_tasks += 1
                if now > rr.last_finish:
                    rr.last_finish = now
                for s in succ[indptr[g]:indptr[g + 1]]:
                    pend[s] -= 1
                    if pend[s] == 0:
                        # no dispatch tokens in the lean loop, so the leading
                        # priority class of the full loop's key is dropped
                        release_seq += 1
                        spid = proc_of[s]
                        if idle[spid]:
                            idle[spid] = False
                            push(events, (now, seq, _DELIVER, spid, (s, rr, pend)))
                            seq += 1
                        else:
                            push(items[spid],
                                 ((prio_of[s], release_seq), (s, rr, pend)))
                store = items[pid]
                if store:
                    _, nxt = pop(store)
                    push(events, (now, seq, _DELIVER, pid, nxt))
                    seq += 1
                else:
                    idle[pid] = True
            else:  # _SRC
                gid, rid = pid, item
                if rid == 0 and arrival_tables[gid][0] > now:
                    # non-zero first arrival: the reference source fires its
                    # init at t=0 and *then* times out to the first arrival —
                    # deferring here reproduces that heap-sequence order
                    arrival = arrival_tables[gid][0]
                    push(events, (now + (arrival - now), seq, _SRC, gid, 0))
                    seq += 1
                    continue
                rr = RequestRecord(
                    group=gid, request=rid, arrival=now,
                    total_tasks=group_tasks[gid],
                )
                req_records[(gid, rid)] = rr
                pend = list(dep_count)
                for n in self.groups[gid]:
                    for g in roots[n]:
                        release_seq += 1
                        rpid = proc_of[g]
                        if idle[rpid]:
                            idle[rpid] = False
                            push(events, (now, seq, _DELIVER, rpid, (g, rr, pend)))
                            seq += 1
                        else:
                            push(items[rpid],
                                 ((prio_of[g], release_seq), (g, rr, pend)))
                if rid + 1 < self.num_requests:
                    arrival = arrival_tables[gid][rid + 1]
                    push(events, (now + (arrival - now), seq, _SRC, gid, rid + 1))
                    seq += 1

        return SimResult(
            requests=sorted(req_records.values(), key=lambda r: (r.group, r.request)),
            tasks=[],
            busy_time={pid: busy_v[pid] for pid in pids},
            horizon=horizon,
        )

    def _run_full(self, collect_tasks: bool = True) -> SimResult:
        spec = self.spec
        proc_of = spec.proc_of
        prio_of = spec.prio_of
        comm_v, quant_v, exec_v = spec.comm, spec.quant, spec.exec_
        dep_count = spec.dep_count
        indptr, succ = spec.succ_indptr, spec.succ_flat
        net_of, k_of = spec.net_of, spec.k_of
        counts = spec.counts
        overlap = self.overlap_comm
        dispatch_ov = self.dispatch_overhead
        dispatch_pid = self.dispatch_pid
        noise = self.noise
        rng_gauss = random.Random(noise.seed if noise else 0).gauss
        exp = math.exp
        fault_service = (FaultStream(self.faults).service
                         if self.faults else None)

        # dense per-pid arrays (pids are small non-negative ints)
        pids = [p.pid for p in spec.processors]
        n_pid = max(pids) + 1
        sigma_of = [0.0] * n_pid
        for p in spec.processors:
            sigma_of[p.pid] = noise.sigma(p.kind) if noise else 0.0
        items: List[list] = [[] for _ in range(n_pid)]
        idle: List[bool] = [False] * n_pid
        for pid in pids:
            idle[pid] = True
        busy_v: List[float] = [0.0] * n_pid
        dispatch_known = dispatch_ov > 0 and dispatch_pid in pids
        group_tasks = [sum(counts[n] for n in g) for g in self.groups]

        tasks: List[TaskRecord] = []
        req_records: Dict[Tuple[int, int], RequestRecord] = {}
        # per-network flat ids of dependency-free subgraphs, released at arrival
        roots = spec.roots()

        arrival_tables = draw_arrivals(
            self.arrivals, self.periods, self.num_requests)
        events: list = []
        push = heapq.heappush
        pop = heapq.heappop
        seq = 0
        release_seq = 0
        now = 0.0

        # request sources fire in group order at t=0, like the reference
        # sim's Process init events; a non-zero first arrival defers inside
        # the _SRC handler (mirroring the reference source's first timeout).
        for gid in range(len(self.groups)):
            push(events, (0.0, seq, _SRC, gid, 0))
            seq += 1

        # Work items carry their request record and pending-counter array so
        # the hot loop never re-keys into per-request dicts:
        #   item = (rec | None, flat sg id, RequestRecord, pending list)

        def release(gid: int, rid: int, g: int, rr: "RequestRecord",
                    pend: List[List[int]]) -> None:
            nonlocal seq, release_seq
            pid = proc_of[g]
            if collect_tasks:
                rec: Optional[TaskRecord] = TaskRecord(
                    group=gid, request=rid, network=net_of[g], sg_index=k_of[g],
                    processor=pid, released=now,
                )
                tasks.append(rec)
            else:
                rec = None
            if dispatch_known:
                release_seq += 1
                if idle[dispatch_pid]:
                    idle[dispatch_pid] = False
                    push(events, (now, seq, _DELIVER, dispatch_pid, _DISPATCH))
                    seq += 1
                else:
                    push(items[dispatch_pid], ((-1, 0, release_seq), _DISPATCH))
            release_seq += 1
            item = (rec, g, rr, pend)
            if idle[pid]:
                idle[pid] = False
                push(events, (now, seq, _DELIVER, pid, item))
                seq += 1
            else:
                push(items[pid], ((0, prio_of[g], release_seq), item))

        horizon = arrival_horizon(
            arrival_tables, self.periods, self.num_requests)

        while events and events[0][0] <= horizon:
            now, _, code, pid, item = pop(events)
            if code == _DELIVER:
                if item is _DISPATCH:
                    busy_v[pid] += dispatch_ov
                    push(events, (now + dispatch_ov, seq, _END, pid, None))
                    seq += 1
                    continue
                rec, g, rr, pend = item
                exec_t = exec_v[g]
                sigma = sigma_of[pid]
                if sigma > 0.0:
                    # mean-1 lognormal fluctuation (§6.3 run-to-run variance)
                    exec_t *= exp(rng_gauss(-0.5 * sigma * sigma, sigma))
                stall = 0.0
                if fault_service is not None:
                    exec_t, stall = fault_service(pid, now, exec_t)
                quant = quant_v[g]
                cm = comm_v[g]
                if rec is not None:
                    rec.comm_time, rec.quant_time, rec.exec_time = cm, quant, exec_t
                    rec.started = now
                if now < rr.first_start:
                    rr.first_start = now
                total = exec_t + quant + (0.0 if overlap else cm)
                if stall > 0.0:
                    # dropped processor: the task waits out the repair (the
                    # END at t=inf never pops when permanent)
                    total = stall + total
                if not math.isinf(total):
                    busy_v[pid] += total
                push(events, (now + total, seq, _END, pid, item))
                seq += 1
            elif code == _END:
                if item is not None:
                    rec, g, rr, pend = item
                    if rec is not None:
                        rec.finished = now
                    rr.done_tasks += 1
                    if now > rr.last_finish:
                        rr.last_finish = now
                    i0, i1 = indptr[g], indptr[g + 1]
                    if i0 != i1:
                        gid = rr.group
                        rid = rr.request
                        for s in succ[i0:i1]:
                            pend[s] -= 1
                            if pend[s] == 0:
                                release(gid, rid, s, rr, pend)
                # worker pulls its next item or goes idle
                store = items[pid]
                if store:
                    _, nxt = pop(store)
                    push(events, (now, seq, _DELIVER, pid, nxt))
                    seq += 1
                else:
                    idle[pid] = True
            else:  # _SRC
                gid, rid = pid, item  # payload slots carry (gid, rid)
                if rid == 0 and arrival_tables[gid][0] > now:
                    # defer to the first arrival (reference-source timeout
                    # order: init fires at t=0, then times out)
                    arrival = arrival_tables[gid][0]
                    push(events, (now + (arrival - now), seq, _SRC, gid, 0))
                    seq += 1
                    continue
                rr = RequestRecord(
                    group=gid, request=rid, arrival=now,
                    total_tasks=group_tasks[gid],
                )
                req_records[(gid, rid)] = rr
                pend = list(dep_count)
                for n in self.groups[gid]:
                    for g in roots[n]:
                        release(gid, rid, g, rr, pend)
                if rid + 1 < self.num_requests:
                    arrival = arrival_tables[gid][rid + 1]
                    # reference sim computes `timeout(arrival - now)`; keep the
                    # same float expression so tie-breaking stays identical
                    push(events, (now + (arrival - now), seq, _SRC, gid, rid + 1))
                    seq += 1

        return SimResult(
            requests=sorted(req_records.values(), key=lambda r: (r.group, r.request)),
            tasks=tasks,
            busy_time={pid: busy_v[pid] for pid in pids},
            horizon=horizon,
        )
