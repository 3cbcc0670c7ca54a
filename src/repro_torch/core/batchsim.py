"""Generation-batched evaluation engine (struct-of-arrays over solutions).

The GA evaluates whole generations (population + offspring, 40–80
candidates) and whole candidate sets (Pareto front × α lattice) against one
scenario. :class:`BatchSimulator` runs *all* of those simulations in one
numpy-vectorized event-stepping pass: every lane (one ``(solution spec,
periods, num_requests, noise seed, arrival spec)`` tuple) advances in
lock-step over a shared event frontier — each iteration pops the earliest pending event of
every live lane and applies all three event classes (request arrival,
worker completion, work delivery) as masked array operations.

Exactness contract
------------------
Results are **bit-identical** to :class:`~repro_torch.core.fastsim.FastSimulator`
(and therefore to the :class:`~repro_torch.core.simulator.RuntimeSimulator`
reference DES) per lane, including

* heap tie-breaking: events are ordered by ``(time, push sequence)`` with a
  per-lane push counter, exactly like the per-solution heap;
* dispatch-token injection and its ``(-1, 0, release_seq)`` queue-priority
  class;
* the lognormal noise stream: per-lane ``random.Random(seed).gauss`` draws
  are consumed in delivery order and the multiplier is computed with the
  same ``math.exp`` expression (numpy's SIMD ``exp`` can differ by an ULP,
  so it is deliberately *not* used for the noise path);
* float associativity: every arithmetic expression that feeds an event
  timestamp is evaluated with the same operation order as the per-solution
  engines (IEEE-754 double ops are bit-reproducible across numpy and
  CPython).

The parity is enforced three ways: the property-based differential suite
(``tests/test_batchsim_properties.py``), the golden task traces
(``tests/test_golden_traces.py``) and the ``simspeed`` benchmark section.

Performance notes
-----------------
The lock-step pass amortizes numpy dispatch overhead across the batch
width, so its per-event cost *falls* with lane count while the per-solution
loop's stays flat. On wide batches (hundreds of lanes) it approaches the
hand-tuned per-solution loop; the measured crossover on CPU is documented
in ``BENCH_simspeed.json``. Population-level throughput beyond that comes
from the pipeline around the pass — generation dedup against the objective
cache, one shared noise table per seed, vectorized objective extraction —
and from sharding lanes across a process pool (``workers > 1``), each shard
running its own lock-step pass; sharding only engages at
``SHARD_MIN_LANES`` lanes and above — below that the fork/pickle round trip
costs more than it saves.

Copy of ``repro.core.batchsim``, verbatim in its arithmetic. The opt-in
``engine="compiled"`` backend (:mod:`repro_torch.core.batchsim_compiled`)
runs this pass as one hand-written kernel launch on the card, one thread
per lane, or as a torch float64 lock-step pass with ``device="cpu"``; the
bit-exact numpy path stays the default.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple, Union

import numpy as np

if TYPE_CHECKING:
    import torch

from .arrivals import ArrivalSpec, arrival_horizon, draw_arrivals
from .fastsim import FastSimSpec
from .faults import FaultSpec, FaultStream
from .processors import Processor
from .simulator import NoiseModel, RequestRecord, SimResult, TaskRecord

# queue-priority packing: (class, priority, release_seq) -> one int64.
# class 0 = dispatch token (reference priority (-1, 0, seq)), 1 = real task
# (reference (0, prio, seq) / lean (prio, seq) — same relative order).
_CLS_SHIFT = np.int64(1) << 53
_PRIO_SHIFT = np.int64(1) << 40
_EMPTY = np.int64(1) << 62
_BIGSEQ = np.int64(1) << 62


@dataclass
class BatchLane:
    """One simulation in a batch: a prepared spec plus run-time parameters.

    Mirrors :class:`~repro_torch.core.fastsim.FastSimulator`'s constructor
    arguments; ``noise_seed=None`` runs the lane clean (no draws), matching
    ``noise=None``. ``dispatch_overhead`` may differ per lane (the analyzer
    mixes clean search evals and measured accurate evals in one batch), as
    may the ``arrivals`` process (``None`` = periodic).
    """

    spec: FastSimSpec
    periods: Sequence[float]
    num_requests: int = 20
    noise: Optional[NoiseModel] = None
    dispatch_overhead: float = 0.0
    dispatch_pid: int = 0
    overlap_comm: bool = False
    arrivals: Optional[ArrivalSpec] = None
    faults: Optional[FaultSpec] = None


@dataclass
class BatchResult:
    """Per-lane request/busy arrays plus :class:`SimResult` reconstruction."""

    lanes: Sequence[BatchLane]
    groups: Sequence[Sequence[int]]
    num_requests: np.ndarray      # (W,) int64
    arrival: np.ndarray           # (W, R) float64
    first_start: np.ndarray       # (W, R)
    last_finish: np.ndarray       # (W, R)
    done: np.ndarray              # (W, R) int64
    group_tasks: np.ndarray       # (W, G) int64
    busy: np.ndarray              # (W, P) float64
    horizon: np.ndarray           # (W,) float64
    pids: Sequence[int]
    nr_max: int
    tasks: Optional[List[List[TaskRecord]]] = None

    @property
    def width(self) -> int:
        return len(self.lanes)

    def makespans(self, lane: int, group: Optional[int] = None) -> List[float]:
        """Per-request makespans of one lane, reference ordering."""
        out: List[float] = []
        nr = int(self.num_requests[lane])
        for gid in range(len(self.groups)):
            if group is not None and gid != group:
                continue
            for rid in range(nr):
                rr = gid * self.nr_max + rid
                if self.done[lane, rr] < self.group_tasks[lane, gid]:
                    out.append(float("inf"))
                else:
                    out.append(
                        self.last_finish[lane, rr]
                        - min(self.first_start[lane, rr], self.arrival[lane, rr])
                    )
        return out

    def result(self, lane: int) -> SimResult:
        """Reconstruct the lane's :class:`SimResult` (golden-trace fidelity)."""
        requests: List[RequestRecord] = []
        nr = int(self.num_requests[lane])
        for gid in range(len(self.groups)):
            for rid in range(nr):
                rr = gid * self.nr_max + rid
                requests.append(RequestRecord(
                    group=gid, request=rid,
                    arrival=float(self.arrival[lane, rr]),
                    first_start=float(self.first_start[lane, rr]),
                    last_finish=float(self.last_finish[lane, rr]),
                    done_tasks=int(self.done[lane, rr]),
                    total_tasks=int(self.group_tasks[lane, gid]),
                ))
        return SimResult(
            requests=requests,
            tasks=list(self.tasks[lane]) if self.tasks is not None else [],
            busy_time={pid: float(self.busy[lane, pid]) for pid in self.pids},
            horizon=float(self.horizon[lane]),
        )


class BatchSimulator:
    """Lock-step event engine over a batch of lanes (one shared scenario).

    All lanes must share the scenario structure (``groups`` and the
    processor set); specs, periods, request counts and noise seeds vary per
    lane. ``run()`` executes every lane to quiescence in one vectorized
    event-stepping pass and returns a :class:`BatchResult`.
    """

    def __init__(
        self,
        lanes: Sequence[BatchLane],
        groups: Sequence[Sequence[int]],
        processors: Sequence[Processor],
    ):
        if not lanes:
            raise ValueError("empty batch")
        self.lanes = list(lanes)
        self.groups = [list(g) for g in groups]
        self.processors = processors
        self.pids = [p.pid for p in processors]
        self.kind_of_pid = {p.pid: p.kind for p in processors}

    # -- batch assembly -----------------------------------------------------
    def _pad_specs(self) -> None:
        lanes = self.lanes
        W = len(lanes)
        S = max(ln.spec.num_subgraphs for ln in lanes)
        P = max(self.pids) + 1
        G = len(self.groups)
        proc_of = np.zeros((W, S), np.int64)
        prio_of = np.zeros((W, S), np.int64)
        exec_v = np.zeros((W, S))
        quant_v = np.zeros((W, S))
        comm_v = np.zeros((W, S))
        total_v = np.zeros((W, S))       # clean-lane (exec+quant)+comm
        dep_cnt = np.zeros((W, S), np.int16)
        net_of = np.zeros((W, S), np.int64)
        k_of = np.zeros((W, S), np.int64)
        dmax = 1
        jmax = 1
        for ln in lanes:
            sp = ln.spec
            n = sp.num_subgraphs
            for g in range(n):
                dmax = max(dmax, sp.succ_indptr[g + 1] - sp.succ_indptr[g])
        succ_pad = np.zeros((W, S, dmax), np.int64)
        succ_cnt = np.zeros((W, S), np.int64)
        roots_l: List[List[List[int]]] = []
        for b, ln in enumerate(lanes):
            sp = ln.spec
            n = sp.num_subgraphs
            proc_of[b, :n] = sp.proc_of
            prio_of[b, :n] = sp.prio_of
            exec_v[b, :n] = sp.exec_
            quant_v[b, :n] = sp.quant
            comm_v[b, :n] = sp.comm
            dep_cnt[b, :n] = sp.dep_count
            net_of[b, :n] = sp.net_of
            k_of[b, :n] = sp.k_of
            for g in range(n):
                lo, hi = sp.succ_indptr[g], sp.succ_indptr[g + 1]
                succ_cnt[b, g] = hi - lo
                succ_pad[b, g, :hi - lo] = sp.succ_flat[lo:hi]
            # same float expression as the per-solution loop:
            # total = exec + quant + comm (left to right)
            for g in range(n):
                total_v[b, g] = sp.exec_[g] + sp.quant[g] + (
                    0.0 if ln.overlap_comm else sp.comm[g])
            spec_roots = sp.roots()
            per_g: List[List[int]] = []
            for nets in self.groups:
                rl: List[int] = []
                for net in nets:
                    rl.extend(spec_roots[net])
                per_g.append(rl)
                jmax = max(jmax, len(rl))
            roots_l.append(per_g)
        roots = np.zeros((W, G, jmax), np.int64)
        roots_n = np.zeros((W, G), np.int64)
        group_tasks = np.zeros((W, G), np.int64)
        for b, per_g in enumerate(roots_l):
            sp = lanes[b].spec
            for gi, rl in enumerate(per_g):
                roots[b, gi, :len(rl)] = rl
                roots_n[b, gi] = len(rl)
                group_tasks[b, gi] = sum(sp.counts[n] for n in self.groups[gi])
        return (W, S, P, G, proc_of, prio_of, exec_v, quant_v, comm_v,
                total_v, dep_cnt, net_of, k_of, succ_pad, succ_cnt, dmax,
                roots, roots_n, jmax, group_tasks)

    # -- the lock-step pass -------------------------------------------------
    def run(self, collect_tasks: bool = False) -> BatchResult:
        (W, S, P, G, proc_of, prio_of, exec_v, quant_v, comm_v, total_v,
         dep_cnt, net_of, k_of, succ_pad, succ_cnt, dmax, roots, roots_n,
         jmax, group_tasks) = self._pad_specs()
        lanes = self.lanes
        groups = self.groups

        nr = np.array([ln.num_requests for ln in lanes], np.int64)
        nr_max = int(nr.max())
        periods = np.zeros((W, G))
        horizon = np.zeros(W)
        # per-lane arrival tables: the identical timestamps every other
        # engine tier draws for the lane's (arrivals, periods, num_requests)
        arrtab = np.zeros((W, G, max(nr_max, 1)))
        for b, ln in enumerate(lanes):
            periods[b] = ln.periods
            tables = draw_arrivals(ln.arrivals, ln.periods, ln.num_requests)
            for gi, tab in enumerate(tables):
                arrtab[b, gi, :len(tab)] = tab
            # same float expression as the per-solution engines
            horizon[b] = arrival_horizon(tables, ln.periods, ln.num_requests)
        dispatch_ov = np.array([ln.dispatch_overhead for ln in lanes])
        dispatch_pid = np.array([ln.dispatch_pid for ln in lanes], np.int64)
        dispatch_known = (dispatch_ov > 0) & np.isin(dispatch_pid,
                                                     np.array(self.pids))
        any_dispatch = bool(dispatch_known.any())

        # per-lane noise state: sigma/mu per pid, a standard-normal table
        # drawn from random.Random(seed).gauss (parameter-independent, so
        # the k-th draw matches the per-solution stream exactly), and a
        # cursor of consumed draws.
        noisy = np.zeros(W, bool)
        sigma_of = np.zeros((W, P))
        mu_of = np.zeros((W, P))
        rngs: List[Optional[random.Random]] = [None] * W
        for b, ln in enumerate(lanes):
            if ln.noise is not None:
                noisy[b] = True
                rngs[b] = random.Random(ln.noise.seed)
                for p in self.processors:
                    s = ln.noise.sigma(p.kind)
                    sigma_of[b, p.pid] = s
                    mu_of[b, p.pid] = -0.5 * s * s
        any_noise = bool(noisy.any())
        # One standard-normal draw is consumed per delivered task on a
        # noisy processor, and deliveries are bounded by the total task
        # count, so the whole per-lane stream can be drawn upfront (the
        # per-solution loop draws the identical values lazily). An overrun
        # is impossible by construction; if the bound were ever violated the
        # table index would raise loudly rather than desynchronize streams.
        zpos = np.zeros(W, np.int64)
        zcap = 1
        for b, ln in enumerate(lanes):
            if noisy[b]:
                zcap = max(zcap, ln.num_requests *
                           sum(ln.spec.counts[n]
                               for nets in self.groups for n in nets))
        ztab = np.zeros((W, zcap))
        for b in np.nonzero(noisy)[0]:
            rng = rngs[b]
            bound = lanes[b].num_requests * sum(
                lanes[b].spec.counts[n] for nets in self.groups for n in nets)
            ztab[b, :bound] = [rng.gauss(0.0, 1.0) for _ in range(bound)]

        # Per-lane fault streams, sampled scalar-side at delivery. The
        # lock-step drain visits each lane's deliveries in ring (= push
        # sequence) order — the same per-lane delivery order the scalar
        # engines walk, and the property the noise cursors already rely
        # on — so a live random.Random stream stays aligned; faulted
        # elements recompute exec/total with the scalar float expressions
        # for bit parity.
        fstreams: List[Optional[FaultStream]] = [None] * W
        for b, ln in enumerate(lanes):
            if ln.faults is not None and not ln.faults.empty:
                fstreams[b] = FaultStream(ln.faults)
        faulted = np.array([fs is not None for fs in fstreams], bool)
        any_fault = bool(faulted.any())

        # event frontier: per-lane candidate (time, seq) columns — one per
        # request source, one per worker completion, one for the head of the
        # pending-delivery ring. argmin over columns + seq tie-break = the
        # per-solution heap's (time, seq) pop.
        C = G + P + 1
        times = np.full((W, C), np.inf)
        seqs = np.full((W, C), _BIGSEQ, np.int64)
        seq = np.zeros(W, np.int64)
        rel_seq = np.zeros(W, np.int64)
        src_rid = np.zeros((W, G), np.int64)
        for gi in range(G):
            times[:, gi] = 0.0
            seqs[:, gi] = seq
            seq += 1
        idle = np.zeros((W, P), bool)
        idle[:, self.pids] = True
        end_g = np.full((W, P), -2, np.int64)
        end_rr = np.full((W, P), -1, np.int64)
        end_rec = np.full((W, P), -1, np.int64)

        R = G * nr_max
        arrival = np.zeros((W, R))
        first_start = np.full((W, R), np.inf)
        last_finish = np.zeros((W, R))
        done = np.zeros((W, R), np.int64)
        pend = np.zeros((W, R, S), np.int16)
        busy = np.zeros((W, P))

        # per-(lane, pid) ready queues: packed priority keys + payloads.
        # Capacity grows on demand; starts at a bound comfortable for GA
        # workloads (queues only grow under persistent overload). ``qn``
        # counts filled slots so emptiness/overflow checks stay O(1).
        QC = 32
        qkey = np.full((W, P, QC), _EMPTY, np.int64)
        qg = np.full((W, P, QC), -1, np.int64)
        qrr = np.full((W, P, QC), -1, np.int64)
        qrec = np.full((W, P, QC), -1, np.int64)
        qn = np.zeros((W, P), np.int64)
        overlap = np.array([ln.overlap_comm for ln in lanes], bool)

        K = P + 1  # pending deliveries mark their worker busy: at most P
        del_seq = np.full((W, K), _BIGSEQ, np.int64)
        del_pid = np.zeros((W, K), np.int64)
        del_g = np.zeros((W, K), np.int64)
        del_rr = np.zeros((W, K), np.int64)
        del_rec = np.full((W, K), -1, np.int64)
        del_n = np.zeros(W, np.int64)

        # optional task-trace collection (golden tests): python-side lists,
        # appended in release order like the reference engines.
        tasks: Optional[List[List[TaskRecord]]] = (
            [[] for _ in range(W)] if collect_tasks else None)

        def grow_queues() -> None:
            nonlocal qkey, qg, qrr, qrec, QC
            QC2 = QC * 2
            nk = np.full((W, P, QC2), _EMPTY, np.int64)
            nk[:, :, :QC] = qkey
            ng = np.full((W, P, QC2), -1, np.int64)
            ng[:, :, :QC] = qg
            nrr = np.full((W, P, QC2), -1, np.int64)
            nrr[:, :, :QC] = qrr
            nrec = np.full((W, P, QC2), -1, np.int64)
            nrec[:, :, :QC] = qrec
            qkey, qg, qrr, qrec, QC = nk, ng, nrr, nrec, QC2

        def append_deliver(bi: np.ndarray, pid: np.ndarray, g: np.ndarray,
                           rr: np.ndarray, rec: Optional[np.ndarray],
                           t: np.ndarray) -> None:
            """Hand items to (idle, now-busy) workers: push deliver events."""
            idle[bi, pid] = False
            pos = del_n[bi]
            del_seq[bi, pos] = seq[bi]
            del_pid[bi, pos] = pid
            del_g[bi, pos] = g
            del_rr[bi, pos] = rr
            if rec is not None:
                del_rec[bi, pos] = rec
            was_empty = pos == 0
            del_n[bi] += 1
            seq[bi] += 1
            we = bi[was_empty]
            if we.size:
                times[we, C - 1] = t[was_empty]
                seqs[we, C - 1] = del_seq[we, 0]

        def queue_push(bi: np.ndarray, pid: np.ndarray, key: np.ndarray,
                       g: np.ndarray, rr: np.ndarray,
                       rec: Optional[np.ndarray]) -> None:
            while qn[bi, pid].max() >= QC:
                grow_queues()
            slot = np.argmax(qkey[bi, pid] == _EMPTY, axis=1)
            qkey[bi, pid, slot] = key
            qg[bi, pid, slot] = g
            qrr[bi, pid, slot] = rr
            qn[bi, pid] += 1
            if rec is not None:
                qrec[bi, pid, slot] = rec

        def release(bi: np.ndarray, g: np.ndarray, rr: np.ndarray,
                    gid: np.ndarray, rid: np.ndarray,
                    t: np.ndarray) -> None:
            """Release one task per lane of ``bi`` (reference `release()`)."""
            rec = None
            if collect_tasks:
                rec = np.empty(len(bi), np.int64)
                for i, b in enumerate(bi):
                    lane_tasks = tasks[b]
                    rec[i] = len(lane_tasks)
                    lane_tasks.append(TaskRecord(
                        group=int(gid[i]), request=int(rid[i]),
                        network=int(net_of[b, g[i]]),
                        sg_index=int(k_of[b, g[i]]),
                        processor=int(proc_of[b, g[i]]),
                        released=float(t[i]),
                    ))
            if any_dispatch:
                dk = dispatch_known[bi]
                db = bi[dk]
                if db.size:
                    rel_seq[db] += 1
                    dpid = dispatch_pid[db]
                    d_idle = idle[db, dpid]
                    di = db[d_idle]
                    if di.size:
                        append_deliver(di, dpid[d_idle],
                                       np.full(di.size, -1, np.int64),
                                       np.full(di.size, -1, np.int64),
                                       None, t[dk][d_idle])
                    qi = db[~d_idle]
                    if qi.size:
                        queue_push(qi, dpid[~d_idle], rel_seq[qi],
                                   np.full(qi.size, -1, np.int64),
                                   np.full(qi.size, -1, np.int64), None)
            rel_seq[bi] += 1
            pid = proc_of[bi, g]
            is_idle = idle[bi, pid]
            di = bi[is_idle]
            if di.size:
                append_deliver(di, pid[is_idle], g[is_idle], rr[is_idle],
                               rec[is_idle] if rec is not None else None,
                               t[is_idle])
            qi = bi[~is_idle]
            if qi.size:
                key = (_CLS_SHIFT + prio_of[qi, g[~is_idle]] * _PRIO_SHIFT
                       + rel_seq[qi])
                queue_push(qi, pid[~is_idle], key, g[~is_idle], rr[~is_idle],
                           rec[~is_idle] if rec is not None else None)

        def pull_next(bi: np.ndarray, pid: np.ndarray,
                      t: np.ndarray) -> None:
            """Workers that just finished pop their queues or go idle."""
            has = qn[bi, pid] > 0
            hb, hp = bi[has], pid[has]
            if hb.size:
                slot = qkey[hb, hp].argmin(axis=1)
                g = qg[hb, hp, slot]
                rr = qrr[hb, hp, slot]
                rec = qrec[hb, hp, slot]
                qkey[hb, hp, slot] = _EMPTY
                qn[hb, hp] -= 1
                # the worker stays busy while its deliver is pending;
                # append_deliver keeps idle False.
                append_deliver(hb, hp, g, rr,
                               rec if collect_tasks else None, t[has])
            ib, ip = bi[~has], pid[~has]
            if ib.size:
                idle[ib, ip] = True

        while True:
            # -- frontier selection: per-lane earliest (time, seq) event ----
            tmin = np.min(times, axis=1)
            smask = np.where(times == tmin[:, None], seqs, _BIGSEQ)
            ci = smask.argmin(axis=1)
            act = tmin <= horizon
            if not act.any():
                break
            now = tmin

            # -- request arrivals ------------------------------------------
            bi = np.nonzero(act & (ci < G))[0]
            if bi.size:
                gid = ci[bi]
                rid = src_rid[bi, gid]
                t = now[bi]
                # rid-0 deferral: a non-zero first arrival re-arms the source
                # column (the reference source's init-then-timeout order)
                a0 = arrtab[bi, gid, 0]
                defer = (rid == 0) & (a0 > t)
                db = bi[defer]
                if db.size:
                    dg = gid[defer]
                    td = t[defer]
                    times[db, dg] = td + (a0[defer] - td)
                    seqs[db, dg] = seq[db]
                    seq[db] += 1
                    bi, gid, rid, t = (bi[~defer], gid[~defer], rid[~defer],
                                       t[~defer])
            if bi.size:
                rr = gid * nr_max + rid
                arrival[bi, rr] = t
                pend[bi, rr] = dep_cnt[bi]
                for j in range(jmax):
                    mj = j < roots_n[bi, gid]
                    if not mj.any():
                        break
                    bj = bi[mj]
                    release(bj, roots[bi, gid, j][mj], rr[mj], gid[mj],
                            rid[mj], t[mj])
                nrid = rid + 1
                has = nrid < nr[bi]
                hb = bi[has]
                if hb.size:
                    hg = gid[has]
                    tn = t[has]
                    arr = arrtab[hb, hg, nrid[has]]
                    # reference: push(.., now + (arrival - now), ..)
                    times[hb, hg] = tn + (arr - tn)
                    seqs[hb, hg] = seq[hb]
                    seq[hb] += 1
                    src_rid[hb, hg] = nrid[has]
                xb = bi[~has]
                if xb.size:
                    times[xb, gid[~has]] = np.inf
                    seqs[xb, gid[~has]] = _BIGSEQ

            # -- worker completions ----------------------------------------
            bi = np.nonzero(act & (ci >= G) & (ci < G + P))[0]
            if bi.size:
                pid = ci[bi] - G
                g = end_g[bi, pid]
                rr = end_rr[bi, pid]
                t = now[bi]
                if collect_tasks:
                    for i, b in enumerate(bi):
                        ri = end_rec[b, pid[i]]
                        if ri >= 0:
                            tasks[b][ri].finished = float(t[i])
                    end_rec[bi, pid] = -1
                real = g >= 0  # dispatch-token completions carry no task
                rb = bi[real]
                if rb.size:
                    rrr = rr[real]
                    done[rb, rrr] += 1
                    last_finish[rb, rrr] = np.maximum(
                        last_finish[rb, rrr], t[real])
                    gr = g[real]
                    gid_r = rrr // nr_max
                    rid_r = rrr - gid_r * nr_max
                    for j in range(dmax):
                        mj = j < succ_cnt[rb, gr]
                        if not mj.any():
                            break
                        bj = rb[mj]
                        sj = succ_pad[rb, gr, j][mj]
                        rrj = rrr[mj]
                        pj = pend[bj, rrj, sj] - np.int16(1)
                        pend[bj, rrj, sj] = pj
                        zero = pj == 0
                        if zero.any():
                            release(bj[zero], sj[zero], rrj[zero],
                                    gid_r[mj][zero], rid_r[mj][zero],
                                    t[real][mj][zero])
                times[bi, G + pid] = np.inf
                seqs[bi, G + pid] = _BIGSEQ
                end_g[bi, pid] = -2
                pull_next(bi, pid, t)

            # -- delivery drain: all pending deliveries of selected lanes --
            # When a lane's earliest event is its delivery-ring head, every
            # pending delivery of that lane precedes all other events (they
            # share the current time and carry the smallest sequence
            # numbers), so the whole ring drains in ring (= seq) order.
            bi = np.nonzero(act & (ci == C - 1))[0]
            if bi.size:
                t = now[bi]
                nact = int(del_n[bi].max())
                for j in range(nact):
                    mj = j < del_n[bi]
                    bj = bi[mj]
                    pidj = del_pid[bj, j]
                    gj = del_g[bj, j]
                    rrj = del_rr[bj, j]
                    tj = t[mj]
                    disp = gj < 0
                    db = bj[disp]
                    if db.size:
                        ov = dispatch_ov[db]
                        busy[db, pidj[disp]] += ov
                        times[db, G + pidj[disp]] = tj[disp] + ov
                        seqs[db, G + pidj[disp]] = seq[db]
                        seq[db] += 1
                        end_g[db, pidj[disp]] = -1
                    rb = bj[~disp]
                    if rb.size:
                        pidr = pidj[~disp]
                        gr = gj[~disp]
                        rrr = rrj[~disp]
                        tr = tj[~disp]
                        exec_t = exec_v[rb, gr]
                        total = total_v[rb, gr]
                        if any_noise:
                            draw = noisy[rb] & (sigma_of[rb, pidr] > 0.0)
                            nb = rb[draw]
                            if nb.size:
                                sg = sigma_of[nb, pidr[draw]]
                                z = ztab[nb, zpos[nb]]
                                zpos[nb] += 1
                                arg = mu_of[nb, pidr[draw]] + z * sg
                                mult = np.array(
                                    [math.exp(a) for a in arg.tolist()])
                                et = exec_t[draw] * mult
                                exec_t = exec_t.copy()
                                exec_t[draw] = et
                                tt = total.copy()
                                # same order as the scalar loop:
                                # exec + quant + (0 | comm)
                                cmv = np.where(
                                    overlap[nb], 0.0, comm_v[nb, gr[draw]])
                                tt[draw] = et + quant_v[nb, gr[draw]] + cmv
                                total = tt
                        if any_fault:
                            fmask = faulted[rb]
                            if fmask.any():
                                exec_t = exec_t.copy()
                                total = total.copy()
                                for i in np.nonzero(fmask)[0]:
                                    b = int(rb[i])
                                    et, stall = fstreams[b].service(
                                        int(pidr[i]), float(tr[i]),
                                        float(exec_t[i]))
                                    # scalar float order of the per-solution
                                    # loop: exec + quant + (0 | comm), then
                                    # stall + total
                                    cmv = (0.0 if overlap[b]
                                           else float(comm_v[b, gr[i]]))
                                    tt = et + float(quant_v[b, gr[i]]) + cmv
                                    if stall > 0.0:
                                        tt = stall + tt
                                    exec_t[i] = et
                                    total[i] = tt
                        if collect_tasks:
                            for i, b in enumerate(rb):
                                ri = del_rec[b, j]
                                if ri >= 0:
                                    trec = tasks[b][ri]
                                    trec.comm_time = float(comm_v[b, gr[i]])
                                    trec.quant_time = float(quant_v[b, gr[i]])
                                    trec.exec_time = float(exec_t[i])
                                    trec.started = float(tr[i])
                                end_rec[b, pidr[i]] = ri
                        first_start[rb, rrr] = np.minimum(
                            first_start[rb, rrr], tr)
                        if any_fault:
                            # permanent-dropout stalls are infinite: the
                            # worker's completion never fires (identical to
                            # the scalar engines) and busy must not go inf
                            fin = np.isfinite(total)
                            busy[rb[fin], pidr[fin]] += total[fin]
                        else:
                            busy[rb, pidr] += total
                        times[rb, G + pidr] = tr + total
                        seqs[rb, G + pidr] = seq[rb]
                        seq[rb] += 1
                        end_g[rb, pidr] = gr
                        end_rr[rb, pidr] = rrr
                del_seq[bi] = _BIGSEQ
                del_rec[bi] = -1
                del_n[bi] = 0
                times[bi, C - 1] = np.inf
                seqs[bi, C - 1] = _BIGSEQ

        return BatchResult(
            lanes=lanes, groups=groups, num_requests=nr, arrival=arrival,
            first_start=first_start, last_finish=last_finish, done=done,
            group_tasks=group_tasks, busy=busy, horizon=horizon,
            pids=self.pids, nr_max=nr_max, tasks=tasks,
        )


# -- batched objective extraction -------------------------------------------

def batch_objectives(
    result: BatchResult,
    cap: float = 1e6,
) -> List[Tuple[float, ...]]:
    """Per-lane GA objectives, bit-identical to ``StaticAnalyzer.objectives``.

    For every lane and model group: (mean makespan, 90th-percentile
    makespan), makespans capped at ``cap`` first (the analyzer's finite
    stand-in for dropped requests). Uses the same sequential-sum mean and
    interpolated percentile as the scalar code path — ``np.mean``'s pairwise
    summation would differ in the last ulp.
    """
    from .scoring import percentile

    out: List[Tuple[float, ...]] = []
    G = len(result.groups)
    for lane in range(result.width):
        objs: List[float] = []
        for gid in range(G):
            ms = [min(m, cap) for m in result.makespans(lane, gid)]
            objs.append(sum(ms) / len(ms))
            objs.append(percentile(ms, 90.0))
        out.append(tuple(objs))
    return out


# -- process-pool sharding ---------------------------------------------------

#: Minimum lane count before ``run_batch`` actually shards across worker
#: processes. Below this width the in-process lock-step pass wins: at GA
#: widths (~80 lanes) the measured sharded path is *slower* than in-process
#: (BENCH_simspeed.json: ``eval_us_batch_sharded`` 6053 vs
#: ``eval_us_batch_inprocess`` 4062 µs — pickling lanes + stitching results
#: costs more than the pass itself), so ``batch_workers > 1`` silently fell
#: into a regression. The threshold is recorded alongside both measurements
#: in the simspeed section; pass ``shard_min_lanes=0`` to force sharding.
SHARD_MIN_LANES = 256


def spawn_pool(workers: int):
    """A process pool whose workers start from a fresh interpreter: a forked
    child would inherit the parent's threads and CUDA state half-copied (the
    reference forks)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))


def _run_shard(args: Tuple) -> Tuple:
    """Worker entry: run one lock-step pass over a shard of lanes."""
    lanes, groups, processors, collect_tasks = args
    res = BatchSimulator(lanes, groups, processors).run(
        collect_tasks=collect_tasks)
    return (res.num_requests, res.arrival, res.first_start, res.last_finish,
            res.done, res.group_tasks, res.busy, res.horizon, res.tasks,
            res.nr_max)


def run_batch(
    lanes: Sequence[BatchLane],
    groups: Sequence[Sequence[int]],
    processors: Sequence[Processor],
    collect_tasks: bool = False,
    workers: int = 1,
    pool: Optional[object] = None,
    engine: str = "numpy",
    shard_min_lanes: Optional[int] = None,
    device: Optional[Union[str, "torch.device"]] = None,
) -> BatchResult:
    """Run a batch, optionally sharded across a process pool.

    Lanes are independent, so sharding changes wall-clock only — every
    lane's result is bit-identical for any ``workers``. ``pool`` may supply
    a live ``ProcessPoolExecutor`` to amortize startup across calls;
    otherwise one is created per call when ``workers > 1``. Sharding only
    engages at ``shard_min_lanes`` (default :data:`SHARD_MIN_LANES`) lanes
    and up — below the measured crossover the in-process pass is faster.

    ``engine`` selects the lock-step backend: ``"numpy"`` (default, the
    bit-exact parity tier) or ``"compiled"`` (the event-loop kernel from
    :mod:`repro_torch.core.batchsim_compiled` on ``device``, documented
    float tolerance; ``device=None`` is the card, and the CPU runs the plain
    pass only for ``device="cpu"``). The compiled backend runs in-process;
    before it launches anything it declines, counted by reason, a batch that
    needs what it does not support (``collect_tasks``) or whose queue bound
    passes its fixed ring capacity, and such a batch runs on numpy.
    """
    if engine == "compiled":
        from .batchsim_compiled import run_batch_compiled

        res = run_batch_compiled(lanes, groups, processors,
                                 collect_tasks=collect_tasks, device=device)
        if res is not None:
            return res
        # declined before launch: the bit-exact numpy tier
    elif engine != "numpy":
        raise ValueError(f"unknown batch engine {engine!r}")
    min_lanes = SHARD_MIN_LANES if shard_min_lanes is None else shard_min_lanes
    if workers <= 1 or len(lanes) < max(2 * workers, min_lanes):
        return BatchSimulator(lanes, groups, processors).run(
            collect_tasks=collect_tasks)
    shards: List[Sequence[BatchLane]] = [
        lanes[i::workers] for i in range(workers)]
    shards = [s for s in shards if s]
    args = [(list(s), groups, processors, collect_tasks) for s in shards]
    own_pool = pool is None
    if own_pool:
        pool = spawn_pool(len(shards))
    try:
        parts = list(pool.map(_run_shard, args))
    finally:
        if own_pool:
            pool.shutdown()

    # stitch interleaved shards back into lane order
    W = len(lanes)
    G = len(groups)
    nr_max = max(p[9] for p in parts)
    R = G * nr_max
    P = max(p.pid for p in processors) + 1
    nr = np.zeros(W, np.int64)
    arrival = np.zeros((W, R))
    first_start = np.full((W, R), np.inf)
    last_finish = np.zeros((W, R))
    done = np.zeros((W, R), np.int64)
    group_tasks = np.zeros((W, G), np.int64)
    busy = np.zeros((W, P))
    horizon = np.zeros(W)
    tasks: Optional[List[List[TaskRecord]]] = (
        [[] for _ in range(W)] if collect_tasks else None)
    for si, part in enumerate(parts):
        (p_nr, p_arr, p_fs, p_lf, p_done, p_gt, p_busy, p_hor, p_tasks,
         p_nrm) = part
        lane_ids = list(range(si, W, len(parts)))[:p_nr.shape[0]]
        for li, b in enumerate(lane_ids):
            nr[b] = p_nr[li]
            for gid in range(G):
                lo_s, lo_d = gid * p_nrm, gid * nr_max
                n = int(p_nr[li])
                arrival[b, lo_d:lo_d + n] = p_arr[li, lo_s:lo_s + n]
                first_start[b, lo_d:lo_d + n] = p_fs[li, lo_s:lo_s + n]
                last_finish[b, lo_d:lo_d + n] = p_lf[li, lo_s:lo_s + n]
                done[b, lo_d:lo_d + n] = p_done[li, lo_s:lo_s + n]
            group_tasks[b] = p_gt[li]
            busy[b] = p_busy[li]
            horizon[b] = p_hor[li]
            if collect_tasks:
                tasks[b] = p_tasks[li]
    return BatchResult(
        lanes=lanes, groups=[list(g) for g in groups], num_requests=nr,
        arrival=arrival, first_start=first_start, last_finish=last_finish,
        done=done, group_tasks=group_tasks, busy=busy, horizon=horizon,
        pids=[p.pid for p in processors], nr_max=nr_max, tasks=tasks,
    )
