"""Static feasibility analysis of decoded solutions — zero simulation.

Three families of checks over a candidate schedule:

* **Structural** (SL001–SL004): chromosome shape/range validity, priority
  permutation consistency, and — for decoded subgraph lists — layer
  ownership integrity and acyclicity of the contracted subgraph DAG.
* **Capability** (SL010): per-network ``(dtype, backend)`` configurations
  the mapped processor does not support. *Warning only*: the simulator
  handles these via the profiler's fallback penalty (``Processor
  .fallback_penalty``), so they are slow, never infeasible.
* **Resource proofs** (SL020, SL030, SL031): chunk-rounded peak-memory
  bounds against per-processor capacities, and deadline lower bounds
  (critical path, per-request serialization, per-processor utilization)
  from ProfileDB costs that prove a ``(solution, α)`` pair unsatisfiable.

Soundness contract
------------------
Every ``proof=True`` error is a guarantee the simulator can never
contradict:

* **SL020** — the memory model is *static provisioning*: a processor holds
  the weights of every subgraph mapped to it plus one activation arena
  sized for its largest task (input + output), all chunk-rounded exactly
  like :class:`~repro_torch.runtime.tensorpool.TensorPool`. A flagged pid cannot
  provision through a capacity-bounded pool (:func:`provision_memory`
  raises ``TensorPoolOOM`` — the differential suite asserts this).
* **SL030/SL031** — every per-task service-time term in the bounds is a
  floor of what any engine realizes: comm/quant are exact and never
  noised; exec is scaled by :meth:`ScheduleLinter.exec_floor`, the provable
  minimum of the deterministic lognormal noise stream times the smallest
  throttle factor (stragglers and dropout stalls only *add* time). A
  ``PROOF_MARGIN`` relative slack absorbs float-summation-order
  differences between the bound and the engines' event arithmetic. A
  critical-path violation means *every* request of the group misses (QoE
  = 0); a utilization violation means at least one request misses — both
  imply a scenario score strictly below the saturation threshold, and the
  implication is only claimed when the group/request count makes it valid.
* **SL001–SL004** — the chromosome cannot be decoded/simulated at all
  (shape or ownership corruption), or its dependency structure deadlocks
  (quotient cycle: the cyclic tasks are never released, so their group
  never completes a request). Solutions produced by
  :class:`~repro_torch.core.chromosome.SolutionFactory` never trigger these.

Anything the analyzer cannot *prove* is not reported as an error, so a
feasible schedule is never pruned — enforced end-to-end by
``tests/test_schedlint.py``'s differential sweep.

Copy of ``repro.analysis.schedlint``; :func:`provision_memory` provisions
through the port's device-memory TensorPool.
"""
from __future__ import annotations

import math
import random
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, Tuple

if TYPE_CHECKING:  # typing-only: analysis must stay import-light
    from ..core.analyzer import StaticAnalyzer

from ..core.arrivals import ArrivalSpec, draw_arrivals
from ..core.chromosome import BACKENDS, DTYPES, PlacedSubgraph, Solution
from ..core.comm import PiecewiseLinearCommModel
from ..core.fastsim import FastSimSpec, SpecBuilder
from ..core.faults import FaultSpec
from ..core.graph import (
    ModelGraph,
    Subgraph,
    partition_quotient,
    quotient_is_acyclic,
)
from ..core.memlayout import rounded_chunk_bytes
from ..core.processors import Processor
from ..core.profiler import Profiler
from ..core.simulator import NoiseModel
from .diagnostics import ERROR, WARNING, Diagnostic, LintReport

#: Relative slack on every infeasibility inequality: the engines accumulate
#: event times in a different float-summation order than the bounds, so a
#: strict comparison could over-claim by a few ulps. 1e-6 is ~6 orders of
#: magnitude above the worst accumulated rounding error of these sums and
#: ~5 below the α lattice resolution — it costs nothing in pruning power.
PROOF_MARGIN = 1e-6

_rounded = rounded_chunk_bytes  # the TensorPool's exact chunk accounting


def structural_diagnostics(
    graph: ModelGraph, subgraphs: Sequence[Subgraph], net: int = 0
) -> List[Diagnostic]:
    """SL001/SL002 over an explicit subgraph list for one network.

    ``graph.partition`` output always passes; the checks guard hand-built
    or post-decode-corrupted subgraph lists.
    """
    out: List[Diagnostic] = []
    _owner, edges, problems = partition_quotient(graph, subgraphs)
    for msg in problems:
        out.append(Diagnostic(
            code="SL002", severity=ERROR, message=msg,
            location=(("net", net),), proof=True,
        ))
    if not problems and not quotient_is_acyclic(len(subgraphs), edges):
        out.append(Diagnostic(
            code="SL001", severity=ERROR,
            message=(f"network {graph.name}: contracted subgraph graph has "
                     f"a dependency cycle (deadlock: cyclic tasks are never "
                     f"released)"),
            location=(("net", net),), proof=True,
        ))
    return out


def memory_lower_bounds(
    placed: Sequence[Sequence[PlacedSubgraph]],
) -> Dict[int, Tuple[int, int]]:
    """Per-processor ``(weights_bytes, arena_bytes)`` residency bound.

    Static-provisioning model: weights of every subgraph mapped to a pid
    are resident for the whole run, plus one activation arena sized for the
    pid's largest task (input + output). All terms are chunk-rounded with
    the TensorPool's rounding, so the bound equals what
    :func:`provision_memory` actually acquires.
    """
    weights: Dict[int, int] = {}
    arena: Dict[int, int] = {}
    for net_placed in placed:
        for p in net_placed:
            pid = p.processor
            weights[pid] = weights.get(pid, 0) + _rounded(p.subgraph.param_bytes)
            need = (_rounded(p.subgraph.input_bytes())
                    + _rounded(p.subgraph.output_bytes()))
            if need > arena.get(pid, 0):
                arena[pid] = need
    return {pid: (weights[pid], arena.get(pid, 0)) for pid in weights}


def provision_memory(
    placed: Sequence[Sequence[PlacedSubgraph]],
    capacities: Mapping[int, int],
    *,
    device=None,
) -> Dict[int, bool]:
    """Actually provision each capacity-bounded processor's tensors through
    a :class:`~repro_torch.runtime.tensorpool.TensorPool` on ``device``
    (``None``: the card; pass ``"cpu"`` to provision host memory).

    Returns ``pid -> True`` when provisioning succeeded, ``False`` when the
    pool raised ``TensorPoolOOM``. This is the executable ground truth the
    SL020 soundness differential checks the analytic bound against.
    """
    import torch

    from ..runtime.tensorpool import TensorPool, TensorPoolOOM

    out: Dict[int, bool] = {}
    for pid, cap in capacities.items():
        if cap <= 0:
            continue
        pool = TensorPool(capacity_bytes=cap, device=device)
        held: List[torch.Tensor] = []
        arena_task: Optional[PlacedSubgraph] = None
        arena_need = -1
        ok = True
        try:
            for net_placed in placed:
                for p in net_placed:
                    if p.processor != pid:
                        continue
                    held.append(pool.acquire(
                        (max(0, int(p.subgraph.param_bytes)),), torch.uint8))
                    need = (_rounded(p.subgraph.input_bytes())
                            + _rounded(p.subgraph.output_bytes()))
                    if need > arena_need:
                        arena_need = need
                        arena_task = p
            if arena_task is not None:
                held.append(pool.acquire(
                    (max(0, int(arena_task.subgraph.input_bytes())),),
                    torch.uint8))
                held.append(pool.acquire(
                    (max(0, int(arena_task.subgraph.output_bytes())),),
                    torch.uint8))
        except TensorPoolOOM:
            ok = False
        out[pid] = ok
    return out


class ScheduleLinter:
    """Static analyzer over decoded solutions for one scenario instance.

    Shares the analyzer's :class:`~repro_torch.core.fastsim.SpecBuilder` when
    constructed via :meth:`from_analyzer`, so decode/cost work done for
    linting is reused by simulation (and vice versa).

    ``score_requests`` must be an upper bound on the ``num_requests`` of
    any measured run the deadline proofs are applied to (it bounds how many
    noise draws the exec floor must cover); ``noise_seed`` is the noise
    seed those runs use (the analyzer's scoring paths default to 0).
    """

    def __init__(
        self,
        graphs: Sequence[ModelGraph],
        groups: Sequence[Sequence[int]],
        processors: Sequence[Processor],
        profiler: Profiler,
        comm_model: PiecewiseLinearCommModel,
        base_periods: Optional[Sequence[float]] = None,
        input_home_pid: int = 0,
        noise: Optional[NoiseModel] = None,
        faults: Optional[FaultSpec] = None,
        arrival: Optional[ArrivalSpec] = None,
        threshold: float = 0.995,
        score_requests: int = 36,
        memory_capacity: Optional[Mapping[int, int]] = None,
        spec_builder: Optional[SpecBuilder] = None,
        noise_seed: int = 0,
        overlap_comm: bool = False,
    ):
        self.graphs = list(graphs)
        self.groups = [tuple(g) for g in groups]
        self.processors = list(processors)
        self.base_periods = (list(base_periods)
                             if base_periods is not None else None)
        self.noise = noise
        self.faults = None if faults is None or faults.empty else faults
        self.arrival = arrival
        self.threshold = float(threshold)
        self.score_requests = int(score_requests)
        self.noise_seed = int(noise_seed)
        self.overlap_comm = bool(overlap_comm)
        self.builder = spec_builder or SpecBuilder(
            self.graphs, self.processors, profiler, comm_model,
            input_home_pid=input_home_pid,
        )
        self._capacity: Dict[int, int] = {
            p.pid: int(p.memory_capacity) for p in self.processors
        }
        if memory_capacity:
            self._capacity.update(
                {int(k): int(v) for k, v in memory_capacity.items()})
        self._exec_floor_measured: Optional[float] = None

    @classmethod
    def from_analyzer(cls, analyzer: "StaticAnalyzer") -> "ScheduleLinter":
        """Linter sharing a :class:`~repro_torch.core.analyzer.StaticAnalyzer`'s
        scenario, periods, noise/fault/arrival context and SpecBuilder."""
        return cls(
            graphs=analyzer.scenario.graphs,
            groups=analyzer.scenario.groups,
            processors=analyzer.processors,
            profiler=analyzer.profiler,
            comm_model=analyzer.comm,
            base_periods=analyzer.base_periods,
            input_home_pid=analyzer.cfg.input_home_pid,
            noise=analyzer.cfg.noise,
            faults=analyzer.faults,
            arrival=analyzer.arrival,
            score_requests=analyzer.cfg.accurate_requests,
            spec_builder=analyzer._spec_builder,
        )

    # -- structural (SL001-SL004) -------------------------------------------
    def shape_diagnostics(self, sol: Solution) -> List[Diagnostic]:
        """SL003/SL004: raw-gene shape, range and permutation checks."""
        out: List[Diagnostic] = []
        n_nets = len(self.graphs)
        n_procs = len(self.processors)

        def bad(code: str, msg: str, **loc: object) -> None:
            out.append(Diagnostic(
                code=code, severity=ERROR, message=msg,
                location=tuple(sorted(loc.items())), proof=True,
            ))

        for field_name, genes, want_len in (
            ("partition", sol.partition, [g.num_edges for g in self.graphs]),
            ("mapping", sol.mapping, [g.num_layers for g in self.graphs]),
        ):
            if len(genes) != n_nets:
                bad("SL003", f"{field_name} covers {len(genes)} networks, "
                             f"scenario has {n_nets}")
                continue
            for net, (row, want) in enumerate(zip(genes, want_len)):
                if len(row) != want:
                    bad("SL003", f"{field_name}[{net}] has {len(row)} genes, "
                                 f"expected {want}", net=net)
                    continue
                for i, v in enumerate(row):
                    hi = 2 if field_name == "partition" else n_procs
                    if not 0 <= v < hi:
                        bad("SL003",
                            f"{field_name}[{net}][{i}] = {v} outside "
                            f"[0, {hi})", net=net)
                        break
        for field_name, genes, hi in (
            ("dtype", sol.dtype, len(DTYPES)),
            ("backend", sol.backend, len(BACKENDS)),
        ):
            if len(genes) != n_nets:
                bad("SL003", f"{field_name} covers {len(genes)} networks, "
                             f"scenario has {n_nets}")
            else:
                for net, v in enumerate(genes):
                    if not 0 <= v < hi:
                        bad("SL003", f"{field_name}[{net}] = {v} outside "
                                     f"[0, {hi})", net=net)
        if sorted(sol.priority) != list(range(n_nets)):
            bad("SL004", f"priority {sol.priority} is not a permutation of "
                         f"0..{n_nets - 1}")
        return out

    # -- capability (SL010) --------------------------------------------------
    def capability_diagnostics(
        self, placed: Sequence[Sequence[PlacedSubgraph]]
    ) -> List[Diagnostic]:
        """SL010 warnings: configurations the mapped processor cannot run
        natively. The profiler substitutes ``min(supported) ×
        fallback_penalty``, so these simulate (slowly) — never proof."""
        out: List[Diagnostic] = []
        proc_by_pid = {p.pid: p for p in self.processors}
        seen = set()
        for net, net_placed in enumerate(placed):
            for p in net_placed:
                key = (net, p.processor, p.dtype, p.backend)
                if key in seen:
                    continue
                seen.add(key)
                proc = proc_by_pid.get(p.processor)
                if proc is None or proc.thr(p.dtype, p.backend) is not None:
                    continue
                out.append(Diagnostic(
                    code="SL010", severity=WARNING,
                    message=(f"network {net}: ({p.dtype}, {p.backend}) is "
                             f"unsupported on {proc.name}; simulates at "
                             f"{proc.fallback_penalty:g}x fallback penalty"),
                    location=(("dtype", p.dtype), ("backend", p.backend),
                              ("net", net), ("processor", p.processor)),
                ))
        return out

    # -- memory (SL020) ------------------------------------------------------
    def capacities(self) -> Dict[int, int]:
        """Effective per-pid capacity (0 = unconstrained)."""
        return dict(self._capacity)

    def memory_diagnostics(
        self, placed: Sequence[Sequence[PlacedSubgraph]]
    ) -> List[Diagnostic]:
        """SL020: static-provisioning residency bound vs capacity."""
        out: List[Diagnostic] = []
        bounds = memory_lower_bounds(placed)
        for pid in sorted(bounds):
            cap = self._capacity.get(pid, 0)
            if cap <= 0:
                continue
            weights, arena = bounds[pid]
            need = weights + arena
            if need > cap:
                out.append(Diagnostic(
                    code="SL020", severity=ERROR,
                    message=(f"processor {pid}: peak residency bound "
                             f"{need} B (weights {weights} B + arena "
                             f"{arena} B, chunk-rounded) exceeds capacity "
                             f"{cap} B"),
                    location=(("capacity", cap), ("need", need),
                              ("processor", pid)),
                    proof=True,
                ))
        return out

    # -- deadline bounds (SL030/SL031) --------------------------------------
    def exec_floor(self, measured: bool = True) -> float:
        """Provable lower bound of every multiplicative exec-time factor.

        Noise: the engines draw lognormal multipliers
        ``exp(gauss(-σ²/2, σ))`` from one ``random.Random(seed)`` stream in
        delivery order. ``random.Random.gauss(mu, sigma)`` returns
        ``mu + σ·z`` with a z-stream that depends only on the seed, so the
        first ``M = score_requests × Σ layers`` possible draws (an upper
        bound on task deliveries per run) are known exactly; the floor is
        the minimum of ``exp(-σ²/2 + σ·z)`` over those draws and the
        scenario's processor-kind sigmas. Faults: throttle factors may be
        < 1 (speedup windows), so the smallest factor multiplies in;
        stragglers (Pareto ≥ 1) and dropout stalls (≥ 0) only add time.
        """
        floor = 1.0
        if measured and self.noise is not None:
            if self._exec_floor_measured is None:
                sigmas = sorted({
                    self.noise.sigma(p.kind) for p in self.processors})
                sigmas = [s for s in sigmas if s > 0.0]
                f = 1.0
                if sigmas:
                    draws = self.score_requests * max(
                        1, sum(g.num_layers for g in self.graphs))
                    rng = random.Random(self.noise_seed)
                    z_min = min(rng.gauss(0.0, 1.0) for _ in range(draws))
                    f = min(
                        min(math.exp(-0.5 * s * s + s * z_min)
                            for s in sigmas),
                        1.0,
                    )
                self._exec_floor_measured = f
            floor = self._exec_floor_measured
        if self.faults is not None and self.faults.throttles:
            floor *= min(1.0, min(
                factor for _, _, _, factor in self.faults.throttles))
        return floor

    def _service_floors(
        self, spec: FastSimSpec, measured: bool
    ) -> List[float]:
        """Per-subgraph floor of the worker service time (comm+quant+exec)."""
        floor = self.exec_floor(measured)
        comm = [0.0] * spec.num_subgraphs if self.overlap_comm else spec.comm
        return [
            c + q + x * floor
            for c, q, x in zip(comm, spec.quant, spec.exec_)
        ]

    def group_lower_bounds(
        self, spec: FastSimSpec, measured: bool = True
    ) -> Optional[List[float]]:
        """Per-group makespan lower bound: max over the group's networks of
        the subgraph-DAG critical path, and over processors of the
        request's serialized work there. ``None`` when the dependency
        structure is cyclic (structurally infeasible — lint separately)."""
        w = self._service_floors(spec, measured)
        n_nets = len(spec.counts)
        cps: List[float] = []
        for n in range(n_nets):
            lo, cnt = spec.offsets[n], spec.counts[n]
            if cnt == 0:
                cps.append(0.0)
                continue
            indeg = [spec.dep_count[lo + i] for i in range(cnt)]
            dist = [w[lo + i] for i in range(cnt)]
            ready = [i for i in range(cnt) if indeg[i] == 0]
            done = 0
            while ready:
                i = ready.pop()
                done += 1
                g = lo + i
                for s in spec.succ_flat[
                        spec.succ_indptr[g]:spec.succ_indptr[g + 1]]:
                    sl = s - lo
                    cand = dist[i] + w[s]
                    if cand > dist[sl]:
                        dist[sl] = cand
                    indeg[sl] -= 1
                    if indeg[sl] == 0:
                        ready.append(sl)
            if done != cnt:
                return None  # dependency cycle: handled by SL001
            cps.append(max(dist))
        bounds: List[float] = []
        for group in self.groups:
            lb = max((cps[n] for n in group), default=0.0)
            work: Dict[int, float] = {}
            for n in group:
                lo, cnt = spec.offsets[n], spec.counts[n]
                for g in range(lo, lo + cnt):
                    pid = spec.proc_of[g]
                    work[pid] = work.get(pid, 0.0) + w[g]
            if work:
                lb = max(lb, max(work.values()))
            bounds.append(lb)
        return bounds

    def _group_proof_valid(self) -> bool:
        # one dead group (QoE=0) caps the score at (N-1)/N; that proves
        # score < threshold only when N·(1-threshold) < 1
        return len(self.groups) * (1.0 - self.threshold) < 1.0

    def alpha_lower_bound(
        self, spec: FastSimSpec, measured: bool = True
    ) -> float:
        """Largest proven-infeasible α: for every ``α`` strictly below the
        returned value, ``score(solution, α) < threshold`` is guaranteed
        (0.0 when nothing can be proven)."""
        if self.base_periods is None or not self._group_proof_valid():
            return 0.0
        lbs = self.group_lower_bounds(spec, measured)
        if lbs is None:
            return 0.0
        out = 0.0
        for lb, phi in zip(lbs, self.base_periods):
            if phi > 0.0 and lb > 0.0:
                out = max(out, lb * (1.0 - PROOF_MARGIN) / phi)
        return out

    def deadline_diagnostics(
        self,
        spec: FastSimSpec,
        alpha: float,
        measured: bool = True,
        num_requests: Optional[int] = None,
    ) -> List[Diagnostic]:
        """SL030/SL031 proofs for one probed α (empty when unprovable)."""
        out: List[Diagnostic] = []
        if self.base_periods is None:
            return out
        lbs = self.group_lower_bounds(spec, measured)
        if lbs is None:
            return out
        if self._group_proof_valid():
            for gid, (lb, phi) in enumerate(zip(lbs, self.base_periods)):
                deadline = alpha * phi
                if deadline < lb * (1.0 - PROOF_MARGIN):
                    out.append(Diagnostic(
                        code="SL030", severity=ERROR,
                        message=(f"group {gid}: makespan lower bound "
                                 f"{lb:.6g}s exceeds the α-scaled deadline "
                                 f"{deadline:.6g}s (α={alpha:g}) — every "
                                 f"request misses"),
                        location=(("alpha", alpha), ("group", gid)),
                        proof=True,
                    ))
        nreq = int(num_requests or self.score_requests)
        n_groups = len(self.groups)
        if n_groups * nreq * (1.0 - self.threshold) >= 1.0:
            return out  # one missed request would not push score < threshold
        periods = [alpha * p for p in self.base_periods]
        if any(p <= 0.0 for p in periods):
            return out
        tables = draw_arrivals(self.arrival, periods, nreq)
        t_min = min(t[0] for t in tables)
        t_max = max(
            tables[g][i] + periods[g]
            for g in range(n_groups) for i in range(nreq)
        )
        window = t_max - t_min
        w = self._service_floors(spec, measured)
        total: Dict[int, float] = {}
        for g in range(spec.num_subgraphs):
            pid = spec.proc_of[g]
            total[pid] = total.get(pid, 0.0) + w[g]
        for pid in sorted(total):
            work = total[pid] * nreq
            if work * (1.0 - PROOF_MARGIN) > window:
                out.append(Diagnostic(
                    code="SL031", severity=ERROR,
                    message=(f"processor {pid}: {work:.6g}s of floored work "
                             f"cannot fit the {window:.6g}s arrival window "
                             f"at α={alpha:g} — at least one request "
                             f"misses"),
                    location=(("alpha", alpha), ("processor", pid)),
                    proof=True,
                ))
        return out

    # -- entry points --------------------------------------------------------
    def lint(
        self,
        sol: Solution,
        alpha: Optional[float] = None,
        measured: bool = True,
    ) -> LintReport:
        """Full static report for ``sol`` (optionally at one probed α)."""
        rep = LintReport()
        shape = self.shape_diagnostics(sol)
        rep.extend(shape)
        if shape:
            return rep  # undecodable: nothing further can be checked
        placed = self.builder.decode(sol)
        for net, g in enumerate(self.graphs):
            rep.extend(structural_diagnostics(
                g, [p.subgraph for p in placed[net]], net))
        if rep.errors():
            return rep
        rep.extend(self.capability_diagnostics(placed))
        rep.extend(self.memory_diagnostics(placed))
        spec = self.builder.build(sol)
        rep.alpha_lower_bound = self.alpha_lower_bound(spec, measured)
        if alpha is not None:
            rep.checked_alpha = alpha
            rep.extend(self.deadline_diagnostics(spec, alpha, measured))
        return rep

    def prescreen_report(self, sol: Solution) -> Optional[LintReport]:
        """α-independent verdict for the GA pre-screen: a report when the
        chromosome is *proven* infeasible, else ``None`` (simulate it)."""
        rep = LintReport()
        shape = self.shape_diagnostics(sol)
        rep.extend(shape)
        if shape:
            return rep
        placed = self.builder.decode(sol)
        for net, g in enumerate(self.graphs):
            rep.extend(structural_diagnostics(
                g, [p.subgraph for p in placed[net]], net))
        if rep.errors():
            return rep
        rep.extend(self.memory_diagnostics(placed))
        return rep if rep.infeasible else None
