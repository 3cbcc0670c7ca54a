"""Heuristic baselines from the paper's evaluation (§6.1).

* **NPU Only** — every model runs un-partitioned on the NPU (the fastest
  processor for most models) with its best (dtype, backend) configuration.
* **Best Mapping** — search-based heuristic: profile each model on each
  processor, then explore whole-model mappings (no partitioning) with a
  Pareto-archive hillclimb driven by the simulator. This accounts for
  inter-model interaction but cannot split models.

Conventions shared with the rest of :mod:`repro_torch.core`: all times are in
**seconds**; ``best_times`` arguments are the output of
:func:`repro_torch.core.scenarios.best_model_times`; randomness is always drawn
from a locally constructed ``random.Random(seed)``, never from the global
RNG, so every function here is replayable from its arguments alone.

Copy of ``repro.core.baselines``, verbatim.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, List, Sequence, Tuple

from .chromosome import Solution
from .graph import ModelGraph
from .nsga import fast_non_dominated_sort

Objective = Tuple[float, ...]


def _whole_model_solution(
    graphs: Sequence[ModelGraph],
    proc_per_net: Sequence[int],
    cfg_per_net: Sequence[Tuple[int, int]],
) -> Solution:
    """Un-partitioned solution: network *n* whole on ``proc_per_net[n]`` with
    ``(dtype_ix, backend_ix) = cfg_per_net[n]``; priority = network index."""
    return Solution(
        partition=[[0] * g.num_edges for g in graphs],
        mapping=[[proc_per_net[n]] * g.num_layers for n, g in enumerate(graphs)],
        priority=list(range(len(graphs))),
        dtype=[c[0] for c in cfg_per_net],
        backend=[c[1] for c in cfg_per_net],
    )


def npu_only_solution(
    graphs: Sequence[ModelGraph],
    npu_pid: int,
    best_times: Sequence[Dict[int, Tuple[float, int, int]]],
) -> Solution:
    """All models un-partitioned on the NPU, best per-model configuration.

    Deterministic (no RNG): the (dtype, backend) choice per model is the
    argmin over profiled times on ``npu_pid`` recorded in ``best_times``.
    """
    cfgs = [(best_times[n][npu_pid][1], best_times[n][npu_pid][2]) for n in range(len(graphs))]
    return _whole_model_solution(graphs, [npu_pid] * len(graphs), cfgs)


def best_mapping_solutions(
    graphs: Sequence[ModelGraph],
    processors: Sequence[int],
    best_times: Sequence[Dict[int, Tuple[float, int, int]]],
    evaluate: Callable[[Solution], Objective],
    max_evals: int = 200,
    seed: int = 0,
) -> List[Solution]:
    """Pareto set over whole-model mappings (no partitioning).

    Starts from the per-model-fastest mapping, then explores single-model
    processor moves, keeping a Pareto archive, until no archive growth or
    the evaluation budget (``max_evals`` distinct mappings) is exhausted.

    ``evaluate`` maps a candidate :class:`Solution` to a minimized objective
    tuple (makespan statistics in seconds, as produced by
    ``StaticAnalyzer.objectives``). ``seed`` only shuffles neighbor visit
    order via a local ``random.Random(seed)``; the same ``(best_times,
    evaluate, max_evals, seed)`` always reproduces the same archive.
    """
    rng = random.Random(seed)
    n = len(graphs)

    def make(proc_per_net: Tuple[int, ...]) -> Solution:
        cfgs = [
            (best_times[m][proc_per_net[m]][1], best_times[m][proc_per_net[m]][2])
            for m in range(n)
        ]
        return _whole_model_solution(graphs, list(proc_per_net), cfgs)

    start = tuple(
        min(best_times[m], key=lambda pid: best_times[m][pid][0]) for m in range(n)
    )
    evaluated: Dict[Tuple[int, ...], Objective] = {}

    def ev(key: Tuple[int, ...]) -> Objective:
        if key not in evaluated:
            evaluated[key] = evaluate(make(key))
        return evaluated[key]

    archive: List[Tuple[Tuple[int, ...], Objective]] = [(start, ev(start))]
    frontier = [start]
    while frontier and len(evaluated) < max_evals:
        base = frontier.pop(0)
        neighbors = []
        for m in range(n):
            for p in processors:
                if p != base[m]:
                    cand = tuple(p if i == m else base[i] for i in range(n))
                    neighbors.append(cand)
        rng.shuffle(neighbors)
        for cand in neighbors:
            if len(evaluated) >= max_evals:
                break
            if cand in evaluated:
                continue
            obj = ev(cand)
            fits = [o for _, o in archive] + [obj]
            fronts = fast_non_dominated_sort(fits)
            if len(archive) in fronts[0]:
                # candidate is non-dominated: rebuild archive from front 0
                items = archive + [(cand, obj)]
                archive = [items[i] for i in fronts[0]]
                # prune keys whose archive entries the candidate just
                # dominated — expanding them would spend the evaluation
                # budget on neighborhoods of dead mappings. cand itself is
                # fresh (it was absent from `evaluated`), so this append
                # cannot duplicate a frontier entry.
                live = {k for k, _ in archive}
                frontier = [k for k in frontier if k in live]
                frontier.append(cand)
    sols = []
    for key, obj in archive:
        s = make(key)
        s.fitness = obj
        sols.append(s)
    return sols
