"""Scenario construction: model groups, periods, random scenario generation
(paper §6.1, Fig. 11).

A *model group* is a set of models triggered together by one input source
(camera, microphone). The group's *base period* is

    φ̄_G = Σ_{m∈G} min_p τ_p(m) · N · (1 + ε)

with N the number of groups and ε = 0.1; the evaluated period is
Φ = α · φ̄_G for a period multiplier α. The group's request *arrival
process* defaults to strictly periodic at Φ (the paper's sources) but is
pluggable per scenario — see :class:`~repro_torch.core.arrivals.ArrivalSpec` for
the jittered / Poisson / trace processes; Φ stays the mean inter-arrival
interval and the per-request relative deadline in every case.

Copy of ``repro.core.scenarios``, verbatim.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .arrivals import ArrivalSpec
from .chromosome import BACKENDS, DTYPES, PlacedSubgraph
from .faults import FaultSpec
from .graph import ModelGraph
from .processors import Processor
from .profiler import Profiler

EPSILON = 0.1


@dataclass(frozen=True)
class Scenario:
    """A workload: model graphs partitioned into synchronized groups.

    ``arrival`` selects the request arrival process shared by all of the
    scenario's groups (``None`` = periodic at each group's period Φ —
    byte-identical to the pre-arrival-layer behavior). The evaluation
    stack (``StaticAnalyzer``, the batched engine, the virtual-clock
    runtime) reads it from here, so one scenario object fully describes
    the workload.

    ``faults`` injects a deterministic fault ensemble (processor dropouts,
    throttle windows, stragglers — :class:`~repro_torch.core.faults.FaultSpec`)
    into every simulation of the scenario; ``None`` = clean. A scenario
    with faults makes the GA optimize under the ensemble — the robustness
    objective — since the analyzer threads it through all evaluation paths.
    """

    name: str
    graphs: Tuple[ModelGraph, ...]
    groups: Tuple[Tuple[int, ...], ...]   # per group: indices into graphs
    arrival: Optional[ArrivalSpec] = None
    faults: Optional[FaultSpec] = None

    @property
    def num_groups(self) -> int:
        return len(self.groups)


def whole_model_placement(
    graph: ModelGraph, net: int, processor: int, dtype_ix: int, backend_ix: int
) -> PlacedSubgraph:
    """The model as a single un-partitioned subgraph on one processor."""
    sg = graph.partition([0] * graph.num_edges)[0]
    return PlacedSubgraph(
        subgraph=sg, network=net, processor=processor,
        dtype=DTYPES[dtype_ix], backend=BACKENDS[backend_ix], priority=net,
    )


def best_model_times(
    graphs: Sequence[ModelGraph],
    processors: Sequence[Processor],
    profiler: Profiler,
) -> List[Dict[int, Tuple[float, int, int]]]:
    """For each network and processor: (best time, dtype_ix, backend_ix).

    Times are in **seconds** (the profiler's native unit; the paper's tables
    are milliseconds). This is the paper's per-model profiling step used both
    for base periods (min over processors) and by the Best Mapping baseline.
    Deterministic: the profiler caches by profile key, so repeated calls
    return identical values.
    """
    out: List[Dict[int, Tuple[float, int, int]]] = []
    for net, g in enumerate(graphs):
        per_proc: Dict[int, Tuple[float, int, int]] = {}
        for proc in processors:
            best: Optional[Tuple[float, int, int]] = None
            for di in range(len(DTYPES)):
                for bi in range(len(BACKENDS)):
                    t = profiler.subgraph_time(
                        whole_model_placement(g, net, proc.pid, di, bi)
                    )
                    if best is None or t < best[0]:
                        best = (t, di, bi)
            assert best is not None
            per_proc[proc.pid] = best
        out.append(per_proc)
    return out


def base_periods(
    scenario: Scenario,
    best_times: Sequence[Dict[int, Tuple[float, int, int]]],
    epsilon: float = EPSILON,
) -> List[float]:
    """φ̄ per group in **seconds** (paper §6.1).

    ``φ̄_G = Σ_{m∈G} min_p τ_p(m) · N · (1 + ε)`` with N the number of
    groups in the scenario and ε the slack factor (paper: 0.1).
    ``best_times`` is the output of :func:`best_model_times` (seconds).
    """
    n = scenario.num_groups
    periods = []
    for group in scenario.groups:
        s = sum(min(t for t, _, _ in best_times[m].values()) for m in group)
        periods.append(s * n * (1 + epsilon))
    return periods


def sample_groups(
    rng: random.Random,
    model_names: Sequence[str],
    min_groups: int = 1,
    max_groups: int = 3,
    min_models: int = 1,
    max_models: int = 4,
) -> List[Tuple[str, ...]]:
    """Sample one random scenario composition (paper §6.1 recipe).

    Draws a group count uniformly from ``[min_groups, max_groups]``, then for
    each group a model count uniformly from ``[min_models, max_models]`` and
    that many **distinct** models from ``model_names`` (models may repeat
    *across* groups — :func:`build_scenario` materializes duplicates as
    separate graph instances). All randomness comes from the caller-supplied
    ``rng``, so a given ``random.Random(seed)`` state replays the exact same
    composition; the function draws nothing from global RNG state.
    """
    groups: List[Tuple[str, ...]] = []
    for _ in range(rng.randint(min_groups, max_groups)):
        k = rng.randint(min_models, max_models)
        groups.append(tuple(rng.sample(list(model_names), k)))
    return groups


def random_scenarios(
    model_names: Sequence[str],
    count: int = 10,
    models_per_scenario: int = 6,
    num_groups: int = 1,
    seed: int = 2025,
) -> List[List[Tuple[str, ...]]]:
    """Random *fixed-size* scenario compositions (the Fig. 12/15 protocol).

    Single model group: ``num_groups=1`` with 6 models (paper §6.1).
    Multiple groups: ``num_groups=2`` with 3 models each. For the
    variable-size sweep recipe (1–3 groups × 1–4 models) see
    :func:`sample_groups` / :mod:`repro_torch.experiments`.

    Seed semantics: one ``random.Random(seed)`` stream drives all ``count``
    compositions, so scenario *i* depends on ``seed`` **and** on every draw
    before it; the same ``(model_names, count, models_per_scenario,
    num_groups, seed)`` tuple always reproduces the same list.
    """
    rng = random.Random(seed)
    per_group = models_per_scenario // num_groups
    out: List[List[Tuple[str, ...]]] = []
    for _ in range(count):
        chosen = rng.sample(list(model_names), models_per_scenario)
        groups = [
            tuple(chosen[g * per_group : (g + 1) * per_group])
            for g in range(num_groups)
        ]
        out.append(groups)
    return out


def build_scenario(
    name: str,
    group_model_names: Sequence[Sequence[str]],
    graph_factory: Dict[str, ModelGraph],
    arrival: Optional[ArrivalSpec] = None,
    faults: Optional[FaultSpec] = None,
) -> Scenario:
    """Materialize a scenario from model names; duplicates get unique graphs.

    ``group_model_names`` is a sequence of per-group name sequences (the
    shape produced by :func:`sample_groups` / :func:`random_scenarios`).
    ``arrival`` selects the scenario's request arrival process (``None`` =
    periodic); ``faults`` its injected fault ensemble (``None`` = clean).
    Deterministic: graph indices are assigned in iteration order.
    """
    graphs: List[ModelGraph] = []
    groups: List[Tuple[int, ...]] = []
    for gnames in group_model_names:
        ids = []
        for n in gnames:
            ids.append(len(graphs))
            graphs.append(graph_factory[n])
        groups.append(tuple(ids))
    return Scenario(name=name, graphs=tuple(graphs), groups=tuple(groups),
                    arrival=arrival, faults=faults)
