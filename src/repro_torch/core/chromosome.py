"""Chromosome encoding and genetic operators (paper §4.2, Fig. 6/7); copy of
``repro.core.chromosome``.

A :class:`Solution` bundles the three chromosome types:

* ``partition`` — per-network binary arrays over edges (1 = cut);
* ``mapping``  — per-network integer arrays over layers (preferred processor);
  the subgraph's processor is the majority vote of its layers;
* ``priority`` — a permutation over networks;

plus the per-network execution *configuration* genes (data type, backend
implementation) that extend the search space to ``M × T × BE`` (Table 1).

Operators follow the paper: one-point crossover for partition/mapping,
Uniform Partially-Matched Crossover (UPMX) for priority, bit/gene-flip
mutation for the rest.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .graph import ModelGraph, Subgraph
from .processors import Processor

# Execution-configuration gene domains. These mirror ORT's (backend, dtype)
# choices on mobile; here they select the engine and compute dtype per
# subgraph.
DTYPES: Tuple[str, ...] = ("fp32", "fp16", "int8")
BACKENDS: Tuple[str, ...] = ("default", "xnnpack", "nnapi")


@dataclass
class Solution:
    """One GA individual: a complete scheduling decision for all networks."""

    partition: List[List[int]]          # per network: bit per edge
    mapping: List[List[int]]            # per network: processor id per layer
    priority: List[int]                 # permutation of network indices
    dtype: List[int]                    # per network: index into DTYPES
    backend: List[int]                  # per network: index into BACKENDS
    fitness: Optional[Tuple[float, ...]] = None  # lower is better for every axis

    def copy(self) -> "Solution":
        return Solution(
            partition=[list(p) for p in self.partition],
            mapping=[list(m) for m in self.mapping],
            priority=list(self.priority),
            dtype=list(self.dtype),
            backend=list(self.backend),
            fitness=self.fitness,
        )

    def key(self) -> Tuple:
        """Hashable chromosome identity, memoized on first call.

        The GA only mutates freshly-copied (never-yet-keyed) solutions, so
        memoization is safe; ``copy()`` deliberately does not carry the
        cache over. Do not mutate a solution after calling ``key()`` on it.
        """
        k = self.__dict__.get("_key_cache")
        if k is None:
            k = self.__dict__["_key_cache"] = (
                tuple(tuple(p) for p in self.partition),
                tuple(tuple(m) for m in self.mapping),
                tuple(self.priority),
                tuple(self.dtype),
                tuple(self.backend),
            )
        return k


def subgraph_processor(sg: Subgraph, layer_mapping: Sequence[int]) -> int:
    """Majority vote of the subgraph's layers' processor preferences (Fig. 7b)."""
    votes: Dict[int, int] = {}
    for i in sg.layer_ids:
        p = layer_mapping[i]
        votes[p] = votes.get(p, 0) + 1
    best_count = max(votes.values())
    # Deterministic tie-break: smallest processor id among the winners.
    return min(p for p, c in votes.items() if c == best_count)


@dataclass(frozen=True)
class PlacedSubgraph:
    """A subgraph with its execution decision resolved from the chromosomes."""

    subgraph: Subgraph
    network: int
    processor: int
    dtype: str
    backend: str
    priority: int

    @property
    def name(self) -> str:
        return self.subgraph.name

    def profile_key(self) -> str:
        return self.subgraph.merkle_hash(extra=(self.processor, self.dtype, self.backend))


def decode_solution(
    sol: Solution, graphs: Sequence[ModelGraph]
) -> List[List[PlacedSubgraph]]:
    """Interpret chromosomes into per-network placed subgraph lists."""
    out: List[List[PlacedSubgraph]] = []
    prio_rank = {net: r for r, net in enumerate(sol.priority)}
    for net, g in enumerate(graphs):
        sgs = g.partition(sol.partition[net])
        placed = [
            PlacedSubgraph(
                subgraph=sg,
                network=net,
                processor=subgraph_processor(sg, sol.mapping[net]),
                dtype=DTYPES[sol.dtype[net]],
                backend=BACKENDS[sol.backend[net]],
                priority=prio_rank[net],
            )
            for sg in sgs
        ]
        out.append(placed)
    return out


class SolutionFactory:
    """Creates and perturbs :class:`Solution`\\ s for a fixed problem instance."""

    def __init__(
        self,
        graphs: Sequence[ModelGraph],
        num_processors: int,
        rng: Optional[random.Random] = None,
        cut_prob: float = 0.15,
        num_dtypes: int = len(DTYPES),
        num_backends: int = len(BACKENDS),
        processors: Optional[Sequence[Processor]] = None,
    ):
        self.graphs = list(graphs)
        self.num_processors = num_processors
        self.rng = rng or random.Random(0)
        self.cut_prob = cut_prob
        self.num_dtypes = num_dtypes
        self.num_backends = num_backends
        # optional capability knowledge: lets heuristic seeds avoid pinning
        # a processor to a (dtype, backend) it cannot execute
        self.processors = list(processors) if processors is not None else None

    # -- creation -----------------------------------------------------------
    def random_solution(self) -> Solution:
        r = self.rng
        partition = [
            [1 if r.random() < self.cut_prob else 0 for _ in range(g.num_edges)]
            for g in self.graphs
        ]
        mapping = [
            [r.randrange(self.num_processors) for _ in range(g.num_layers)]
            for g in self.graphs
        ]
        priority = list(range(len(self.graphs)))
        r.shuffle(priority)
        dtype = [r.randrange(self.num_dtypes) for _ in self.graphs]
        backend = [r.randrange(self.num_backends) for _ in self.graphs]
        return Solution(partition, mapping, priority, dtype, backend)

    def seeded_solution(self, processor: int, cuts: bool = False) -> Solution:
        """A heuristic seed: everything on ``processor``, no (or random) cuts.

        The (dtype, backend) genes default to (0, 0) = (fp32, default); when
        the factory knows its processors and the pinned one cannot execute
        that configuration (e.g. an fp16/int8-only NPU), the seed instead
        carries the pinned processor's fastest *supported* configuration —
        otherwise the "everything on P" seed simulates under the capability
        fallback penalty and is useless as GA seeding material.
        """
        r = self.rng
        partition = [
            [1 if (cuts and r.random() < self.cut_prob) else 0 for _ in range(g.num_edges)]
            for g in self.graphs
        ]
        mapping = [[processor] * g.num_layers for g in self.graphs]
        priority = list(range(len(self.graphs)))
        di, bi = self._seed_config(processor)
        return Solution(partition, mapping, priority,
                        [di] * len(self.graphs), [bi] * len(self.graphs))

    def _seed_config(self, processor: int) -> Tuple[int, int]:
        """(dtype, backend) gene pair for a seed pinned to ``processor``:
        (0, 0) when supported (or capabilities unknown), else the supported
        pair with the highest throughput. Deterministic — no RNG draw, so
        adding capability knowledge never perturbs the seed RNG stream."""
        if self.processors is None:
            return (0, 0)
        proc = next((p for p in self.processors if p.pid == processor), None)
        if proc is None or proc.thr(DTYPES[0], BACKENDS[0]) is not None:
            return (0, 0)
        best: Optional[Tuple[float, int, int]] = None
        for di in range(min(self.num_dtypes, len(DTYPES))):
            for bi in range(min(self.num_backends, len(BACKENDS))):
                t = proc.thr(DTYPES[di], BACKENDS[bi])
                if t is not None and (best is None or t > best[0]):
                    best = (t, di, bi)
        return (best[1], best[2]) if best is not None else (0, 0)

    # -- crossover ------------------------------------------------------------
    def crossover(self, a: Solution, b: Solution) -> Tuple[Solution, Solution]:
        """One-point crossover on partition+mapping, UPMX on priority (§4.3)."""
        r = self.rng
        c1, c2 = a.copy(), b.copy()
        c1.fitness = c2.fitness = None
        for net in range(len(self.graphs)):
            if len(c1.partition[net]) > 1:
                pt = r.randrange(1, len(c1.partition[net]))
                c1.partition[net][pt:], c2.partition[net][pt:] = (
                    c2.partition[net][pt:],
                    c1.partition[net][pt:],
                )
            if len(c1.mapping[net]) > 1:
                pt = r.randrange(1, len(c1.mapping[net]))
                c1.mapping[net][pt:], c2.mapping[net][pt:] = (
                    c2.mapping[net][pt:],
                    c1.mapping[net][pt:],
                )
        c1.priority, c2.priority = upmx(c1.priority, c2.priority, r)
        # uniform swap for config genes
        for net in range(len(self.graphs)):
            if r.random() < 0.5:
                c1.dtype[net], c2.dtype[net] = c2.dtype[net], c1.dtype[net]
            if r.random() < 0.5:
                c1.backend[net], c2.backend[net] = c2.backend[net], c1.backend[net]
        return c1, c2

    # -- mutation -------------------------------------------------------------
    def mutate(
        self,
        sol: Solution,
        p_bit: float = 0.03,
        p_map: float = 0.05,
        p_prio: float = 0.2,
        p_cfg: float = 0.1,
    ) -> Solution:
        r = self.rng
        m = sol.copy()
        m.fitness = None
        for net in range(len(self.graphs)):
            for i in range(len(m.partition[net])):
                if r.random() < p_bit:
                    m.partition[net][i] ^= 1
            for i in range(len(m.mapping[net])):
                if r.random() < p_map:
                    m.mapping[net][i] = r.randrange(self.num_processors)
            if r.random() < p_cfg:
                m.dtype[net] = r.randrange(self.num_dtypes)
            if r.random() < p_cfg:
                m.backend[net] = r.randrange(self.num_backends)
        if len(m.priority) > 1 and r.random() < p_prio:
            i, j = r.sample(range(len(m.priority)), 2)
            m.priority[i], m.priority[j] = m.priority[j], m.priority[i]
        return m


def upmx(p1: List[int], p2: List[int], rng: random.Random, indpb: float = 0.5
         ) -> Tuple[List[int], List[int]]:
    """Uniform Partially-Matched Crossover for permutations (Cicirello 2000).

    For each position, with probability ``indpb`` swap the genes and repair
    both permutations via the PMX mapping so they stay valid permutations.
    """
    c1, c2 = list(p1), list(p2)
    n = len(c1)
    pos1 = {v: i for i, v in enumerate(c1)}
    pos2 = {v: i for i, v in enumerate(c2)}
    for i in range(n):
        if rng.random() < indpb:
            v1, v2 = c1[i], c2[i]
            # swap v1 and v2 inside each child
            c1[i], c1[pos1[v2]] = v2, v1
            c2[i], c2[pos2[v1]] = v1, v2
            pos1[v1], pos1[v2] = pos1[v2], pos1[v1]
            pos2[v1], pos2[v2] = pos2[v2], pos2[v1]
    return c1, c2
