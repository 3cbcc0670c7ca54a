"""Layer-DAG intermediate representation for schedulable networks
(copy of ``repro.core.graph``; the Merkle hashes are the same strings).

A :class:`ModelGraph` is the unit Puzzle schedules: a DAG of :class:`Layer`
nodes connected by :class:`Edge`\\ s carrying tensors of known byte size.
The partition chromosome cuts edges; connected components of the remaining
graph become :class:`Subgraph`\\ s — the unit of compilation, profiling and
execution (paper §4, Fig. 7).

Subgraphs are content-addressed with a Merkle-tree hash (paper §4.3) so the
device-in-the-loop profiler can cache measurements across GA generations.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class Layer:
    """One schedulable operator/layer.

    ``macs`` / ``param_bytes`` / ``out_bytes`` drive the analytic cost
    backends; ``op_type`` + ``attrs`` drive Merkle hashing and (for the
    executable zoo models) the actual computation.
    """

    index: int
    name: str
    op_type: str
    macs: float = 0.0              # multiply-accumulates of this layer
    param_bytes: int = 0           # weight footprint
    out_bytes: int = 0             # activation output size (comm cost on a cut)
    attrs: Tuple[Tuple[str, Any], ...] = ()

    def attr(self, key: str, default: Any = None) -> Any:
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    def leaf_hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(self.op_type.encode())
        h.update(str(sorted(self.attrs)).encode())
        h.update(str(int(self.macs)).encode())
        h.update(str(self.out_bytes).encode())
        return h.digest()


@dataclass(frozen=True)
class Edge:
    """Directed dependency ``src -> dst`` carrying ``bytes_`` of activation."""

    index: int
    src: int
    dst: int
    bytes_: int


class ModelGraph:
    """A DAG of layers; the schedulable representation of one network."""

    def __init__(self, name: str, layers: Sequence[Layer], edges: Sequence[Edge]):
        self.name = name
        self.layers: List[Layer] = list(layers)
        self.edges: List[Edge] = list(edges)
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if layer.index != i:
                raise ValueError(
                    f"layer {layer.name} has index {layer.index}, expected {i}")
        for e in self.edges:
            if not (0 <= e.src < n and 0 <= e.dst < n):
                raise ValueError(f"edge {e} out of range")
            if e.src >= e.dst:
                raise ValueError(f"edge {e} must go forward in topological index order")
        self.out_edges: Dict[int, List[Edge]] = {i: [] for i in range(n)}
        self.in_edges: Dict[int, List[Edge]] = {i: [] for i in range(n)}
        for e in self.edges:
            self.out_edges[e.src].append(e)
            self.in_edges[e.dst].append(e)
        self._partition_cache: Dict[Tuple[int, ...], List["Subgraph"]] = {}

    # -- basic properties ---------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    @property
    def total_macs(self) -> float:
        return sum(layer.macs for layer in self.layers)

    @property
    def total_param_bytes(self) -> int:
        return sum(layer.param_bytes for layer in self.layers)

    def sources(self) -> List[int]:
        return [i for i in range(self.num_layers) if not self.in_edges[i]]

    def sinks(self) -> List[int]:
        return [i for i in range(self.num_layers) if not self.out_edges[i]]

    def validate_acyclic(self) -> bool:
        # Edges are constrained src < dst at construction => acyclic by design.
        return True

    # -- partitioning ---------------------------------------------------------
    def partition(self, cut_bits: Sequence[int]) -> List["Subgraph"]:
        """Split into subgraphs given a binary cut vector over edges.

        ``cut_bits[e] == 1`` means edge ``e`` is cut (paper Fig. 7a). The
        connected components of the *undirected* un-cut graph become
        subgraphs. Components are then topologically ordered; a component
        whose internal layers straddle a dependency through another component
        is split further so every subgraph is convex (no dependency cycle
        between subgraphs) — this mirrors compilable subgraphs in Puzzle.
        """
        if len(cut_bits) != self.num_edges:
            raise ValueError(
                f"cut vector has {len(cut_bits)} bits, graph has {self.num_edges} edges"
            )
        cache_key = tuple(cut_bits)
        cached = self._partition_cache.get(cache_key)
        if cached is not None:
            return cached
        n = self.num_layers
        parent = list(range(n))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a: int, b: int) -> None:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

        for e in self.edges:
            if not cut_bits[e.index]:
                union(e.src, e.dst)

        comp_of = [find(i) for i in range(n)]
        # Enforce convexity: iterate until no subgraph-level cycle remains.
        # A cycle appears when a cut path leaves a component and re-enters it.
        comp_of = self._make_convex(comp_of)

        groups: Dict[int, List[int]] = {}
        for i, c in enumerate(comp_of):
            groups.setdefault(c, []).append(i)
        # Topological order of subgraphs == order of min layer index (valid
        # since edges only go forward).
        ordered = sorted(groups.values(), key=min)
        result = [Subgraph(self, tuple(g), sg_index=k) for k, g in enumerate(ordered)]
        if len(self._partition_cache) < 4096:
            self._partition_cache[cache_key] = result
        return result

    def _make_convex(self, comp_of: List[int]) -> List[int]:
        """Split components until the subgraph quotient graph is acyclic.

        Uses the forward-index property: within a component, if a layer ``v``
        has a predecessor path exiting and re-entering the component, detach
        ``v`` and its component-successors into a fresh component.
        """
        n = self.num_layers
        changed = True
        next_comp = max(comp_of, default=-1) + 1
        while changed:
            changed = False
            # longest path "external rank" per layer: number of component
            # switches along any path into the layer.
            rank = [0] * n
            for i in range(n):
                for e in self.in_edges[i]:
                    r = rank[e.src] + (1 if comp_of[e.src] != comp_of[e.dst] else 0)
                    if r > rank[i]:
                        rank[i] = r
            # If two layers in one component have different ranks, the lower
            # ones and higher ones cannot be compiled together (an external
            # dependency sits between them) -> split by rank.
            by_comp: Dict[int, Dict[int, List[int]]] = {}
            for i in range(n):
                by_comp.setdefault(comp_of[i], {}).setdefault(rank[i], []).append(i)
            for comp, by_rank in by_comp.items():
                if len(by_rank) > 1:
                    changed = True
                    for r, members in sorted(by_rank.items())[1:]:
                        for m in members:
                            comp_of[m] = next_comp
                        next_comp += 1
        return comp_of

    def __repr__(self) -> str:  # pragma: no cover
        return f"ModelGraph({self.name}, layers={self.num_layers}, edges={self.num_edges})"


@dataclass(frozen=True)
class Subgraph:
    """A convex set of layers compiled and executed as one unit."""

    graph: ModelGraph
    layer_ids: Tuple[int, ...]
    sg_index: int

    @property
    def name(self) -> str:
        return f"{self.graph.name}/sg{self.sg_index}"

    @property
    def macs(self) -> float:
        return sum(self.graph.layers[i].macs for i in self.layer_ids)

    @property
    def param_bytes(self) -> int:
        return sum(self.graph.layers[i].param_bytes for i in self.layer_ids)

    def internal_edges(self) -> List[Edge]:
        s = set(self.layer_ids)
        return [e for e in self.graph.edges if e.src in s and e.dst in s]

    def in_cut_edges(self) -> List[Edge]:
        s = set(self.layer_ids)
        return [e for e in self.graph.edges if e.dst in s and e.src not in s]

    def out_cut_edges(self) -> List[Edge]:
        s = set(self.layer_ids)
        return [e for e in self.graph.edges if e.src in s and e.dst not in s]

    def input_bytes(self) -> int:
        b = sum(e.bytes_ for e in self.in_cut_edges())
        if not b:  # source subgraph: model input size approximated by first layer
            first = self.graph.layers[min(self.layer_ids)]
            b = first.attr("input_bytes", first.out_bytes)
        return int(b)

    def output_bytes(self) -> int:
        b = sum(e.bytes_ for e in self.out_cut_edges())
        if not b:
            last = self.graph.layers[max(self.layer_ids)]
            b = last.out_bytes
        return int(b)

    def merkle_hash(self, extra: Tuple[Any, ...] = ()) -> str:
        """Merkle-tree content hash of this subgraph (paper §4.3).

        Leaves are per-layer hashes in topological order; internal edges are
        folded in pairwise, so equal subgraphs across candidates/generations
        hit the same profile-DB row. ``extra`` lets callers mix in the
        execution configuration (processor, dtype, backend).

        The root digest and per-``extra`` results are memoized on the
        *instance* (content-addressed, so always valid). The search fast
        path shares ``Subgraph`` objects across candidate solutions via its
        partition cache, so repeated profile-key computation becomes a dict
        hit there, while paths that re-decode per simulation (the reference
        oracle, mirroring the original implementation) keep paying full
        cost.
        """
        d = self.__dict__  # frozen dataclass: memoize without __setattr__
        memo = d.get("_merkle_memo")
        if memo is None:
            memo = d["_merkle_memo"] = {}
        else:
            hit = memo.get(extra)
            if hit is not None:
                return hit
        root = d.get("_merkle_root")
        if root is None:
            level = [self.graph.layers[i].leaf_hash() for i in sorted(self.layer_ids)]
            s = set(self.layer_ids)
            edge_sig = ",".join(
                f"{e.src}-{e.dst}" for e in self.graph.edges if e.src in s and e.dst in s
            )
            level.append(hashlib.sha256(edge_sig.encode()).digest())
            while len(level) > 1:
                nxt = []
                for i in range(0, len(level) - 1, 2):
                    nxt.append(hashlib.sha256(level[i] + level[i + 1]).digest())
                if len(level) % 2:
                    nxt.append(level[-1])
                level = nxt
            root = d["_merkle_root"] = level[0]
        if extra:
            out = hashlib.sha256(root + str(extra).encode()).digest().hex()
        else:
            out = root.hex()
        memo[extra] = out
        return out


def partition_quotient(
    graph: ModelGraph, subgraphs: Sequence[Subgraph]
) -> Tuple[Dict[int, int], List[Tuple[int, int]], List[str]]:
    """Contract a partition of ``graph`` to its subgraph quotient graph.

    Returns ``(owner, edges, problems)``: ``owner`` maps each layer id to the
    position of the subgraph owning it in ``subgraphs``; ``edges`` are the
    deduplicated cross-subgraph dependencies ``(src_sg, dst_sg)``; and
    ``problems`` lists structural defects found while contracting — layers
    owned by no subgraph or by more than one, out-of-range layer ids, and
    graph edges dangling out of the owned set. ``partition`` never produces
    these, so a nonempty ``problems`` means the subgraph list was corrupted
    after decode; the static analyzer reports them as SL002.
    """
    owner: Dict[int, int] = {}
    problems: List[str] = []
    for pos, sg in enumerate(subgraphs):
        for lid in sg.layer_ids:
            if not 0 <= lid < graph.num_layers:
                problems.append(f"subgraph {pos} owns out-of-range layer {lid}")
                continue
            if lid in owner:
                problems.append(
                    f"layer {lid} owned by subgraphs {owner[lid]} and {pos}")
                continue
            owner[lid] = pos
    for lid in range(graph.num_layers):
        if lid not in owner:
            problems.append(f"layer {lid} of {graph.name} is owned by no subgraph")
    edges: List[Tuple[int, int]] = []
    seen = set()
    for e in graph.edges:
        su, sv = owner.get(e.src), owner.get(e.dst)
        if su is None or sv is None:
            problems.append(
                f"edge {e.src}->{e.dst} dangles outside the partition")
            continue
        if su != sv and (su, sv) not in seen:
            seen.add((su, sv))
            edges.append((su, sv))
    return owner, edges, problems


def quotient_is_acyclic(num_nodes: int, edges: Sequence[Tuple[int, int]]) -> bool:
    """Kahn's algorithm over a contracted subgraph quotient graph."""
    indeg = [0] * num_nodes
    succs: Dict[int, List[int]] = {}
    for u, v in edges:
        indeg[v] += 1
        succs.setdefault(u, []).append(v)
    ready = [i for i in range(num_nodes) if indeg[i] == 0]
    done = 0
    while ready:
        u = ready.pop()
        done += 1
        for v in succs.get(u, ()):
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    return done == num_nodes


def chain_graph(
    name: str,
    layer_specs: Sequence[Tuple[str, float, int, int]],
) -> ModelGraph:
    """Build a linear-chain graph from ``(op_type, macs, param_bytes, out_bytes)``."""
    layers = [
        Layer(index=i, name=f"{name}.{i}", op_type=op, macs=m, param_bytes=p, out_bytes=o)
        for i, (op, m, p, o) in enumerate(layer_specs)
    ]
    edges = [
        Edge(index=i, src=i, dst=i + 1, bytes_=layers[i].out_bytes)
        for i in range(len(layers) - 1)
    ]
    return ModelGraph(name, layers, edges)


def branching_graph(
    name: str,
    layer_specs: Sequence[Tuple[str, float, int, int]],
    edge_list: Sequence[Tuple[int, int]],
) -> ModelGraph:
    """Build an arbitrary DAG; edge bytes default to the source layer output."""
    layers = [
        Layer(index=i, name=f"{name}.{i}", op_type=op, macs=m, param_bytes=p, out_bytes=o)
        for i, (op, m, p, o) in enumerate(layer_specs)
    ]
    edges = [
        Edge(index=k, src=s, dst=d, bytes_=layers[s].out_bytes)
        for k, (s, d) in enumerate(edge_list)
    ]
    return ModelGraph(name, layers, edges)
