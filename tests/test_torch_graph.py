"""The port's graph IR (``repro_torch.core.graph``): partitioning,
convexity, Merkle hashing and edge validation, the cases of
``tests/test_graph.py`` on the port, each also held to ``repro.core`` on
the same graph: the same subgraphs and the same Merkle hashes."""
import pytest
from _hypothesis_compat import given, settings, st

import repro.core as ref
from repro_torch.core import Edge, Layer, ModelGraph, branching_graph, chain_graph


def same_as_reference(g, bits):
    """The port's partition of ``g`` equals the reference's of the same graph."""
    rg = ref.ModelGraph(g.name, [ref.Layer(**vars(layer)) for layer in g.layers],
                        [ref.Edge(**vars(e)) for e in g.edges])
    got, want = g.partition(bits), rg.partition(bits)
    assert [(s.sg_index, s.layer_ids) for s in got] == [(s.sg_index, s.layer_ids) for s in want]
    assert [s.merkle_hash() for s in got] == [s.merkle_hash() for s in want]
    return got


def make_chain(n=6):
    return chain_graph("c", [("conv", 1e6, 100, 1000)] * n)


def test_torch_chain_no_cuts_single_subgraph():
    g = make_chain(5)
    sgs = same_as_reference(g, [0] * g.num_edges)
    assert len(sgs) == 1
    assert sgs[0].layer_ids == tuple(range(5))


def test_torch_chain_all_cuts():
    g = make_chain(4)
    sgs = same_as_reference(g, [1] * g.num_edges)
    assert len(sgs) == 4
    assert [s.layer_ids for s in sgs] == [(0,), (1,), (2,), (3,)]


def test_torch_partition_matches_paper_fig7():
    # Fig 7: 5-layer chain, edges [2],[3] cut -> {0,1,2} and {3,4}
    g = make_chain(5)
    bits = [0, 0, 1, 0]
    # edge index 2 connects layers 2-3 -> cut after layer 2
    sgs = same_as_reference(g, bits)
    assert [s.layer_ids for s in sgs] == [(0, 1, 2), (3, 4)]


def test_torch_cut_inside_connected_component_is_ignored():
    # diamond: 0 -> 1 -> 3, 0 -> 2 -> 3; cutting only edge 0->1 leaves 1
    # connected through 1->3, so the cut is ineffective: one subgraph.
    g = branching_graph(
        "d", [("conv", 1e6, 0, 10)] * 4, [(0, 1), (0, 2), (1, 3), (2, 3)]
    )
    sgs = same_as_reference(g, [1, 0, 0, 0])
    assert len(sgs) == 1


def test_torch_branching_convexity():
    # cut edges 0->1 and 1->3: naive components are {0,2,3} and {1}, but 1
    # depends on 0 and feeds 3 -> {0,2,3} is non-convex (subgraph-level
    # cycle) and must split so the quotient graph stays a DAG.
    g = branching_graph(
        "d", [("conv", 1e6, 0, 10)] * 4, [(0, 1), (0, 2), (1, 3), (2, 3)]
    )
    sgs = same_as_reference(g, [1, 0, 1, 0])
    comp = {lid: s.sg_index for s in sgs for lid in s.layer_ids}
    # layer 3 cannot be compiled with 0 while 1 is external in between
    assert comp[3] != comp[0]
    # quotient order respects dependencies
    for e in g.edges:
        assert comp[e.src] <= comp[e.dst]


def test_torch_merkle_stable_and_config_sensitive():
    g = make_chain(5)
    sgs = same_as_reference(g, [0, 1, 0, 0])
    h1 = sgs[0].merkle_hash()
    h2 = g.partition([0, 1, 0, 0])[0].merkle_hash()
    assert h1 == h2
    assert sgs[0].merkle_hash(extra=(1, "fp16")) != h1
    assert sgs[0].merkle_hash() != sgs[1].merkle_hash()


def test_torch_merkle_same_structure_same_hash():
    # identical subgraph content in different graphs -> same hash (DB reuse)
    g1 = make_chain(6)
    g2 = chain_graph("other", [("conv", 1e6, 100, 1000)] * 6)
    h1 = g1.partition([1, 0, 0, 0, 0])[1].merkle_hash()
    h2 = g2.partition([1, 0, 0, 0, 0])[1].merkle_hash()
    assert h1 == h2


def test_torch_edge_validation():
    layers = [Layer(0, "a", "conv"), Layer(1, "b", "conv")]
    with pytest.raises(ValueError):
        ModelGraph("bad", layers, [Edge(0, 1, 0, 10)])  # backward edge


@st.composite
def random_dag(draw):
    n = draw(st.integers(3, 14))
    layers = [Layer(i, f"l{i}", "conv", macs=1e6, out_bytes=100) for i in range(n)]
    edges = []
    k = 0
    for i in range(n - 1):  # chain backbone keeps it connected
        edges.append(Edge(k, i, i + 1, 100))
        k += 1
    extra = draw(st.lists(
        st.tuples(st.integers(0, n - 2), st.integers(1, n - 1)), max_size=6))
    for s, d in extra:
        if s < d and (s, d) not in [(e.src, e.dst) for e in edges]:
            edges.append(Edge(k, s, d, 100))
            k += 1
    return ModelGraph("r", layers, edges)


@settings(max_examples=60, deadline=None)
@given(random_dag(), st.data())
def test_torch_partition_properties(g, data):
    bits = data.draw(st.lists(st.integers(0, 1), min_size=g.num_edges,
                              max_size=g.num_edges))
    sgs = same_as_reference(g, bits)
    # 1. exact cover of layers
    covered = sorted(lid for s in sgs for lid in s.layer_ids)
    assert covered == list(range(g.num_layers))
    # 2. quotient graph is a DAG with topological order = sg_index order
    comp = {lid: s.sg_index for s in sgs for lid in s.layer_ids}
    for e in g.edges:
        assert comp[e.src] <= comp[e.dst]
    # 3. MAC conservation
    assert abs(sum(s.macs for s in sgs) - g.total_macs) < 1e-3
