"""The port's copies of the scheduling core and the zoo against the JAX package.

The copies (graph, processors, chromosome, memlayout, arrivals, profiles,
the profiler's analytic backends, the simulator's record types) must give
the same values, and the same Merkle and profile keys, since the two
packages share ProfileDB keys. The port's executable zoo models, with the
reference's weights carried by ``zoo_weights_from_jax``, must compute the
reference's function: fp32 at rtol 1e-5 / atol 1e-6, the bf16 dtypes at
rtol / atol 2e-2, both on outputs divided by the reference's max |output|
(activations shrink ~4× a layer, so raw values would pass any atol).
"""
import dataclasses
import json
import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.memlayout as r_memlayout
import repro.zoo as rz
import repro_torch.core as tc
import repro_torch.core.memlayout as t_memlayout
import repro_torch.zoo as tz
from repro_torch.models import zoo_weights_from_jax


def _graph_rows(g):
    return ([(layer.index, layer.name, layer.op_type, layer.macs, layer.param_bytes,
              layer.out_bytes, layer.attrs) for layer in g.layers],
            [(e.index, e.src, e.dst, e.bytes_) for e in g.edges])


def _test_runtime_solutions(pkg):
    """The Solutions of ``tests/test_runtime.py`` over ``pkg``'s graphs:
    the split face_det + selfie_seg one, and random ones over its small nets."""
    zoo_graphs = [pkg.zoo.make_cost_graph("face_det"), pkg.zoo.make_cost_graph("selfie_seg")]
    g0, g1 = zoo_graphs
    part0 = [0] * g0.num_edges
    part0[g0.num_layers - 2] = 1
    cases = [(zoo_graphs, pkg.core.Solution(
        partition=[part0, [0] * g1.num_edges],
        mapping=[[2] * (g0.num_layers - 1) + [1], [0] * g1.num_layers],
        priority=[0, 1], dtype=[0, 0], backend=[0, 0]))]
    nets = [
        pkg.core.chain_graph("vx", [("conv", 4e6, 1000, 4000)] * 5),
        pkg.core.branching_graph("vy", [("conv", 2e6, 800, 2000)] * 4,
                                 [(0, 1), (0, 2), (1, 3), (2, 3)]),
    ]
    for seed in (3, 5, 7, 11, 13):
        factory = pkg.core.SolutionFactory(nets, num_processors=3, rng=random.Random(seed))
        cases.append((nets, factory.random_solution()))
    return cases


class _Pkg:
    def __init__(self, core, zoo):
        self.core, self.zoo = core, zoo


REF, PORT = _Pkg(rc, rz), _Pkg(tc, tz)


@pytest.mark.parametrize("name", rz.MODEL_NAMES)
def test_cost_graphs_match(name):
    gr, gt = rz.make_cost_graph(name), tz.make_cost_graph(name)
    assert _graph_rows(gt) == _graph_rows(gr)
    assert gt.partition([0] * gt.num_edges)[0].merkle_hash() == \
        gr.partition([0] * gr.num_edges)[0].merkle_hash()


def test_profile_keys_match_on_test_runtime_solutions():
    for (nets_r, sol_r), (nets_t, sol_t) in zip(_test_runtime_solutions(REF),
                                                _test_runtime_solutions(PORT)):
        assert sol_t.key() == sol_r.key()
        placed_r, placed_t = rc.decode_solution(sol_r, nets_r), tc.decode_solution(sol_t, nets_t)
        for pl_r, pl_t in zip(placed_r, placed_t):
            assert [(p.subgraph.layer_ids, p.processor, p.dtype, p.backend, p.priority,
                     p.subgraph.merkle_hash(), p.profile_key()) for p in pl_t] == \
                [(p.subgraph.layer_ids, p.processor, p.dtype, p.backend, p.priority,
                  p.subgraph.merkle_hash(), p.profile_key()) for p in pl_r]


def test_solution_factory_streams_match():
    graphs_r = list(rz.all_cost_graphs().values())[:4]
    graphs_t = list(tz.all_cost_graphs().values())[:4]
    fr = rc.SolutionFactory(graphs_r, 3, rng=random.Random(21), processors=rc.mobile_processors())
    ft = tc.SolutionFactory(graphs_t, 3, rng=random.Random(21), processors=tc.mobile_processors())
    for _ in range(5):
        a_r, b_r = fr.random_solution(), fr.seeded_solution(2, cuts=True)
        a_t, b_t = ft.random_solution(), ft.seeded_solution(2, cuts=True)
        assert (a_t.key(), b_t.key()) == (a_r.key(), b_r.key())
        assert [c.key() for c in ft.crossover(a_t, b_t)] == \
            [c.key() for c in fr.crossover(a_r, b_r)]
        assert ft.mutate(a_t).key() == fr.mutate(a_r).key()
    assert tc.upmx([0, 1, 2, 3], [3, 2, 1, 0], random.Random(4)) == \
        rc.upmx([0, 1, 2, 3], [3, 2, 1, 0], random.Random(4))
    assert (tc.DTYPES, tc.BACKENDS) == (rc.DTYPES, rc.BACKENDS)


def test_processors_and_record_types_match():
    assert [dataclasses.astuple(p) for p in tc.mobile_processors()] == \
        [dataclasses.astuple(p) for p in rc.mobile_processors()]
    noise_r, noise_t = rc.NoiseModel(seed=3), tc.NoiseModel(seed=3)
    assert dataclasses.astuple(noise_t) == dataclasses.astuple(noise_r)
    assert [noise_t.sigma(k) for k in ("cpu", "gpu", "npu", "x")] == \
        [noise_r.sigma(k) for k in ("cpu", "gpu", "npu", "x")]
    assert [f.name for f in dataclasses.fields(tc.TaskRecord)] == \
        [f.name for f in dataclasses.fields(rc.TaskRecord)]
    assert t_memlayout.CHUNK == r_memlayout.CHUNK
    for n in (0, 1, 2047, 2048, 2049, 10**7 + 3):
        assert t_memlayout.rounded_chunk_bytes(n) == r_memlayout.rounded_chunk_bytes(n)


ARRIVALS = [None, {"kind": "jittered", "jitter": 0.4, "seed": 2},
            {"kind": "jittered", "distribution": "lognormal", "sigma": 0.5, "seed": 5},
            {"kind": "poisson", "seed": 7},
            {"kind": "trace", "trace": [[0.0, 0.001, 0.0005], []]}]


@pytest.mark.parametrize("spec", ARRIVALS)
def test_draw_arrivals_tables_match(spec):
    sr = None if spec is None else rc.ArrivalSpec.from_json(spec)
    st = None if spec is None else tc.ArrivalSpec.from_json(spec)
    periods = [0.004, 0.0063]
    tab_r, tab_t = rc.draw_arrivals(sr, periods, 9), tc.draw_arrivals(st, periods, 9)
    assert tab_t == tab_r
    assert tc.arrival_horizon(tab_t, periods, 9) == rc.arrival_horizon(tab_r, periods, 9)
    if spec is not None:
        assert st.key() == sr.key() and st.to_json() == sr.to_json()


def test_profiles_and_analytic_backends_match(tmp_path):
    assert tz.MODEL_SPECS == rz.MODEL_SPECS and tz.TABLE4_RATIO == rz.TABLE4_RATIO
    assert tz.paper_profile_tables() == rz.paper_profile_tables()
    assert tz.best_processor_times_s() == rz.best_processor_times_s()
    procs_r, procs_t = rc.mobile_processors(), tc.mobile_processors()
    backends = [(rc.AnalyticMobileBackend(procs_r), tc.AnalyticMobileBackend(procs_t)),
                (rc.TableBackend(procs_r, rz.paper_profile_tables(),
                                 rc.AnalyticMobileBackend(procs_r)),
                 tc.TableBackend(procs_t, tz.paper_profile_tables(),
                                 tc.AnalyticMobileBackend(procs_t)))]
    # every subgraph of every single-cut split of two models, on each
    # processor, dtype and backend
    for name in ("yolov8n", "hand_det"):
        gr, gt = rz.make_cost_graph(name), tz.make_cost_graph(name)
        cut = [0] * gr.num_edges
        cut[gr.num_layers // 3] = 1
        for sg_r, sg_t in zip(gr.partition(cut), gt.partition(cut)):
            assert tc.fragmentation_penalty(procs_t[2], sg_t) == \
                rc.fragmentation_penalty(procs_r[2], sg_r)
            for pid in range(3):
                for dt in rc.DTYPES:
                    for be in rc.BACKENDS:
                        pr = rc.PlacedSubgraph(sg_r, 0, pid, dt, be, 0)
                        pt = tc.PlacedSubgraph(sg_t, 0, pid, dt, be, 0)
                        for br, bt in backends:
                            assert bt.measure(pt) == br.measure(pr)
    # the port's ProfileDB reads what the reference's wrote, under the same keys
    p_r = rc.whole_model_placement(rz.make_cost_graph("yolov8n"), 0, 2, 1, 0)
    sg_t = tz.make_cost_graph("yolov8n").partition([0] * p_r.subgraph.graph.num_edges)[0]
    p_t = tc.PlacedSubgraph(sg_t, 0, 2, "fp16", "default", 0)
    path = str(tmp_path / "db.json")
    db_r = rc.ProfileDB(path)
    t = rc.Profiler(backends[1][0], db_r).subgraph_time(p_r)
    db_r.save()
    db_t = tc.ProfileDB(path)
    assert tc.Profiler(backends[1][1], db_t).subgraph_time(p_t) == t
    assert db_t.hits == 1 and db_t.misses == 0
    assert json.load(open(path)) == {p_t.profile_key(): t}


# -- executable zoo models ------------------------------------------------------

@pytest.fixture(scope="module")
def zoos():
    names = ["face_det", "hand_det", "yolov8n"]
    ref = rz.executable_zoo(names=names, channels=4, spatial=8)
    port = {n: tz.ExecutableMobileModel(n, channels=4, spatial=8,
                                        weights=zoo_weights_from_jax(ref[n]), device="cpu")
            for n in names}
    return ref, port


def _subgraphs(g):
    """The whole model, every piece of a 3-way split, a lone merge layer."""
    n = g.num_layers
    merges = [layer.index for layer in g.layers if layer.op_type == "add_merge"]
    return [tuple(range(n)), tuple(range(0, n // 3)), tuple(range(n // 3, 2 * n // 3)),
            tuple(range(2 * n // 3, n)), (merges[0],)]


def _tol(dtype):
    return dict(rtol=1e-5, atol=1e-6) if dtype == "fp32" else dict(rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", ["face_det", "hand_det", "yolov8n"])
@pytest.mark.parametrize("dtype", ["fp32", "fp16", "int8"])
def test_executable_model_matches_reference(zoos, name, dtype):
    ref, port = zoos
    rng = np.random.default_rng(0)
    for ids in _subgraphs(ref[name].graph):
        fn_r, ex_r = ref[name].build_subgraph_fn(ids, dtype)
        fn_t, ex_t = port[name].build_subgraph_fn(ids, dtype)
        assert len(ex_t) == len(ex_r)
        assert [tuple(a.shape) for a in ex_t] == [tuple(a.shape) for a in ex_r]
        assert all(a.dtype == tz.COMPUTE_DTYPES[dtype] for a in ex_t)
        np.testing.assert_array_equal(ex_t[0].float().numpy(), np.asarray(ex_r[0], np.float32))
        inputs = [rng.standard_normal(ex_t[0].shape).astype(np.float32) for _ in ex_t]
        xt = [torch.from_numpy(a).to(tz.COMPUTE_DTYPES[dtype]) for a in inputs]
        xr = [jnp.asarray(t.float().numpy().astype(
            np.float32 if dtype == "fp32" else ml_dtypes.bfloat16)) for t in xt]
        out_t, out_r = fn_t(*xt), fn_r(*xr)
        outs_t = out_t if isinstance(out_t, tuple) else (out_t,)
        outs_r = out_r if isinstance(out_r, tuple) else (out_r,)
        assert len(outs_t) == len(outs_r)
        for a, b in zip(outs_t, outs_r):
            b = np.asarray(b, np.float32)
            m = float(np.abs(b).max())
            assert m > 0 and a.dtype == tz.COMPUTE_DTYPES[dtype] and a.is_contiguous()
            np.testing.assert_allclose(a.float().numpy() / m, b / m, **_tol(dtype))


def test_build_subgraph_fn_is_cached(zoos):
    _, port = zoos
    m = port["face_det"]
    first = m.build_subgraph_fn([2, 0, 1], "fp16")
    assert m.build_subgraph_fn((0, 1, 2), "fp16") is first
    assert m.build_subgraph_fn((0, 1, 2), "fp32") is not first


def test_default_weights_come_from_the_seed():
    a = tz.ExecutableMobileModel("face_det", channels=4, spatial=8, seed=5, device="cpu")
    b = tz.ExecutableMobileModel("face_det", channels=4, spatial=8, seed=5, device="cpu")
    c = tz.ExecutableMobileModel("face_det", channels=4, spatial=8, seed=6, device="cpu")
    ids = tuple(range(a.graph.num_layers))
    outs = [m.build_subgraph_fn(ids, "fp32") for m in (a, b, c)]
    ya, yb, yc = (fn(*ex) for fn, ex in outs)
    assert torch.equal(ya, yb) and not torch.equal(ya, yc)


def test_model_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tz.ExecutableMobileModel("face_det", channels=4, spatial=8)


def test_torch_exec_backend_device_in_the_loop():
    """Literal device-in-the-loop: really runs the subgraph (here the CPU)."""
    zoo = tz.executable_zoo(names=["face_det"], channels=4, spatial=8, device="cpu")
    backend = tc.TorchExecBackend(zoo, repeats=2, speed_scale={0: 2.0})
    g = zoo["face_det"].graph
    sg = g.partition([0] * g.num_edges)[0]
    t = backend.measure(tc.PlacedSubgraph(sg, 0, 1, "fp32", "default", 0))
    assert 0 < t < 5.0
    assert backend.measure(tc.PlacedSubgraph(sg, 0, 0, "fp32", "default", 0)) > 0
