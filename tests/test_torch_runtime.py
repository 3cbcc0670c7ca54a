"""The port's PuzzleRuntime on the CPU, against the JAX package's.

The reference's real-execution tests (``tests/test_runtime.py``, lifecycle,
engines, memory optimizations) run here against the port on
``device="cpu"``, some as cases over the runtime's configuration. Then
parity checks: the same Solution through both runtimes gives the same
outputs, task records and measured-cost keys; the same acquire/release
sequence the same pool statistics; the opt-in int8 staging path the JAX
int8 kernel's round trip at the staged inputs. Tolerances: fp32 rtol 1e-5 /
atol 1e-6, bf16 rtol / atol 2e-2, on outputs divided by the reference's
max |output|.
"""
import gc
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.runtime as rr
import repro.zoo as rz
import repro_torch.core as tc
import repro_torch.kernels.ops as ops
import repro_torch.runtime as tr
import repro_torch.zoo as tz
from repro.kernels import dequantize_int8, quantize_int8
from repro_torch.models import zoo_weights_from_jax
from repro_torch.runtime.engine import Engine, _no_collection

NAMES = ["face_det", "selfie_seg", "yolov8n"]


@pytest.fixture(scope="module")
def ref_zoo():
    return rz.executable_zoo(names=NAMES, channels=4, spatial=8)


@pytest.fixture(scope="module")
def zoo(ref_zoo):
    return {n: tz.ExecutableMobileModel(n, channels=4, spatial=8,
                                        weights=zoo_weights_from_jax(ref_zoo[n]), device="cpu")
            for n in NAMES}


def _runtime(graphs, sol, zoo, config=None):
    return tr.PuzzleRuntime(graphs, sol, tc.mobile_processors(), zoo, config, device="cpu")


def _solution(pkg, graphs, split_first=True, dtype=(0, 0), backend=(0, 0)):
    g0, g1 = graphs
    part0 = [0] * g0.num_edges
    if split_first:
        # cut the last chain edge: the final layers form a second subgraph
        part0[g0.num_layers - 2] = 1
    return pkg.Solution(
        partition=[part0, [0] * g1.num_edges],
        mapping=[[2] * (g0.num_layers - 1) + [1], [0] * g1.num_layers],
        priority=[0, 1], dtype=list(dtype), backend=list(backend),
    )


def _halves(pkg, g, dtype=2, backend=0):
    """``g`` cut after layer num_layers // 2 (skip edges too), halves on NPU → GPU."""
    h = g.num_layers // 2
    return pkg.Solution(partition=[[1 if e.src <= h < e.dst else 0 for e in g.edges]],
                        mapping=[[2] * (h + 1) + [1] * (g.num_layers - h - 1)],
                        priority=[0], dtype=[dtype], backend=[backend])


def _graphs(zoo, names=("face_det", "selfie_seg")):
    return [zoo[n].graph for n in names]


CONFIGS = {
    "reference": tr.RuntimeConfig(),
    "no_pool_no_shared": tr.RuntimeConfig(tensor_pool=False, shared_buffer=False),
    "int8_staging": tr.RuntimeConfig(int8_staging=True),
}


# -- lifecycle: close(), thread leaks, abandoned requests --------------------

@pytest.mark.parametrize("config", list(CONFIGS))
def test_close_joins_all_worker_threads(zoo, config):
    graphs = _graphs(zoo)
    rt = _runtime(graphs, _solution(tc, graphs, dtype=(2, 0)), zoo, CONFIGS[config])
    threads = [t for w in rt.workers.values()
               for t in (w._quant_thread, w._exec_thread)]
    assert all(t.is_alive() for t in threads)
    rt.infer_sync([0, 1])
    rt.close()
    assert all(not t.is_alive() for t in threads)
    assert not any(w.threads_alive() for w in rt.workers.values())
    rt.close()  # idempotent


def test_close_mid_request_fails_pending_futures(zoo):
    """Abandoning a runtime mid-request must not leak threads or hang."""
    graphs = _graphs(zoo)
    rt = _runtime(graphs, _solution(tc, graphs), zoo)
    states = [rt.infer([0, 1]) for _ in range(8)]
    rt.close()  # queues may still hold tasks: the stop sentinel outranks them
    assert not any(w.threads_alive() for w in rt.workers.values())
    for st in states:
        # either completed before the stop sentinel won the queue race,
        # or failed with the close error — never left hanging
        assert st.future.done()
    with pytest.raises(RuntimeError):
        rt.infer([0, 1])


def test_context_manager_closes(zoo):
    graphs = _graphs(zoo)
    with _runtime(graphs, _solution(tc, graphs), zoo) as rt:
        st = rt.infer_sync([0, 1])
        assert st.makespan is not None
    assert not any(w.threads_alive() for w in rt.workers.values())


def test_worker_stop_with_queued_tasks_regression(zoo):
    """stop() with a non-empty priority queue must not leak both threads."""
    g = zoo["face_det"].graph
    sol = tc.Solution(partition=[[0] * g.num_edges], mapping=[[0] * g.num_layers],
                      priority=[0], dtype=[0], backend=[0])
    rt = _runtime([g], sol, zoo)
    w = rt.workers[0]
    # pile tasks into the queue faster than they can drain, then stop
    for _ in range(32):
        rt.infer([0])
    rt.close()
    assert not w.threads_alive()


def test_no_leaked_threads_across_many_runtimes(zoo):
    graphs = _graphs(zoo)
    base = threading.active_count()
    for _ in range(3):
        with _runtime(graphs, _solution(tc, graphs), zoo) as rt:
            rt.infer_sync([0, 1])
    assert threading.active_count() <= base


def test_capture_guard_pauses_collection_and_restores_it():
    for was in (True, False):
        (gc.enable if was else gc.disable)()
        try:
            with _no_collection():
                assert not gc.isenabled()
            assert gc.isenabled() == was
            with pytest.raises(RuntimeError), _no_collection():
                raise RuntimeError
            assert gc.isenabled() == was
        finally:
            gc.enable()


# -- real execution: engines, memory optimizations ---------------------------

@pytest.mark.parametrize("config", list(CONFIGS))
def test_end_to_end_inference(zoo, config):
    graphs = _graphs(zoo)
    with _runtime(graphs, _solution(tc, graphs, dtype=(2, 1)), zoo, CONFIGS[config]) as rt:
        st = rt.infer_sync([0, 1])
        assert st.makespan is not None
        # face_det split into 2 subgraphs + selfie 1
        assert len(st.task_records) == 3
        assert all(bool(torch.isfinite(v.float()).all()) for v in st.outputs.values())


def test_cross_processor_dependency_order(zoo):
    """Subgraph 2 (GPU) must consume subgraph 1's (NPU) output."""
    g = zoo["face_det"].graph
    sol = tc.Solution(
        partition=[[1 if i == g.num_layers - 2 else 0 for i in range(g.num_edges)]],
        mapping=[[2] * (g.num_layers - 1) + [1]],
        priority=[0], dtype=[0], backend=[0],
    )
    with _runtime([g], sol, zoo) as rt:
        st = rt.infer_sync([0])
        recs = {r["sg"]: r for r in st.task_records}
        assert set(recs) == {0, 1}
        assert recs[1]["wait_s"] >= 0.0


def test_measured_costs_keyed_by_profile_key(zoo):
    """Real execution produces per-Merkle-key medians for the feedback loop."""
    graphs = _graphs(zoo)
    sol = _solution(tc, graphs)
    with _runtime(graphs, sol, zoo) as rt:
        for _ in range(3):
            rt.infer_sync([0, 1])
        costs = rt.measured_costs()
    placed = tc.decode_solution(sol, graphs)
    expected_keys = {p.profile_key() for plist in placed for p in plist}
    assert set(costs) == expected_keys
    assert all(t > 0 for t in costs.values())


def test_tensor_pool_reuse():
    pool = tr.TensorPool(enabled=True, device="cpu")
    a = pool.acquire((16, 16), torch.float32)
    pool.release(a)
    b = pool.acquire((8, 8), torch.float32)
    # different rounded size -> fresh alloc; same size -> reuse
    pool.release(b)
    c = pool.acquire((16, 16), torch.float32)
    assert pool.stats.reuses >= 1
    assert pool.stats.mallocs <= 2
    c[:] = 1.0  # usable memory
    assert c.shape == (16, 16) and c.dtype == torch.float32


def test_tensor_pool_disabled_always_allocates():
    pool = tr.TensorPool(enabled=False, device="cpu")
    a = pool.acquire((16,), torch.float32)
    pool.release(a)
    pool.acquire((16,), torch.float32)
    assert pool.stats.mallocs == 2
    assert pool.stats.reuses == 0


def test_shared_buffer_zero_copy():
    pool = tr.TensorPool(device="cpu")
    t_zero = tr.SharedBufferTransport(pool, zero_copy=True)
    t_copy = tr.SharedBufferTransport(pool, zero_copy=False)
    src = torch.ones((64,), dtype=torch.float32)
    out_zero = t_zero.transfer(src)
    assert out_zero is src
    out_copy = t_copy.transfer(src)
    assert out_copy is not src
    assert out_copy.untyped_storage().data_ptr() != src.untyped_storage().data_ptr()
    assert torch.equal(out_copy, src)
    assert t_copy.stats.staged_bytes == src.numel() * src.element_size()


def test_engines_agree(zoo):
    """All backends compute the same function (different kernel profiles)."""
    g = zoo["face_det"].graph
    placed = tc.PlacedSubgraph(g.partition([0] * g.num_edges)[0], 0, 0, "fp32", "default", 0)
    outs = {}
    for name in ("default", "xnnpack", "nnapi"):
        eng = tr.make_engine(name)
        key = eng.load(placed, zoo)
        outs[name] = eng.execute(key).numpy()
        assert key in eng.exec_times and len(eng.exec_times[key]) == 1
    np.testing.assert_allclose(outs["default"], outs["nnapi"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs["default"], outs["xnnpack"], rtol=1e-2, atol=1e-3)


def test_ablation_pool_reduces_mallocs(zoo):
    """Table 5 direction: tensor pool cuts allocation counts."""
    graphs = _graphs(zoo)
    sol = _solution(tc, graphs, dtype=(0, 1))
    counts = {}
    for pool_on in (False, True):
        with _runtime(graphs, sol, zoo,
                      tr.RuntimeConfig(tensor_pool=pool_on, shared_buffer=False)) as rt:
            for _ in range(6):
                rt.infer_sync([0, 1])
            counts[pool_on] = rt.stats()["pool"]["mallocs"]
    assert counts[True] <= counts[False]


# -- parity with the JAX package's runtime ------------------------------------

def _norm_close(a, b, dtype):
    b = np.asarray(b, np.float32)
    m = float(np.abs(b).max())
    assert m > 0
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "fp32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(a.float().numpy() / m, b / m, **tol)


@pytest.mark.parametrize("dtype,backend", [((0, 0), (0, 2)), ((1, 2), (2, 0)),
                                           ((2, 1), (0, 0))])
def test_same_solution_same_results(ref_zoo, zoo, dtype, backend):
    graphs_r, graphs_t = _graphs(ref_zoo), _graphs(zoo)
    sol_r = _solution(rc, graphs_r, dtype=dtype, backend=backend)
    sol_t = _solution(tc, graphs_t, dtype=dtype, backend=backend)
    with rr.PuzzleRuntime(graphs_r, sol_r, rc.mobile_processors(), ref_zoo) as rt_r:
        st_r = [rt_r.infer_sync([0, 1]) for _ in range(3)]
        costs_r = rt_r.measured_costs()
    with _runtime(graphs_t, sol_t, zoo) as rt_t:
        st_t = [rt_t.infer_sync([0, 1]) for _ in range(3)]
        costs_t = rt_t.measured_costs()
    assert set(costs_t) == set(costs_r)
    for a, b in zip(st_t, st_r):
        assert set(a.outputs) == set(b.outputs)
        assert sorted((r["net"], r["sg"]) for r in a.task_records) == \
            sorted((r["net"], r["sg"]) for r in b.task_records)
        for key in b.outputs:
            _norm_close(a.outputs[key], b.outputs[key], rc.DTYPES[dtype[key[0]]])


def test_pool_stats_match_reference():
    def run(pool, dtype, make):
        a = pool.acquire((16, 16), dtype)
        pool.release(a)
        b = pool.acquire((8, 8), dtype)
        c = pool.acquire((16, 16), dtype)
        pool.release(c)
        pool.release(c)                 # double release
        pool.release(make(64))          # foreign buffer
        d = pool.stage(make(256))
        pool.release(b)
        pool.release(d[3:])             # a view of a pooled buffer
        e = pool.acquire((1000,), dtype)
        f = pool.acquire((1000,), dtype)
        return pool.stats.__dict__, pool.bytes_in_use(), (e, f)

    for kw in (dict(enabled=True), dict(enabled=False), dict(enabled=True, capacity_bytes=8192)):
        stats_r = run(rr.TensorPool(**kw), np.float32,
                      lambda n: np.ones(n, np.float32))[:2]
        stats_t = run(tr.TensorPool(device="cpu", **kw), torch.float32,
                      lambda n: torch.ones(n))[:2]
        assert stats_t == stats_r
    # the capacity bound refuses what the reference refuses
    for pool, dtype in ((rr.TensorPool(capacity_bytes=4096), np.float32),
                        (tr.TensorPool(capacity_bytes=4096, device="cpu"), torch.float32)):
        held = pool.acquire((1024,), dtype)
        with pytest.raises(MemoryError):
            pool.acquire((1024,), dtype)
        assert pool.stats.oom_rejections == 1
        del held                        # a dropped view stops counting
        pool.acquire((1024,), dtype)


def test_int8_staging_equals_jax_k1_at_the_staged_inputs(zoo, monkeypatch):
    """yolov8n cut in two halves (int8): both boundary inputs of the second
    half are the JAX kernel's int8 round trip of the first half's output."""
    g = zoo["yolov8n"].graph
    seen = []
    execute = Engine.execute

    def recording(self, key, inputs=None):
        if inputs is not None:
            seen.append([t.clone() for t in inputs])
        return execute(self, key, inputs)
    monkeypatch.setattr(Engine, "execute", recording)
    with _runtime([g], _halves(tc, g), zoo, tr.RuntimeConfig(int8_staging=True)) as rt:
        st = rt.infer_sync([0])
        stats = rt.stats()
    assert len(seen) == 1 and len(seen[0]) == 2          # arity 2, replicated
    x = st.outputs[(0, 0)]
    assert x.dtype == torch.bfloat16 and x.shape == (1, 8, 8, 4)
    rows = x.reshape(8, 32).float().numpy()
    q, s = quantize_int8(jnp.asarray(rows.astype(ml_dtypes.bfloat16)), interpret=True)
    want = torch.tensor(np.asarray(dequantize_int8(q, s))).to(torch.bfloat16).reshape(x.shape)
    same_scale = torch.tensor(np.asarray(s)) == torch.from_numpy(
        np.maximum(np.abs(rows).max(axis=1), np.float32(1e-8)) / np.float32(127.0))
    for staged in seen[0]:
        assert staged.dtype == torch.bfloat16 and staged.shape == x.shape
        np.testing.assert_allclose(staged.float().numpy(), want.float().numpy(),
                                   rtol=2 ** -8, atol=0)
        assert torch.equal(staged.reshape(8, 32)[same_scale], want.reshape(8, 32)[same_scale])
    # both staged buffers came from the pool and went back to it
    assert stats["pool"]["frees"] == 2 and stats["pool"]["rejected_frees"] == 0
    assert stats["transport"]["zero_copies"] == 0


def test_int8_staging_is_one_quantizer_call_per_input(zoo, monkeypatch):
    """Each boundary input is staged by one ``quantize_rows`` call that
    writes the dequantized rows into the pooled buffer itself; no separate
    ``dequantize_rows`` pass remains."""
    g = zoo["yolov8n"].graph
    calls = []
    quantize = ops.quantize_rows

    def recording(x, out=None):
        calls.append((tuple(x.shape), None if out is None else out.dtype))
        return quantize(x, out=out)

    def refuse(*args, **kwargs):
        raise AssertionError("staging called dequantize_rows")
    monkeypatch.setattr(ops, "quantize_rows", recording)
    monkeypatch.setattr(ops, "dequantize_rows", refuse)
    with _runtime([g], _halves(tc, g), zoo, tr.RuntimeConfig(int8_staging=True)) as rt:
        st = rt.infer_sync([0])
    assert st.makespan is not None
    assert calls == [((8, 32), torch.bfloat16)] * 2


def test_int8_staging_off_keeps_the_reference_path(zoo, monkeypatch):
    g = zoo["yolov8n"].graph
    calls = []
    monkeypatch.setattr(ops, "quantize_rows", calls.append)
    with _runtime([g], _halves(tc, g), zoo) as rt:
        st = rt.infer_sync([0])
        stats = rt.stats()
    assert not calls and st.makespan is not None
    assert stats["transport"]["zero_copies"] == 2 and stats["pool"]["mallocs"] == 0


def test_virtual_mode_needs_a_spec(zoo, ref_zoo):
    """As in the reference: virtual mode without a FastSimSpec raises
    ``ValueError``; real mode takes ``faults`` and ``recovery`` and only
    names the faults at ``close()``."""
    graphs = _graphs(zoo)
    sol = _solution(tc, graphs)
    for pkg, rt_pkg, g, kw in ((tc, tr, graphs, {"device": "cpu"}),
                               (rc, rr, _graphs(ref_zoo), {})):
        with pytest.raises(ValueError, match="FastSimSpec"):
            rt_pkg.PuzzleRuntime(g, _solution(pkg, g), pkg.mobile_processors(),
                                 None, rt_pkg.RuntimeConfig(virtual=True), **kw)
    faults = tc.FaultSpec(dropouts=((2, 0.5, None),), seed=1)
    with _runtime(graphs, sol, zoo, tr.RuntimeConfig(
            faults=faults, recovery=tr.RecoveryPolicy())) as rt:
        st = rt.infer_sync([0, 1])
    assert st.makespan is not None and rt.recovery_events == []


def test_runtime_without_device_needs_a_card(zoo):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    graphs = _graphs(zoo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.PuzzleRuntime(graphs, _solution(tc, graphs), tc.mobile_processors(), zoo)


def test_executables_on_another_device_are_refused(zoo):
    graphs = _graphs(zoo)
    with pytest.raises(ValueError, match="lives on"):
        tr.PuzzleRuntime(graphs, _solution(tc, graphs), tc.mobile_processors(), zoo,
                         device="meta")
