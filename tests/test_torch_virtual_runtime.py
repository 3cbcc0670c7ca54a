"""The port's virtual-clock PuzzleRuntime against the JAX package's.

The virtual-mode tests of ``tests/test_runtime.py`` run on both runtimes
with the same nets, solutions and seeds (built in each package from one
seed); every trace, request state and busy time must be equal, compared
with ``==`` (tolerance: none). Virtual mode executes nothing, so these run
with no device; one case hides CUDA and fails any device lookup to show it.
"""
import dataclasses
import random

import pytest
import torch

import repro.core as rc
import repro.runtime as rr
import repro_torch.core as tc
import repro_torch.runtime as tr
from test_torch_sched_inputs import PKGS, procs_and_profiler

RUNTIMES = {"ref": rr, "port": tr}


def _nets(pkg):
    return [
        pkg.chain_graph("vx", [("conv", 4e6, 1000, 4000)] * 5),
        pkg.branching_graph("vy", [("conv", 2e6, 800, 2000)] * 4,
                            [(0, 1), (0, 2), (1, 3), (2, 3)]),
    ]


def _sol(pkg, nets, seed):
    return pkg.SolutionFactory(nets, num_processors=3,
                               rng=random.Random(seed)).random_solution()


def _virtual_runtime(tag, seed, noise_seed=None, dispatch=0.0, faults=None,
                     **cfg_kw):
    pkg, rt_pkg = PKGS[tag], RUNTIMES[tag]
    nets = _nets(pkg)
    sol = _sol(pkg, nets, seed)
    procs, prof = procs_and_profiler(pkg)
    spec = pkg.build_spec(pkg.decode_solution(sol, nets), procs, prof,
                          pkg.PAPER_COMM_MODEL)
    noise = pkg.NoiseModel(seed=noise_seed) if noise_seed is not None else None
    rt = rt_pkg.PuzzleRuntime(
        nets, sol, procs,
        config=rt_pkg.RuntimeConfig(virtual=True, noise=noise,
                                    dispatch_overhead=dispatch, faults=faults,
                                    **cfg_kw),
        spec=spec,
    )
    return rt, spec, nets, sol


def _trace(rt):
    return [dataclasses.astuple(t) for t in rt.coordinator.trace]


def _states(states):
    return [[(st.request_id, st.group, st.group_request, st.submitted,
              st.first_start, st.last_finish, st.finish, st.makespan,
              st.done_tasks, st.task_records) for st in glist]
            for glist in states]


def _busy(rt):
    return {pid: (w.busy_time, w.tasks_done) for pid, w in rt.workers.items()}


def test_virtual_end_to_end_inference_matches_reference():
    out = {}
    for tag in PKGS:
        rt, _, nets, sol = _virtual_runtime(tag, seed=3)
        with rt:
            st = rt.infer_sync([0, 1])
            assert st.makespan is not None and st.makespan > 0
            placed = PKGS[tag].decode_solution(sol, nets)
            assert len(st.task_records) == sum(len(p) for p in placed)
            assert rt.clock.now() == st.finish
            out[tag] = (_states([[st]]), _trace(rt), _busy(rt))
    assert out["port"] == out["ref"]


def test_virtual_cross_processor_dependency_order():
    """The consumer subgraph starts only after its producer finishes."""
    out = {}
    for tag in PKGS:
        rt, *_ = _virtual_runtime(tag, seed=5)
        with rt:
            rt.infer_sync([0, 1])
            finished = {(r.network, r.sg_index): r.finished
                        for r in rt.coordinator.trace}
            deps = rt.coordinator._deps
            for rec in rt.coordinator.trace:
                for producer in deps[rec.network][rec.sg_index]:
                    assert rec.started >= finished[(rec.network, producer)]
            out[tag] = (deps, _trace(rt))
    assert out["port"] == out["ref"]


def test_virtual_periodic_requests_all_complete():
    out = {}
    for tag in PKGS:
        rt, *_ = _virtual_runtime(tag, seed=7)
        with rt:
            res = rt.run_periodic([[0], [1]], [0.02, 0.03], num_requests=4)
            assert [len(g) for g in res] == [4, 4]
            assert all(st.makespan is not None for g in res for st in g)
            for gid, period in enumerate([0.02, 0.03]):
                for rid, st in enumerate(res[gid]):
                    assert st.submitted == rid * period
            out[tag] = (_states(res), _trace(rt), _busy(rt), rt.stats())
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("noise_seed,dispatch", [(None, 0.0), (4, 0.0),
                                                 (None, 150e-6), (4, 150e-6)])
def test_virtual_runtime_matches_fastsim_and_reference(noise_seed, dispatch):
    groups, periods, nr = [[0], [1]], [0.004, 0.006], 6
    out = {}
    for tag, pkg in PKGS.items():
        rt, spec, *_ = _virtual_runtime(tag, seed=11, noise_seed=noise_seed,
                                        dispatch=dispatch)
        with rt:
            states = rt.run_periodic(groups, periods, num_requests=nr)
            got = RUNTIMES[tag].runtime_result(rt, states, periods, nr)
        noise = pkg.NoiseModel(seed=noise_seed) if noise_seed is not None else None
        want = pkg.FastSimulator(
            spec, groups=groups, periods=periods, num_requests=nr,
            noise=noise, dispatch_overhead=dispatch,
        ).run(collect_tasks=True)
        doc = RUNTIMES[tag].serialize_result(got)
        assert doc == RUNTIMES[tag].serialize_result(want)
        out[tag] = doc
    assert out["port"] == out["ref"]


def test_virtual_runtime_is_deterministic():
    traces = []
    for _ in range(2):
        rt, *_ = _virtual_runtime("port", seed=13, noise_seed=9)
        with rt:
            states = rt.run_periodic([[0, 1]], [0.01], num_requests=5)
            assert all(st.makespan is not None for st in states[0])
            traces.append(_trace(rt))
    rt, *_ = _virtual_runtime("ref", seed=13, noise_seed=9)
    with rt:
        rt.run_periodic([[0, 1]], [0.01], num_requests=5)
        traces.append(_trace(rt))
    assert traces[0] == traces[1] == traces[2]


def test_virtual_clock_event_ordering():
    fired = {}
    for tag, rt_pkg in RUNTIMES.items():
        clock = rt_pkg.VirtualClock()
        log = fired[tag] = []
        clock.schedule(0.5, lambda: log.append("b"))
        clock.schedule(0.5, lambda: log.append("c"))  # same time: push order
        clock.schedule(0.1, lambda: log.append("a"))
        clock.schedule(2.0, lambda: log.append("past-horizon"))
        clock.run(until=1.0)
        assert clock.now() == 0.5 and clock.pending == 1
    assert fired["port"] == fired["ref"] == ["a", "b", "c"]


def test_sim_cost_source_matches_reference():
    out = {}
    for tag, pkg in PKGS.items():
        _, spec, *_ = _virtual_runtime(tag, seed=2)
        procs = pkg.mobile_processors()
        src = RUNTIMES[tag].SimCostSource(
            spec, procs, noise=pkg.NoiseModel(seed=6), dispatch_overhead=1e-4,
            faults=pkg.FaultSpec(straggler_prob=0.3, straggler_shape=1.5,
                                 seed=2))
        costs = [src.costs(n, 0) for n in range(2)]
        draws = [src.noisy_exec(i % 3, 1e-3 * (i + 1)) for i in range(30)]
        faulted = [src.fault_stream.service(i % 3, 1e-3 * i, 1e-3)
                   for i in range(30)]
        out[tag] = (costs, draws, faulted)
    assert out["port"] == out["ref"]


def _solution_using(pkg, nets, pid):
    for seed in range(64):
        cand = _sol(pkg, nets, seed)
        if any(p.processor == pid for pl in pkg.decode_solution(cand, nets)
               for p in pl):
            return cand
    raise AssertionError(f"no draw uses pid {pid}")


def test_close_during_injected_fault_names_the_fault():
    """Closing a virtual runtime whose requests a dropout stranded fails the
    pending futures with an error naming the fault, as the reference does."""
    out = {}
    for tag, pkg in PKGS.items():
        rt_pkg = RUNTIMES[tag]
        nets = _nets(pkg)
        sol = _solution_using(pkg, nets, 2)
        procs, prof = procs_and_profiler(pkg)
        spec = pkg.build_spec(pkg.decode_solution(sol, nets), procs, prof,
                              pkg.PAPER_COMM_MODEL)
        rt = rt_pkg.PuzzleRuntime(
            nets, sol, procs,
            config=rt_pkg.RuntimeConfig(
                virtual=True,
                faults=pkg.FaultSpec(dropouts=((2, 0.008, None),), seed=3)),
            spec=spec)
        states = rt.run_periodic([[0, 1]], [0.004], num_requests=8)
        stranded = [st for st in states[0] if not st.future.done()]
        assert stranded, "the dropout must strand at least one request"
        rt.close()
        errors = []
        for st in stranded:
            with pytest.raises(RuntimeError, match=r"processor 2 dropped at "
                                                   r"t=0\.008") as err:
                st.future.result(timeout=0)
            errors.append(str(err.value))
        assert not any(w.threads_alive() for w in rt.workers.values())
        for w in rt.workers.values():
            assert not w._vstore
            assert w._queue.empty() and w._exec_queue.empty()
        rt.close()  # idempotent
        out[tag] = (errors, _trace(rt), _states(states))
    assert out["port"] == out["ref"]


def test_virtual_runtime_needs_no_card(monkeypatch):
    """Virtual mode with CUDA hidden and no ``device``: nothing resolves a
    device, no Worker makes a stream, the pool allocates nothing, and K1 is
    launched zero times (and its plain version never called) with
    ``int8_staging`` on; the trace still equals the reference's."""
    import repro_torch.kernels.int8_quant as k1
    import repro_torch.runtime.runtime as runtime_mod

    def no_device(*args, **kwargs):
        raise AssertionError("virtual mode resolved a device")

    plain_calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(runtime_mod, "resolve_device", no_device)
    monkeypatch.setattr(k1, "quantize_int8_plain",
                        lambda *a, **kw: plain_calls.append(a))
    launches = k1.quantize_int8.launches
    nets = _nets(tc)
    # every network int8, cut apart over the three processors: each
    # subgraph boundary is one K1 staging in real mode
    sol = _sol(tc, nets, 3)
    sol.dtype = [2] * len(nets)
    sol.partition = [[1] * g.num_edges for g in nets]
    sol.mapping = [[i % 3 for i in range(g.num_layers)] for g in nets]
    procs, prof = procs_and_profiler(tc)
    spec = tc.build_spec(tc.decode_solution(sol, nets), procs, prof,
                         tc.PAPER_COMM_MODEL)
    cfg = tr.RuntimeConfig(virtual=True, int8_staging=True,
                           noise=tc.NoiseModel(seed=1), dispatch_overhead=1e-4)
    with tr.PuzzleRuntime(nets, sol, procs, config=cfg, spec=spec) as rt:
        assert rt.device is None
        assert all(w.stream is None and not w.threads_alive()
                   for w in rt.workers.values())
        states = rt.run_periodic([[0, 1]], [0.01], num_requests=4)
        got = tr.runtime_result(rt, states, [0.01], 4)
        stats = rt.stats()
    assert all(st.makespan is not None for st in states[0])
    assert stats["pool"]["mallocs"] == 0 and stats["pool"]["bytes_allocated"] == 0
    assert k1.quantize_int8.launches == launches and plain_calls == []
    assert not torch.cuda.is_initialized()

    ref_nets = _nets(rc)
    ref_sol = rc.Solution(partition=sol.partition, mapping=sol.mapping,
                          priority=sol.priority, dtype=sol.dtype,
                          backend=sol.backend)
    rprocs, rprof = procs_and_profiler(rc)
    rspec = rc.build_spec(rc.decode_solution(ref_sol, ref_nets), rprocs, rprof,
                          rc.PAPER_COMM_MODEL)
    want = rr.run_virtual_schedule(ref_nets, ref_sol, rprocs, rspec, [[0, 1]],
                                   [0.01], 4, noise=rc.NoiseModel(seed=1),
                                   dispatch_overhead=1e-4)
    assert tr.serialize_result(got) == rr.serialize_result(want)
