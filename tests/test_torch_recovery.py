"""The port's fault recovery against the JAX package's.

The cases of ``tests/test_recovery.py`` run on both runtimes with the same
nets, solutions and fault ensembles, built in each package from one seed:
dropout → remap (greedy and a registered backup), the stall intercept, a
dropout with no survivor, straggler timeouts and retries. Recovery runs
are not bit-comparable to the simulators, but they are deterministic, so
the port's ``recovery_events``, traces and request states must equal the
reference's (``==``). The real-mode Worker's error handling and the
measured-cost guard run on ``device="cpu"``.
"""
import dataclasses
import math
import random
import threading

import pytest
import torch

import repro.core as rc
import repro.runtime as rr
import repro_torch.core as tc
import repro_torch.runtime as tr
from test_torch_sched_inputs import PKGS, procs_and_profiler

RUNTIMES = {"ref": rr, "port": tr}
GROUPS, PERIODS, NR = [[0, 1], [2]], [0.004, 0.006], 8


def _nets(pkg):
    return [
        pkg.chain_graph("ra", [("conv", 4e6, 1000, 4000)] * 5),
        pkg.branching_graph("rb", [("conv", 2e6, 800, 2000)] * 4,
                            [(0, 1), (0, 2), (1, 3), (2, 3)]),
        pkg.chain_graph("rc", [("fc", 8e6, 2000, 8000)] * 3),
    ]


def _solution_using(pkg, nets, pid, seed0=0):
    """First SolutionFactory draw that places work on ``pid``."""
    for seed in range(seed0, seed0 + 64):
        fac = pkg.SolutionFactory(nets, num_processors=3,
                                  rng=random.Random(seed), cut_prob=0.4)
        sol = fac.random_solution()
        if any(p.processor == pid
               for pl in pkg.decode_solution(sol, nets) for p in pl):
            return sol
    raise AssertionError(f"no draw uses pid {pid}")


def _drawn(pkg, nets):
    return pkg.SolutionFactory(nets, num_processors=3, rng=random.Random(0),
                               cut_prob=0.4).random_solution()


def _dropout(pkg):
    return pkg.FaultSpec(dropouts=((2, 0.010, None),), seed=5)


def _runtime(tag, nets, sol, faults, recovery):
    pkg, rt_pkg = PKGS[tag], RUNTIMES[tag]
    procs, prof = procs_and_profiler(pkg)
    spec = pkg.build_spec(pkg.decode_solution(sol, nets), procs, prof,
                          pkg.PAPER_COMM_MODEL)
    return rt_pkg.PuzzleRuntime(
        nets, sol, procs,
        config=rt_pkg.RuntimeConfig(virtual=True, faults=faults,
                                    recovery=recovery),
        spec=spec,
    )


def _record(rt, res):
    """Everything a recovery run leaves behind, for the equality checks."""
    return {
        "events": [e.to_json() for e in rt.recovery_events],
        "trace": [dataclasses.astuple(t) for t in rt.coordinator.trace],
        "makespans": [[st.makespan for st in gl] for gl in res],
        "placed": [[p.processor for p in pl] for pl in rt.placed],
        "busy": {pid: (w.busy_time, w.tasks_done) for pid, w in rt.workers.items()},
    }


# -- dropout → remap ---------------------------------------------------------

def test_dropout_remap_keeps_inflight_requests():
    out = {}
    for tag, pkg in PKGS.items():
        nets = _nets(pkg)
        sol = _solution_using(pkg, nets, pid=2)
        with _runtime(tag, nets, sol, _dropout(pkg), None) as raw_rt:
            raw = raw_rt.run_periodic(GROUPS, PERIODS, num_requests=NR)
        assert sum(st.makespan is None for gl in raw for st in gl) > 0
        rt = _runtime(tag, nets, sol, _dropout(pkg),
                      RUNTIMES[tag].RecoveryPolicy())
        with rt:
            res = rt.run_periodic(GROUPS, PERIODS, num_requests=NR)
        assert all(st.makespan is not None for gl in res for st in gl)
        remaps = [e for e in rt.recovery_events if e.kind == "remap"]
        assert len(remaps) == 1 and remaps[0].pid == 2
        assert remaps[0].time == 0.010
        for rec in rt.coordinator.trace:
            if rec.processor == 2 and rec.started is not None:
                assert rec.started <= 0.010
        assert all(p.processor != 2 for pl in rt.placed for p in pl)
        out[tag] = (_record(raw_rt, raw), _record(rt, res))
    assert out["port"] == out["ref"]


def test_dropout_remap_uses_registered_backup():
    out = {}
    for tag, pkg in PKGS.items():
        nets = _nets(pkg)
        sol = _solution_using(pkg, nets, pid=2)
        procs, prof = procs_and_profiler(pkg)
        sc = pkg.Scenario(name="rt-backup", graphs=tuple(nets),
                          groups=((0, 1), (2,)))
        an = pkg.StaticAnalyzer(sc, procs, prof, pkg.PAPER_COMM_MODEL)
        backup_sol, remap = an.backup_mapping(sol, dead_pid=2)
        assert remap and all(pid != 2 for pid in remap.values())
        bspec = pkg.build_spec(pkg.decode_solution(backup_sol, nets), procs,
                               prof, pkg.PAPER_COMM_MODEL)
        rt = _runtime(tag, nets, sol, _dropout(pkg),
                      RUNTIMES[tag].RecoveryPolicy())
        rt.set_backup(2, remap, spec=bspec)
        with rt:
            res = rt.run_periodic(GROUPS, PERIODS, num_requests=NR)
        assert all(st.makespan is not None for gl in res for st in gl)
        ev = [e for e in rt.recovery_events if e.kind == "remap"][0]
        assert ev.detail["backup"] == "registered"
        src = rt._cost_source
        assert set(src.override) == {bspec.offsets[n] + k for n, k in remap}
        for (n, k), new_pid in remap.items():
            assert rt.placed[n][k].processor == new_pid
        out[tag] = (remap, sorted(src.override.items()), _record(rt, res))
    assert out["port"] == out["ref"]


def test_set_backup_rejects_remap_onto_dead_pid():
    nets = _nets(tc)
    sol = _solution_using(tc, nets, pid=2)
    with _runtime("port", nets, sol, _dropout(tc), tr.RecoveryPolicy()) as rt:
        with pytest.raises(ValueError, match="dead pid 2"):
            rt.set_backup(2, {(0, 0): 2})


def test_stall_intercept_reroutes_without_scheduled_remap():
    """With the scheduled dropout handler removed, a task delivered onto the
    dead processor is intercepted, triggers the remap and is re-routed."""
    out = {}
    for tag, pkg in PKGS.items():
        nets = _nets(pkg)
        sol = _solution_using(pkg, nets, pid=2)
        rt = _runtime(tag, nets, sol, _dropout(pkg),
                      RUNTIMES[tag].RecoveryPolicy())
        assert rt.clock.pending == 1
        rt.clock._events.clear()
        with rt:
            res = rt.run_periodic(GROUPS, PERIODS, num_requests=NR)
        assert all(st.makespan is not None for gl in res for st in gl)
        remaps = [e for e in rt.recovery_events if e.kind == "remap"]
        assert len(remaps) == 1 and remaps[0].time >= 0.010
        out[tag] = _record(rt, res)
    assert out["port"] == out["ref"]


def test_no_survivors_degrades_without_livelock():
    out = {}
    for tag, pkg in PKGS.items():
        rt_pkg = RUNTIMES[tag]
        nets = _nets(pkg)[:1]
        one_proc = pkg.mobile_processors()[:1]
        profiler = pkg.Profiler(pkg.AnalyticMobileBackend(one_proc))
        sol = pkg.SolutionFactory(nets, num_processors=1, rng=random.Random(1),
                                  cut_prob=0.5).random_solution()
        spec = pkg.build_spec(pkg.decode_solution(sol, nets), one_proc,
                              profiler, pkg.PAPER_COMM_MODEL)
        rt = rt_pkg.PuzzleRuntime(
            nets, sol, one_proc,
            config=rt_pkg.RuntimeConfig(
                virtual=True,
                faults=pkg.FaultSpec(dropouts=((0, 0.006, None),), seed=1),
                recovery=rt_pkg.RecoveryPolicy()),
            spec=spec)
        with rt:
            res = rt.run_periodic([[0]], [0.004], num_requests=6)
        assert sum(st.makespan is None for st in res[0]) > 0
        assert sum(st.makespan is not None for st in res[0]) > 0
        out[tag] = _record(rt, res)
    assert out["port"] == out["ref"]


def test_greedy_remap_matches_reference():
    out = {}
    for tag, pkg in PKGS.items():
        nets = _nets(pkg)
        placed = pkg.decode_solution(_solution_using(pkg, nets, pid=2), nets)
        a = RUNTIMES[tag].greedy_remap(placed, 2, [0, 1], load={0: 0.5})
        assert a == RUNTIMES[tag].greedy_remap(placed, 2, [0, 1], load={0: 0.5})
        owned = {(n, k) for n, pl in enumerate(placed)
                 for k, p in enumerate(pl) if p.processor == 2}
        assert set(a) == owned and set(a.values()) <= {0, 1}
        with pytest.raises(ValueError):
            RUNTIMES[tag].greedy_remap(placed, 2, [])
        out[tag] = (a, RUNTIMES[tag].greedy_remap(placed, 2, [1, 0]))
    assert out["port"] == out["ref"]


def test_recovery_policy_matches_reference():
    for kw in ({}, {"timeout_factor": 3.0, "min_timeout": 1e-5},
               {"max_retries": 0, "backoff": 0.0, "remap": False}):
        a, b = tr.RecoveryPolicy(**kw), rr.RecoveryPolicy(**kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert [a.timeout_for(t) for t in (0.0, 1e-5, 1e-3, 0.2)] == \
            [b.timeout_for(t) for t in (0.0, 1e-5, 1e-3, 0.2)]
    ev = tr.RecoveryEvent(kind="retry", time=0.5, pid=1, detail={"attempt": 2})
    assert ev.to_json() == rr.RecoveryEvent(
        kind="retry", time=0.5, pid=1, detail={"attempt": 2}).to_json()


# -- straggler timeout + retry ----------------------------------------------

def test_straggler_retries_are_recorded_and_bounded():
    out = {}
    for tag, pkg in PKGS.items():
        nets = _nets(pkg)
        faults = pkg.FaultSpec(straggler_prob=0.5, straggler_shape=0.8, seed=11)
        pol = RUNTIMES[tag].RecoveryPolicy(max_retries=2, timeout_factor=3.0,
                                           min_timeout=1e-5)
        rt = _runtime(tag, nets, _drawn(pkg, nets), faults, pol)
        with rt:
            res = rt.run_periodic(GROUPS, PERIODS, num_requests=NR)
        retries = [e for e in rt.recovery_events if e.kind == "retry"]
        assert retries, "heavy-tailed stragglers must trip the watchdog"
        per_task = {}
        for e in retries:
            key = (e.detail["request"], e.detail["net"], e.detail["sg"])
            per_task[key] = max(per_task.get(key, 0), e.detail["attempt"])
            assert e.detail["total_s"] > e.detail["timeout_s"]
        assert all(n <= pol.max_retries for n in per_task.values())
        assert all(st.makespan is not None for gl in res for st in gl)
        out[tag] = _record(rt, res)
    assert out["port"] == out["ref"]


def test_clean_run_with_recovery_has_no_events():
    out = {}
    for tag, pkg in PKGS.items():
        nets = _nets(pkg)
        rt = _runtime(tag, nets, _drawn(pkg, nets), None,
                      RUNTIMES[tag].RecoveryPolicy())
        with rt:
            res = rt.run_periodic(GROUPS, PERIODS, num_requests=NR)
        assert rt.recovery_events == []
        assert all(st.makespan is not None for gl in res for st in gl)
        out[tag] = _record(rt, res)
    assert out["port"] == out["ref"]


def test_score_under_faults_reports_clean_vs_faulted():
    out = {}
    for tag, pkg in PKGS.items():
        nets = _nets(pkg)
        procs, prof = procs_and_profiler(pkg)
        sc = pkg.Scenario(
            name="suf", graphs=tuple(nets), groups=((0, 1), (2,)),
            faults=pkg.FaultSpec(dropouts=((2, 0.010, None),),
                                 straggler_prob=0.2, straggler_shape=1.5,
                                 seed=7))
        an = pkg.StaticAnalyzer(sc, procs, prof, pkg.PAPER_COMM_MODEL)
        rep = an.score_under_faults(_solution_using(pkg, nets, pid=2),
                                    num_requests=NR)
        assert rep["dropped_faulted"] > rep["dropped_clean"]
        assert rep["satisfaction_faulted"] <= rep["satisfaction_clean"]
        out[tag] = rep
    assert out["port"] == out["ref"]


# -- worker hardening: errors fail the request, not the thread -----------------

def _real_worker(collected, event):
    """A threaded (real-mode) Worker on the CPU with one stub engine."""
    class StubEngine:
        exec_times = {}

        def execute(self, key, inputs=None):
            if key != "good":
                raise KeyError(key)
            return 42

    def on_done(payload, result, quant_t, exec_t):
        collected.append(result)
        event.set()

    pool = tr.TensorPool(device="cpu")
    w = tr.Worker(1, "gpu", {"default": StubEngine()}, pool,
                  tr.SharedBufferTransport(pool), on_done,
                  device=torch.device("cpu"))
    w.start()
    return w


def _payload(backend="default", engine_key="good"):
    return {"request": 0, "net": 3, "sg": 1, "dtype": "fp16",
            "backend": backend, "engine_key": engine_key, "inputs": None,
            "released": 0.0}


def test_unknown_backend_fails_task_not_thread():
    collected, event = [], threading.Event()
    w = _real_worker(collected, event)
    try:
        w.submit((0, 0, 1), _payload(backend="no-such-backend"))
        assert event.wait(5.0), "worker thread died instead of reporting"
        err = collected[-1]
        assert isinstance(err, tr.WorkerExecutionError)
        for frag in ("net=3", "sg=1", "processor 1", "gpu", "no-such-backend"):
            assert frag in str(err)
        assert w.threads_alive()
        event.clear()
        w.submit((0, 0, 2), _payload())
        assert event.wait(5.0)
        assert collected[-1] == 42
    finally:
        w.stop()
    assert not w.threads_alive()


def test_unloaded_engine_key_fails_task_not_thread():
    collected, event = [], threading.Event()
    w = _real_worker(collected, event)
    try:
        w.submit((0, 0, 1), _payload(engine_key="never-loaded"))
        assert event.wait(5.0)
        err = collected[-1]
        assert isinstance(err, tr.WorkerExecutionError)
        assert "net=3" in str(err) and "processor 1" in str(err)
        assert w.threads_alive()
    finally:
        w.stop()


def test_staging_error_fails_task_not_thread():
    collected, event = [], threading.Event()
    w = _real_worker(collected, event)
    try:
        bad = _payload()
        bad["inputs"] = [(object(), "fp32")]  # unconvertible tensor
        w.submit((0, 0, 1), bad)
        assert event.wait(5.0)
        err = collected[-1]
        assert isinstance(err, tr.WorkerExecutionError)
        assert "staging" in str(err)
        assert w.threads_alive()
    finally:
        w.stop()


# -- measured-cost guard: partial/poisoned sample sets ---------------------------

def test_measured_costs_skips_unusable_samples():
    out = {}
    for tag, pkg in PKGS.items():
        nets = _nets(pkg)
        sol = pkg.SolutionFactory(nets, num_processors=3,
                                  rng=random.Random(0)).random_solution()
        rt = _runtime(tag, nets, sol, None, None)
        with rt:
            eng = next(iter(rt.workers[0].engines.values()))
            eng.exec_times["empty"] = []
            eng.exec_times["poisoned"] = [math.inf, -1.0, 0.0]
            eng.exec_times["ok"] = [0.5, 0.3, math.nan, 0.4]
            costs = rt.measured_costs()
        assert "empty" not in costs and "poisoned" not in costs
        assert costs["ok"] == 0.3
        assert rt.measured_cost_skips == 2
        out[tag] = costs
    assert out["port"] == out["ref"]
