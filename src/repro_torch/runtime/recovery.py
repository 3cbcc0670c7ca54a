"""Recovery policies: graceful degradation under injected faults.

The fault layer (:mod:`repro_torch.core.faults`) is deliberately recovery-free —
the four engine tiers realize faults identically so the parity oracle
stays bit-exact. This module is the *policy* layer on top: what the
runtime does about a fault once it happens.

Two mechanisms, both bounded and deterministic under the virtual clock:

* **timeout + retry-and-backoff** — a delivered task whose (faulted)
  service time exceeds ``timeout_factor ×`` its clean estimate is aborted
  at the timeout and re-delivered after ``backoff`` seconds, up to
  ``max_retries`` times; a retry re-samples the noise and fault streams,
  so a straggler draw usually clears. Exhausted retries run the task to
  completion rather than failing the request — recovery degrades
  gracefully, it never drops work the fault itself would not have dropped.
  Stall time from a dropout is *excluded* from the timeout check: retrying
  into a dead processor cannot help, the remap below can.
* **dropout → fallback remap** — at a *permanent* dropout the runtime
  re-routes every subgraph placed on the dead processor to a backup
  placement (precomputed via
  ``StaticAnalyzer.backup_mapping`` — the next-best placement excluding
  that processor — or the greedy least-loaded fallback here), drains the
  dead worker's queue into the new placement, and re-issues any task that
  was stalled in flight. In-flight requests survive: their already-running
  tasks complete (the model is non-preemptive) and their remaining tasks
  follow the new placement.

Recovery runs are *not* bit-comparable to the simulator tiers (they
consume extra stream draws and change placements mid-run); parity-oracle
runs always use ``recovery=None``.

Copy of ``repro.runtime.recovery``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs for the runtime's fault-recovery behaviour.

    ``timeout_factor`` scales each subgraph's *clean* service time
    (exec + quant + comm from the cost source) into its per-task execution
    timeout, floored at ``min_timeout`` so tiny subgraphs are not retried
    on scheduling jitter. ``backoff`` is the delay before each re-delivery,
    multiplied by the attempt number (linear backoff). ``remap`` gates the
    dropout → backup-mapping re-route.
    """

    max_retries: int = 2
    backoff: float = 0.0005
    timeout_factor: float = 8.0
    min_timeout: float = 0.002
    remap: bool = True

    def timeout_for(self, clean_total: float) -> float:
        """Per-task execution timeout for a clean service-time estimate."""
        t = self.timeout_factor * clean_total
        return t if t > self.min_timeout else self.min_timeout


def greedy_remap(
    placed: Sequence[Sequence[object]],
    dead_pid: int,
    survivor_pids: Sequence[int],
    load: Optional[Dict[int, float]] = None,
) -> Dict[Tuple[int, int], int]:
    """Fallback backup mapping: move each dead-processor subgraph to the
    least-loaded survivor (deterministic: ties break on pid).

    ``load`` seeds the per-survivor load estimate (e.g. current busy
    times); each assignment adds the subgraph's weight so consecutive
    moves spread. Returns ``(net, k) -> new_pid`` for exactly the
    subgraphs owned by ``dead_pid``. Prefer
    ``StaticAnalyzer.backup_mapping`` when a profiler is available — it
    picks per-subgraph fastest survivors instead of balancing blindly.
    """
    if not survivor_pids:
        raise ValueError("no surviving processors to remap onto")
    est: Dict[int, float] = {pid: 0.0 for pid in survivor_pids}
    if load:
        for pid, v in load.items():
            if pid in est:
                est[pid] = float(v)
    remap: Dict[Tuple[int, int], int] = {}
    for net, plist in enumerate(placed):
        for k, p in enumerate(plist):
            if p.processor != dead_pid:
                continue
            target = min(est, key=lambda pid: (est[pid], pid))
            remap[(net, k)] = target
            # weight by layer count: a cheap, profiler-free size proxy
            est[target] += float(len(p.subgraph.layer_ids))
    return remap


@dataclass
class RecoveryEvent:
    """One recovery action taken by the runtime (for reports/benchmarks)."""

    kind: str            # "remap" | "retry"
    time: float
    pid: int             # dead pid (remap) / executing pid (retry)
    detail: Dict[str, object]

    def to_json(self) -> Dict[str, object]:
        return {"kind": self.kind, "time": self.time, "pid": self.pid,
                **self.detail}
