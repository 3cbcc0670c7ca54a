"""Record types of the runtime simulation (from ``repro.core.simulator``).

Only what the real-mode runtime uses for now: :class:`NoiseModel` and
:class:`TaskRecord`, verbatim. The discrete-event simulator joins them
with the virtual-clock runtime (ROADMAP Queue 1, slice 6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class NoiseModel:
    """Execution-time fluctuation per processor kind (§6.3).

    The paper observes large run-to-run variance, worst on the CPU (which
    also runs the scheduler/dispatcher and system tasks) and small on the
    NPU. Samples are lognormal multipliers around 1.0. The *fast* simulator
    runs clean (the paper's SimPy model is deterministic too); the
    *measurement* evaluation applies noise — that is the device-in-the-loop
    distinction that let Puzzle reject fluctuation-sensitive solutions.
    """

    sigma_by_kind: Tuple[Tuple[str, float], ...] = (
        ("cpu", 0.22), ("gpu", 0.07), ("npu", 0.03), ("tpu-lane", 0.02),
    )
    seed: int = 0

    def sigma(self, kind: str) -> float:
        for k, s in self.sigma_by_kind:
            if k == kind:
                return s
        return 0.05


@dataclass
class TaskRecord:
    """Execution trace of one subgraph instance."""

    group: int
    request: int
    network: int
    sg_index: int
    processor: int
    released: float = 0.0
    started: float = 0.0
    finished: float = 0.0
    comm_time: float = 0.0
    exec_time: float = 0.0
    quant_time: float = 0.0
