"""Puzzle Runtime on the card: Coordinator / Workers / Engines + the §5.3
memory optimizations, measured-cost extraction, and the virtual-clock
conformance tier with fault recovery (port of ``repro.runtime``)."""
from .clock import SimCostSource, VirtualClock, WallClock
from .conformance import (
    ConformanceReport,
    build_report,
    run_virtual_schedule,
    runtime_result,
    serialize_result,
)
from .coordinator import Coordinator, RequestState
from .engine import (
    ENGINE_REGISTRY,
    Bf16ConvGraphEngine,
    EagerEngine,
    Engine,
    GraphEngine,
    make_engine,
)
from .recovery import RecoveryEvent, RecoveryPolicy, greedy_remap
from .runtime import PuzzleRuntime, RuntimeConfig
from .tensorpool import CHUNK, PoolStats, SharedBufferTransport, TensorPool
from .worker import DISPATCH_TOKEN, Worker, WorkerExecutionError

__all__ = [k for k in dir() if not k.startswith("_")]
