"""Puzzle Runtime on the card: Coordinator / Workers / Engines + the §5.3
memory optimizations, and measured-cost extraction (port of
``repro.runtime``, real-execution mode)."""
from .clock import WallClock
from .coordinator import Coordinator, RequestState
from .engine import (
    ENGINE_REGISTRY,
    Bf16ConvGraphEngine,
    EagerEngine,
    Engine,
    GraphEngine,
    make_engine,
)
from .runtime import PuzzleRuntime, RuntimeConfig
from .tensorpool import CHUNK, PoolStats, SharedBufferTransport, TensorPool
from .worker import Worker, WorkerExecutionError

__all__ = [k for k in dir() if not k.startswith("_")]
