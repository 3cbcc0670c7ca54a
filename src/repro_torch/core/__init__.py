"""The port's copies of the scheduling core that the runtime needs.

Each module is a copy of its ``repro.core`` counterpart (which carries no
JAX), held to it by ``tests/test_torch_zoo.py``; the profiler's executing
backend runs on the card.
"""
from .arrivals import ARRIVAL_KINDS, ArrivalSpec, arrival_horizon, draw_arrivals
from .chromosome import (
    BACKENDS,
    DTYPES,
    PlacedSubgraph,
    Solution,
    SolutionFactory,
    decode_solution,
    subgraph_processor,
    upmx,
)
from .graph import Edge, Layer, ModelGraph, Subgraph, branching_graph, chain_graph
from .memlayout import CHUNK, rounded_chunk_bytes
from .processors import Processor, mobile_processors
from .profiler import (
    AnalyticMobileBackend,
    ProfileDB,
    Profiler,
    TableBackend,
    TorchExecBackend,
    fragmentation_penalty,
)
from .simulator import NoiseModel, TaskRecord

__all__ = [k for k in dir() if not k.startswith("_")]
