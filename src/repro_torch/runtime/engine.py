"""Engine: thin abstraction over execution backends (paper §5.1); port of
``repro.runtime.engine``.

Engines hide framework details from Workers — the paper wraps Qualcomm AI
Engine Direct, ORT and TVM. Here the three keep the reference's names and
roles: ``default`` is the compiled fast path (a CUDA graph captured at load,
the counterpart of ``jax.jit``'s compile), ``xnnpack`` a second compiled
profile with each convolution in bf16 (the counterpart of
``default_matmul_precision("bfloat16")``), and ``nnapi`` eager op-by-op
execution (reliably the slowest, reproducing Table 2's ordering). On the
CPU, which only tests ask for, ``default`` and ``xnnpack`` run eagerly with
the same precision rules. New engines register via ``ENGINE_REGISTRY``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Sequence, Tuple

import torch

from ..core.chromosome import PlacedSubgraph
from ..precision import bf16_convs


class Engine:
    """Loads subgraphs once, executes many times (keyed by Merkle hash).

    Every execution is timed (injectable ``timer``, default
    ``time.perf_counter``) around the call and a synchronisation of the
    caller's current stream — the Worker's — and recorded per key in
    ``exec_times``. The keys *are* Merkle profile keys, so these samples
    feed straight back into the :class:`~repro_torch.core.profiler.ProfileDB`
    as device-in-the-loop measurements (``PuzzleRuntime.measured_costs``).
    Load-time warm-up runs are not recorded, and only the most recent
    ``MAX_SAMPLES`` per key are kept — a long-lived serving runtime must not
    grow without bound.
    """

    name = "base"
    MAX_SAMPLES = 64

    def __init__(self, timer: Callable[[], float] = time.perf_counter):
        self._handles: Dict[str, Tuple[Callable, Tuple]] = {}
        self._lock = threading.Lock()
        self._timer = timer
        self.exec_times: Dict[str, Deque[float]] = {}

    def load(self, placed: PlacedSubgraph, executables: Dict[str, Any]) -> str:
        key = placed.profile_key()
        with self._lock:
            if key not in self._handles:
                model = executables[placed.subgraph.graph.name]
                fn, example = model.build_subgraph_fn(
                    placed.subgraph.layer_ids, placed.dtype
                )
                self._handles[key] = (self._prepare(fn, example), example)
        return key

    def _prepare(self, fn: Callable, example: Tuple) -> Callable:
        raise NotImplementedError

    def execute(self, key: str, inputs: Optional[Sequence] = None):
        fn, example = self._handles[key]
        args = inputs if inputs is not None else example
        device = example[0].device
        t0 = self._timer()
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        samples = self.exec_times.get(key)
        if samples is None:
            samples = self.exec_times[key] = deque(maxlen=self.MAX_SAMPLES)
        samples.append(self._timer() - t0)
        return out


def _graphed(fn: Callable, example: Tuple) -> Callable:
    """``fn`` as a CUDA graph captured on a side stream after one warm-up.

    The graph owns static copies of the example inputs; a call copies its
    arguments into them, replays on the current stream and returns clones
    of the outputs, because the next replay overwrites the graph's own.
    """
    static = tuple(a.clone() for a in example)
    device = static[0].device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*static)       # warm-up: cuDNN picks its algorithms, the allocator its blocks
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outs = fn(*static)

    def run(*args):
        for dst, src in zip(static, args):
            dst.copy_(src)
        graph.replay()
        if isinstance(outs, tuple):
            return tuple(o.clone() for o in outs)
        return outs.clone()
    return run


class GraphEngine(Engine):
    """Compiled execution (the Qualcomm-SDK/ORT-default analogue): a CUDA
    graph on the card, eager on the CPU."""

    name = "default"

    def _prepare(self, fn, example):
        if example[0].device.type != "cuda":
            return fn
        return _graphed(fn, example)


class Bf16ConvGraphEngine(Engine):
    """Second compiled profile (XNNPACK analogue): same semantics, a
    different kernel selection — every convolution in bf16."""

    name = "xnnpack"

    def _prepare(self, fn, example):
        def wrapped(*a):
            with bf16_convs():
                return fn(*a)
        if example[0].device.type != "cuda":
            return wrapped
        return _graphed(wrapped, example)


class EagerEngine(Engine):
    """Op-by-op execution — the NNAPI-like slow path."""

    name = "nnapi"

    def _prepare(self, fn, example):
        return fn


ENGINE_REGISTRY: Dict[str, Callable[[], Engine]] = {
    "default": GraphEngine,
    "xnnpack": Bf16ConvGraphEngine,
    "nnapi": EagerEngine,
}


def make_engine(backend: str) -> Engine:
    return ENGINE_REGISTRY.get(backend, GraphEngine)()
