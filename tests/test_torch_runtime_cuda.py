"""The runtime's CUDA-graph capture on the card.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_runtime_cuda.py``.
Without a card every case skips.
"""
import gc

import pytest
import torch

from repro_torch.runtime.engine import _graphed

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")]


def test_graph_capture_runs_with_collection_paused():
    """The collector is off while a graph is captured (a collection there
    may destroy an earlier graph, which invalidates the capture), on again
    after, and the graph replays what it captured."""
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return torch.relu(x) * 2.0

    x = torch.randn(64, 64, device="cuda")
    run = _graphed(fn, (x,))
    assert seen == [True, False] and gc.isenabled()
    y = torch.randn(64, 64, device="cuda")
    assert torch.equal(run(y), torch.relu(y) * 2.0)


def test_a_collection_during_capture_destroys_no_graph():
    """An earlier graph left in a garbage cycle while another is captured,
    with the collector due at every allocation: the capture still holds."""
    earlier = [_graphed(lambda x: x * 2.0, (torch.ones(8, device="cuda"),))]
    calls = []

    def fn(x):
        calls.append(gc.isenabled())
        if len(calls) == 2:               # the capture (the first call warms up)
            cycle = [earlier.pop()]
            cycle.append(cycle)
            del cycle
            for _ in range(100):
                [[]]                      # container allocations: a collection is due
        return torch.relu(x) * 2.0

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        run = _graphed(fn, (torch.randn(64, 64, device="cuda"),))
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    y = torch.randn(64, 64, device="cuda")
    assert torch.equal(run(y), torch.relu(y) * 2.0)
