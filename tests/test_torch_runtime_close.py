"""``PuzzleRuntime.close()`` on the CPU: every engine drops what it loaded,
and a closed runtime is freed by reference counting alone, with Python's
collector off (the runtime's part of keeping CUDA graphs away from the
collector; ``tests/test_torch_train_cuda.py`` holds it on the card)."""
import gc
import weakref

import pytest

from repro_torch.core import Solution, mobile_processors
from repro_torch.runtime import PuzzleRuntime, RuntimeConfig
from repro_torch.zoo import executable_zoo


@pytest.mark.parametrize("backend", [[0, 1], [0, 2]])
def test_closed_runtime_is_freed_without_the_collector(backend):
    zoo = executable_zoo(["face_det", "selfie_seg"], channels=4, spatial=8, device="cpu")
    graphs = [zoo[n].graph for n in ("face_det", "selfie_seg")]
    h = graphs[0].num_layers // 2
    sol = Solution(partition=[[int(e.src <= h < e.dst) for e in graphs[0].edges],
                              [0] * graphs[1].num_edges],
                   mapping=[[2] * graphs[0].num_layers, [0] * graphs[1].num_layers],
                   priority=[0, 1], dtype=[2, 0], backend=backend)
    rt = PuzzleRuntime(graphs, sol, mobile_processors(), zoo, RuntimeConfig(), device="cpu")
    rt.run_periodic([[0, 1]], [0.05], num_requests=2)
    engines = [e for w in rt.workers.values() for e in w.engines.values()]
    assert any(e._handles for e in engines)
    gc.collect()
    gc.disable()
    try:
        rt.close()
        assert all(not e._handles for e in engines)
        assert rt.measured_costs()            # the samples outlive close()
        refs = [weakref.ref(rt)] + [weakref.ref(e) for e in engines]
        del rt, engines
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
