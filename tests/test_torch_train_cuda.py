"""Training on the card: K2's backward kernel against its plain version, the
autograd wiring, the guards on the kernels without a backward, a train step,
and a closed runtime's CUDA graphs.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_train_cuda.py``.
Without a card every case skips.

Tolerances: the backward kernel and its plain version take the same o, lse
and dO and sum in f32 in other orders: 1e-4 of the largest gradient in f32;
in bf16 each gradient is rounded once to bf16 (2^-8 relative), 1e-2 of the
largest. Through the forward kernels (``FlashAttentionFn``) the bf16 route
also rounds P to bf16 before P·V: 3e-2.
"""
import gc
import weakref

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    NEG_INF,
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.models import init_params, param_leaves
from repro_torch.train import DataConfig, MarkovDataset, make_optimizer, train_step

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")]

# (bh, sq, sk, hd, g, causal, window, q_offset)
CASES = [
    (6, 128, 128, 64, 3, True, None, 0),
    (8, 100, 100, 128, 4, True, None, 0),        # ragged tiles
    (2, 64, 200, 64, 1, False, None, 0),         # Sq != Sk, cross
    (4, 130, 300, 128, 4, False, 100, 170),      # window, no causal, ragged
    (6, 256, 256, 64, 3, True, 32, 0),           # sliding window
    (2, 32, 128, 64, 1, True, None, 96),         # q_offset continuation
    (2, 16, 40, 64, 1, True, None, -8),          # fully masked rows
    (3, 8, 40, 128, 3, True, 4, 100),            # every row masked
    (16, 256, 256, 112, 8, True, None, 0),       # hd 112
    (4, 64, 64, 32, 2, True, None, 0),           # hd 32
    (96, 1024, 1024, 128, 3, True, None, 0),     # phi4-mini-3.8b at batch 4
    (32, 512, 512, 64, 4, True, None, 0),        # the 100M demo (f32 in its model)
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, dtype, seed=0):
    bh, sq, sk, hd, g, *_ = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return rnd(bh, sq, hd), rnd(bh // g, sk, hd), rnd(bh // g, sk, hd), rnd(bh, sq, hd)


def _opts(case):
    _, _, _, _, g, causal, window, q_offset = case
    return dict(q_heads_per_kv=g, causal=causal, window=window, q_offset=q_offset)


def _close(got, want, rel):
    for a, b in zip(got, want):
        scale = max(float(b.float().abs().max()), 1e-6)
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=rel * scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_kernel_matches_plain(case, dtype):
    q, k, v, do = _inputs(case, DTYPES[dtype])
    out, lse = flash_attention(q, k, v, return_lse=True, **_opts(case))
    launches = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, **_opts(case))
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == launches + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **_opts(case))
    assert all(a.dtype == q.dtype for a in got)
    _close(got, want, 1e-2 if dtype == "bfloat16" else 1e-4)
    # the same bits on a second run: no atomics
    again = flash_attention_bwd(q, k, v, out, lse, do, **_opts(case))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES[:10], ids=str)
def test_forward_lse_matches_plain(case, dtype):
    q, k, v, _ = _inputs(case, DTYPES[dtype])
    out, lse = flash_attention(q, k, v, return_lse=True, **_opts(case))
    _, want = flash_attention_plain(q, k, v, return_lse=True, **_opts(case))
    dead = want == NEG_INF
    assert torch.equal(lse == NEG_INF, dead)
    torch.testing.assert_close(lse[~dead], want[~dead], rtol=0,
                               atol=2e-3 if dtype == "bfloat16" else 1e-4)
    # the serving call (no lse) gives the same output bits
    assert torch.equal(out, flash_attention(q, k, v, **_opts(case)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES[:10], ids=str)
def test_autograd_function_matches_autograd_through_plain(case, dtype):
    q, k, v, do = _inputs(case, DTYPES[dtype])
    o = _opts(case)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FlashAttentionFn.apply(*leaves, o["q_heads_per_kv"], o["causal"], o["window"],
                           o["q_offset"]).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref, **o), ref, do)
    _close([t.grad for t in leaves], want, 3e-2 if dtype == "bfloat16" else 1e-4)


def test_kernels_without_a_backward_raise_under_grad():
    x = torch.randn(1, 128, 2, 8, device="cuda", requires_grad=True)
    dt = torch.rand(1, 128, 2, device="cuda")
    A = -torch.rand(2, device="cuda")
    Bm = torch.randn(1, 128, 1, 16, device="cuda")
    with pytest.raises(NotImplementedError, match="K3 backward"):
        ops.ssd_bshp(x, dt, A, Bm, Bm)
    with torch.no_grad():
        y, _ = ops.ssd_bshp(x, dt, A, Bm, Bm)
    assert y.shape == x.shape
    rows = torch.randn(4, 64, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="quantize_rows"):
        ops.quantize_rows(rows)


def test_train_steps_on_the_card_match_the_cpu():
    """Two steps of phi4's smoke config (f32, hd 32) from the same weights and
    batches: on the card the attention backward is the kernel, once per
    layer and step, and the losses agree with the CPU's (plain versions) to
    1e-4 relative."""
    cfg = get_smoke_config("phi4-mini-3.8b")
    data = MarkovDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4))
    batches = [next(b) for b in [data.batches()] for _ in range(2)]
    losses = {}
    launches = {}
    for dev in ("cpu", "cuda"):
        model = init_params(cfg, seed=0, device="cpu").to(dev)
        model.requires_grad_(True)
        opt = make_optimizer("adamw", lr=3e-3)
        state = opt[0](param_leaves(model))
        before = flash_attention_bwd.launches
        losses[dev] = []
        for tokens, labels in batches:
            state, loss = train_step(model, opt, state, torch.from_numpy(tokens).to(dev),
                                     torch.from_numpy(labels).long().to(dev), None)
            losses[dev].append(float(loss))
        launches[dev] = flash_attention_bwd.launches - before
    assert launches == {"cpu": 0, "cuda": 2 * cfg.num_layers}
    assert all(torch.isfinite(torch.tensor(losses["cuda"])))
    torch.testing.assert_close(torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
                               rtol=1e-4, atol=0)


def test_closed_runtime_frees_its_graphs_and_a_capture_holds_with_the_collector_on():
    """``close()`` resets every engine's CUDA graph, and the closed runtime is
    freed by reference counting alone; the next capture then runs with
    Python's collector on and due at every allocation."""
    from repro_torch.core import Solution, mobile_processors
    from repro_torch.runtime import PuzzleRuntime, RuntimeConfig
    from repro_torch.zoo import executable_zoo

    zoo = executable_zoo(["face_det", "selfie_seg"], channels=4, spatial=8)
    graphs = [zoo[n].graph for n in ("face_det", "selfie_seg")]
    h = graphs[0].num_layers // 2
    sol = Solution(partition=[[int(e.src <= h < e.dst) for e in graphs[0].edges],
                              [0] * graphs[1].num_edges],
                   mapping=[[2] * graphs[0].num_layers, [0] * graphs[1].num_layers],
                   priority=[0, 1], dtype=[2, 0], backend=[0, 1])

    def serve():
        rt = PuzzleRuntime(graphs, sol, mobile_processors(), zoo, RuntimeConfig())
        rt.run_periodic([[0, 1]], [0.05], num_requests=2)
        return rt

    rt = serve()
    engines = [e for w in rt.workers.values() for e in w.engines.values()]
    assert sum(hasattr(fn, "graph") for e in engines for fn, _ in e._handles.values()) >= 2
    gc.collect()
    gc.disable()
    try:
        rt.close()
        assert all(not e._handles for e in engines)
        ref = weakref.ref(rt)
        del rt, engines
        assert ref() is None              # no collection ran
    finally:
        gc.enable()

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        static = torch.randn(64, 64, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.relu(static) * 2.0
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(100):
                [[]]                      # container allocations: a collection is due
            out = torch.relu(static) * 2.0
        x = torch.randn(64, 64, device="cuda")
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, torch.relu(x) * 2.0)
    finally:
        gc.set_threshold(*threshold)
    rt2 = serve()
    rt2.close()
