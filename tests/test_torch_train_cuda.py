"""Training on the card: K2's and K3's backward kernels against their plain
versions, the autograd wiring, the guard on K1 (no backward), train steps
(phi4's, mamba2's and olmoe's smoke configs, the last through B2's adjoint
kernels), and a closed runtime's CUDA graphs.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_train_cuda.py``.
Without a card every case skips.

Tolerances: the backward kernel and its plain version take the same o, lse
and dO and sum in f32 in other orders: 1e-4 of the largest gradient in f32;
in bf16 each gradient is rounded once to bf16 (2^-8 relative), and the
``sm90`` route also rounds P and dS to bf16 before the products that take
them: 1e-2 of the largest. bf16 takes the ``sm90`` backward (wgmma + TMA),
f32 the ``simt`` one (CUDA cores); ``_flash_attention_bwd_simt`` holds the
``simt`` kernel at bf16 too. Through the forward kernels (``FlashAttentionFn``) the bf16 route
also rounds P to bf16 before P·V: 3e-2. K3's backward (``ssd_scan_bwd``)
takes the forward's routes: bf16 of N and P multiples of 8 with P ≤ 128 the
``sm90`` backward (wgmma + TMA; it also rounds X·u, dY·exp(cum), the states,
W and the summed dG to bf16 before their products), f32 and the other bf16
shapes the ``simt`` one (CUDA cores, f32 sums); ``_ssd_scan_bwd_simt`` holds
the ``simt`` kernel at bf16 too. Against ``ssd_scan_bwd_plain`` on the same
inputs: 1e-4 of the largest gradient in f32 (other orders of the sums), 1e-2
in bf16 (dx, dB and dC rounded once).
"""
import gc
import weakref
from unittest import mock

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    NEG_INF,
    ROUTES,
    FlashAttentionFn,
    _flash_attention_bwd_simt,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.kernels.ssd_scan import (SsdScanFn, _route as ssd_route, _ssd_scan_bwd_simt,
                                          ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain)
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


@pytest.mark.parametrize("case", CASES, ids=str)
def test_simt_backward_kernel_at_bf16_matches_plain(case):
    """The CUDA-core backward, which bf16 calls do not take, stays held at bf16."""
    q, k, v, do = _inputs(case, torch.bfloat16)
    out, lse = flash_attention(q, k, v, return_lse=True, **_opts(case))
    before = dict(flash_attention_bwd.launches_by_route)
    got = _flash_attention_bwd_simt(q, k, v, out, lse, do, **_opts(case))
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches_by_route == {**before, "simt": before["simt"] + 1}
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **_opts(case))
    assert all(a.dtype == torch.bfloat16 for a in got)
    _close(got, want, 1e-2)


@pytest.mark.parametrize("case", [CASES[10], CASES[6], CASES[7]], ids=str)
def test_sm90_backward_gives_the_same_bits_twice(case):
    """At phi4's shape and where rows have no unmasked key: no atomics."""
    q, k, v, do = _inputs(case, torch.bfloat16, seed=1)
    out, lse = flash_attention(q, k, v, return_lse=True, **_opts(case))
    before = dict(flash_attention_bwd.launches_by_route)
    first = flash_attention_bwd(q, k, v, out, lse, do, **_opts(case))
    second = flash_attention_bwd(q, k, v, out, lse, do, **_opts(case))
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches_by_route == {**before, "sm90": before["sm90"] + 2}
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(bool(torch.isfinite(a).all()) for a in first)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_sm90_kernels_run_from_a_fresh_thread(direction):
    """A thread that has made no CUDA call yet (as autograd's worker thread
    can be) encodes its tensor maps and gives the main thread's bits."""
    import threading
    case = CASES[0]
    q, k, v, do = _inputs(case, torch.bfloat16)
    out, lse = flash_attention(q, k, v, return_lse=True, **_opts(case))
    if direction == "forward":
        call = lambda: (flash_attention(q, k, v, **_opts(case)),)          # noqa: E731
    else:
        call = lambda: flash_attention_bwd(q, k, v, out, lse, do, **_opts(case))  # noqa: E731
    want = call()
    got = []

    def run():
        try:
            got.append(call())
        except Exception as e:     # reported below, in the test's own thread
            got.append(e)
    worker = threading.Thread(target=run)
    worker.start()
    worker.join(timeout=120)
    torch.cuda.synchronize()
    assert got and not isinstance(got[0], Exception), got
    assert all(torch.equal(a, b) for a, b in zip(got[0], want))


def test_backward_routes_are_counted_by_dtype():
    """One ``sm90`` launch per bf16 call, one ``simt`` launch per f32 call."""
    case = CASES[0]
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "simt")):
        q, k, v, do = _inputs(case, dtype)
        out, lse = flash_attention(q, k, v, return_lse=True, **_opts(case))
        before = (flash_attention_bwd.launches, dict(flash_attention_bwd.launches_by_route))
        for _ in range(3):
            flash_attention_bwd(q, k, v, out, lse, do, **_opts(case))
        assert flash_attention_bwd.launches == before[0] + 3
        assert flash_attention_bwd.launches_by_route == {
            r: before[1][r] + 3 * (r == route) for r in ROUTES}


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
    """K1 has no backward (no training path quantizes): under grad it raises."""
    rows = torch.randn(4, 64, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="quantize_rows"):
        ops.quantize_rows(rows)
    with torch.no_grad():
        q, scale = ops.quantize_rows(rows)
    assert q.shape == rows.shape and scale.shape == (4,)


# K3's backward: (bh, s, p, n, chunk, heads_per_group, initial state and d final)
SSD_BWD_CASES = [
    (256, 1024, 64, 128, 128, 64, False),        # mamba2-1.3b at batch 4
    (1024, 1024, 64, 128, 128, 256, False),      # jamba-1.5-large at batch 4
    (8, 64, 64, 32, 1, 4, False),                # chunk 1
    (4, 200, 64, 128, 100, 2, True),             # chunk 100, a state in and out
    (4, 128, 64, 128, 128, 1, False),            # S == chunk, one head a group
    (8, 256, 96, 24, 128, 4, True),              # two P-tiles, N 24
    (8, 256, 100, 24, 128, 4, False),            # a ragged P-tile
    (8, 256, 64, 128, 128, 4, True),
    (4, 1024, 64, 128, 64, 2, True),             # 16 chunks (sm90: s_in kept in registers)
]


def _ssd_inputs(case, dtype, seed=0):
    """The model's A (-1 … -16 over a group's heads) and dt doubled, so that
    exp(cum_i - cum_j) overflows above the diagonal."""
    bh, s, p, n, chunk, g, with_state = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x, dy = rnd(bh, s, p).to(dtype), rnd(bh, s, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(bh, s)) * 2.0
    A = -torch.linspace(1.0, 16.0, g, device="cuda").repeat(bh // g)
    Bm, Cm = ((rnd(bh // g, s, n) * 0.3).to(dtype) for _ in range(2))
    init = rnd(bh, n, p) if with_state else None
    dfinal = rnd(bh, n, p) if with_state else None
    return (x, dt, A, Bm, Cm), dy, dfinal, dict(chunk=chunk, heads_per_group=g,
                                                initial_state=init)


@pytest.mark.parametrize("case,dtype", [(c, d) for c in SSD_BWD_CASES for d in sorted(DTYPES)
                                        if c[0] < 1024 or d == "bfloat16"], ids=str)
def test_ssd_backward_kernel_matches_plain(case, dtype):
    """One launch a call, on the route ``_route`` gives the dtype and shape
    (bf16 of a shape the sm90 kernel takes: ``sm90``; f32 and P 100:
    ``simt``); every gradient finite, within the tolerance of the plain
    backward's largest entry, and the same bits on a second call (jamba's
    shape in bf16 only, its dtype on the card)."""
    args, dy, dfinal, kw = _ssd_inputs(case, DTYPES[dtype])
    route = ssd_route(DTYPES[dtype], case[2], case[3], case[4])
    before = dict(ssd_scan_bwd.launches_by_route)
    got = ssd_scan_bwd(*args, dy, dfinal, **kw)
    assert {r: n - before[r] for r, n in ssd_scan_bwd.launches_by_route.items()} == {
        r: int(r == route) for r in before}
    again = ssd_scan_bwd(*args, dy, dfinal, **kw)
    want = ssd_scan_bwd_plain(*args, dy, dfinal, **kw)
    assert (got[5] is None) == (kw["initial_state"] is None)
    got, again, want = ([t for t in r if t is not None] for r in (got, again, want))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert [(t.dtype, t.shape) for t in got] == [(t.dtype, t.shape) for t in want]
    _close(got, want, 1e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("case", [SSD_BWD_CASES[0], SSD_BWD_CASES[7]], ids=str)
def test_ssd_backward_sm90_at_training_shapes(case):
    """The ``sm90`` backward at mamba2-1.3b's training shape and at one with a
    state in and out and 4 heads a group: one ``sm90`` launch a call and none
    on ``simt``, within 1e-2 of the largest gradient of the plain backward,
    the same bits twice."""
    args, dy, dfinal, kw = _ssd_inputs(case, torch.bfloat16, seed=3)
    before = dict(ssd_scan_bwd.launches_by_route)
    got = ssd_scan_bwd(*args, dy, dfinal, **kw)
    again = ssd_scan_bwd(*args, dy, dfinal, **kw)
    assert ssd_scan_bwd.launches_by_route == {"sm90": before["sm90"] + 2, "simt": before["simt"]}
    want = ssd_scan_bwd_plain(*args, dy, dfinal, **kw)
    got, again, want = ([t for t in r if t is not None] for r in (got, again, want))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close(got, want, 1e-2)


@pytest.mark.parametrize("case", [c for c in SSD_BWD_CASES if c[0] < 1024], ids=str)
def test_ssd_backward_simt_kernel_at_bf16_matches_plain(case):
    """``_ssd_scan_bwd_simt``, the CUDA-core backward that the sm90 kernel is
    timed against, at bf16: one ``simt`` launch, within 1e-2 of the largest
    gradient of the plain backward."""
    args, dy, dfinal, kw = _ssd_inputs(case, torch.bfloat16)
    before = dict(ssd_scan_bwd.launches_by_route)
    got = _ssd_scan_bwd_simt(*args, dy, dfinal, **kw)
    assert ssd_scan_bwd.launches_by_route == {"sm90": before["sm90"], "simt": before["simt"] + 1}
    want = ssd_scan_bwd_plain(*args, dy, dfinal, **kw)
    got, want = ([t for t in r if t is not None] for r in (got, want))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _close(got, want, 1e-2)


class _PlainSsd:
    """In place of ``SsdScanFn``: autograd through the plain forward."""

    @staticmethod
    def apply(x, dt, A, Bm, Cm, chunk, g, initial_state):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, heads_per_group=g,
                              initial_state=initial_state)


def test_ssd_bshp_under_grad_takes_the_backward_kernel():
    """``ops.ssd_bshp`` under grad goes through ``SsdScanFn``: K3's forward
    and its backward kernel once each, gradients (x, dt, A, B, C, the initial
    state) equal to autograd's through the plain forward within 1e-4 of the
    largest in f32."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, g, p, n = 2, 256, 8, 2, 64, 32

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = rnd(b, s, h, p)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    Bm, Cm = rnd(b, s, g, n) * 0.3, rnd(b, s, g, n) * 0.3
    init, dy = rnd(b, h, p, n), rnd(b, s, h, p)
    inputs = (x, dt, A, Bm, Cm, init)
    leaves = [t.clone().requires_grad_() for t in inputs]
    launches = (ssd_scan_bwd.launches, ops.ssd_scan.launches)
    y, state = ops.ssd_bshp(*leaves[:5], chunk=64, initial_state=leaves[5])
    ((y * dy).sum() + state.square().sum()).backward()
    assert (ssd_scan_bwd.launches - launches[0], ops.ssd_scan.launches - launches[1]) == (1, 1)
    ref = [t.clone().requires_grad_() for t in inputs]
    with mock.patch.object(ops, "SsdScanFn", _PlainSsd):
        y, state = ops.ssd_bshp(*ref[:5], chunk=64, initial_state=ref[5])
    ((y * dy).sum() + state.square().sum()).backward()
    _close([t.grad for t in leaves], [t.grad for t in ref], 1e-4)


def test_ssd_autograd_function_matches_autograd_through_plain():
    args, dy, dfinal, kw = _ssd_inputs((8, 256, 64, 128, 128, 4, True), torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (*args, kw["initial_state"])]
    y, state = SsdScanFn.apply(*leaves[:5], kw["chunk"], kw["heads_per_group"], leaves[5])
    ((y.float() * dy.float()).sum() + (state * dfinal).sum()).backward()
    ref = [t.clone().requires_grad_() for t in (*args, kw["initial_state"])]
    y, state = ssd_scan_plain(*ref[:5], chunk=kw["chunk"], heads_per_group=kw["heads_per_group"],
                              initial_state=ref[5])
    ((y.float() * dy.float()).sum() + (state * dfinal).sum()).backward()
    # the sm90 forward rounds W, C·state's state and the decayed X to bf16
    _close([t.grad for t in leaves], [t.grad for t in ref], 3e-2)


def _losses_on_cpu_and_card(arch, seq_len, counter):
    """Two AdamW steps of ``arch``'s smoke config from the same weights and
    batches on the CPU and on the card: the losses and ``counter``'s launches
    on each."""
    cfg = get_smoke_config(arch)
    data = MarkovDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, batch_size=4))
    batches = [next(b) for b in [data.batches()] for _ in range(2)]
    losses, launches = {}, {}
    for dev in ("cpu", "cuda"):
        model = init_params(cfg, seed=0, device="cpu").to(dev)
        model.requires_grad_(True)
        opt = make_optimizer("adamw", lr=3e-3)
        state = opt[0](param_leaves(model))
        before = counter.launches
        losses[dev] = []
        for tokens, labels in batches:
            state, loss = train_step(model, opt, state, torch.from_numpy(tokens).to(dev),
                                     torch.from_numpy(labels).long().to(dev), None)
            losses[dev].append(float(loss))
        launches[dev] = counter.launches - before
    assert all(torch.isfinite(torch.tensor(losses["cuda"])))
    torch.testing.assert_close(torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
                               rtol=1e-4, atol=0)
    return launches


def test_train_steps_on_the_card_match_the_cpu():
    """Two steps of phi4's smoke config (f32, hd 32) from the same weights and
    batches: on the card the attention backward is the kernel, once per
    layer and step, and the losses agree with the CPU's (plain versions) to
    1e-4 relative."""
    launches = _losses_on_cpu_and_card("phi4-mini-3.8b", 64, flash_attention_bwd)
    assert launches == {"cpu": 0, "cuda": 2 * get_smoke_config("phi4-mini-3.8b").num_layers}


def test_mamba2_train_steps_on_the_card_match_the_cpu():
    """The same for mamba2's smoke config (f32, 64 tokens: four chunks of
    16): on the card the SSD scan's backward is the kernel, once per layer
    and step."""
    launches = _losses_on_cpu_and_card("mamba2-1.3b", 64, ssd_scan_bwd)
    assert launches == {"cpu": 0, "cuda": 2 * get_smoke_config("mamba2-1.3b").num_layers}


def test_olmoe_train_steps_on_the_card_match_the_cpu():
    """The same for olmoe's smoke config (f32, 64 experts' dispatch at 4
    experts top-2): on the card the MoE layer's fill and combine train
    through their adjoint kernels, each once per layer and step."""
    from repro_torch.kernels import moe_dispatch as md
    fills = md.moe_fill_bwd.launches
    launches = _losses_on_cpu_and_card("olmoe-1b-7b", 64, md.moe_combine_bwd)
    n = 2 * get_smoke_config("olmoe-1b-7b").num_layers
    assert launches == {"cpu": 0, "cuda": n} and md.moe_fill_bwd.launches - fills == n


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
