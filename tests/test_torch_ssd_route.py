"""How an SSD chunk-scan call picks its CUDA kernel, on the CPU.

bf16 goes to the ``sm90`` kernel (wgmma + TMA) when N and P are multiples
of 8 and P ≤ 128, every other bf16 shape and f32 to the ``simt`` kernel
(CUDA cores); a chunk or state size neither kernel takes raises
``ValueError`` before any library is loaded, and so does a launch of the
``sm90`` kernel at a shape it cannot take. The kernels themselves run only on the card
(``test_torch_kernels_cuda.py``).
"""
import importlib
import sys
import threading

import pytest
import torch

from repro_torch.kernels.ssd_scan import ROUTES, _route

# the module, not the function that the package exports under its name
ss = importlib.import_module("repro_torch.kernels.ssd_scan")

# (p, n, chunk): the shapes the main path and the tests give K3
SHAPES = [(64, 128, 128), (64, 128, 16), (64, 128, 1), (64, 128, 64), (64, 128, 100),
          (32, 16, 16), (40, 24, 100), (96, 16, 48), (96, 24, 64), (64, 32, 32)]


@pytest.fixture
def no_library(monkeypatch):
    """Any library load fails the test."""
    def refuse():
        raise AssertionError("a library was loaded before the inputs were checked")
    monkeypatch.setattr(ss, "_lib", refuse)
    monkeypatch.setattr(ss, "_lib_sm90", refuse)


def _inputs(dtype=torch.bfloat16, bh=4, s=32, p=32, n=16, g=2, with_state=False):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(bh, s, p, generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(bh, s, generator=gen))
    A = -torch.exp(torch.randn(bh, generator=gen) * 0.3)
    Bm, Cm = (torch.randn(bh // g, s, n, generator=gen).to(dtype) * 0.3 for _ in range(2))
    init = torch.randn(bh, n, p, generator=gen) if with_state else None
    return x, dt, A, Bm, Cm, init


@pytest.mark.parametrize("p,n,chunk", SHAPES)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"), (torch.float32, "simt")])
def test_route_by_dtype(dtype, route, p, n, chunk):
    assert _route(dtype, p, n, chunk) == route


@pytest.mark.parametrize("p,n,match", [(64, 12, "sm90 kernel takes"),
                                       (36, 128, "sm90 kernel takes"),
                                       (64, 136, "state size 136"),
                                       (136, 64, "sm90 kernel takes")])
def test_sm90_route_refuses_shapes_it_cannot_take(no_library, p, n, match):
    """A launch of the sm90 kernel refuses bf16 shapes it cannot take; a
    state size past 128, which neither kernel takes, the router refuses."""
    if match == "sm90 kernel takes":
        x, dt, A, Bm, Cm, _ = _inputs(p=p, n=n, s=128)
        with pytest.raises(ValueError, match=match):
            ss._launch("sm90", x, dt, A, Bm, Cm, 128, 2, None)
    else:
        with pytest.raises(ValueError, match=match):
            _route(torch.bfloat16, p, n, 128)


@pytest.mark.parametrize("p,n", [(64, 12), (36, 128), (136, 64)])
def test_bf16_shapes_sm90_cannot_take_route_to_simt(p, n):
    """bf16 with N or P not a multiple of 8, or P past 128, goes to the simt
    kernel by its shape."""
    assert _route(torch.bfloat16, p, n, 128) == "simt"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chunk", [0, 129])
def test_route_refuses_chunks_out_of_range(dtype, chunk):
    with pytest.raises(ValueError, match="chunk"):
        _route(dtype, 64, 64, chunk)


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        _route(torch.float16, 64, 64, 64)


@pytest.mark.parametrize("p,n,match", [(32, 12, "multiples of 8"), (36, 16, "multiples of 8"),
                                       (32, 136, "state size 136")])
def test_bf16_launch_refuses_before_loading(no_library, p, n, match):
    x, dt, A, Bm, Cm, init = _inputs(p=p, n=n)
    with pytest.raises(ValueError, match=match):
        ss._launch("sm90", x, dt, A, Bm, Cm, 16, 2, init)


@pytest.mark.parametrize("which", ["x", "B", "C", "initial_state"])
@pytest.mark.parametrize("route", ROUTES)
def test_launch_refuses_non_contiguous_before_loading(no_library, route, which):
    dtype = torch.bfloat16 if route == "sm90" else torch.float32
    t = dict(zip(["x", "dt", "A", "B", "C", "initial_state"],
                 _inputs(dtype, p=32, n=32, with_state=True)))
    t[which] = t[which].transpose(1, 2).contiguous().transpose(1, 2)
    assert not t[which].is_contiguous()
    with pytest.raises(ValueError, match=f"{which} must be contiguous"):
        ss._launch(route, t["x"], t["dt"], t["A"], t["B"], t["C"], 16, 2, t["initial_state"])


@pytest.mark.parametrize("which", ["x", "B", "C"])
def test_sm90_launch_refuses_misaligned_before_loading(no_library, which):
    t = dict(zip(["x", "dt", "A", "B", "C", "init"], _inputs()))
    flat = torch.empty(t[which].numel() + 1, dtype=torch.bfloat16)
    t[which] = flat[1:].view(t[which].shape)      # one element past an aligned base
    assert t[which].is_contiguous() and t[which].data_ptr() % 16
    with pytest.raises(ValueError, match=f"{which} must be 16-byte aligned"):
        ss._launch("sm90", t["x"], t["dt"], t["A"], t["B"], t["C"], 16, 2, None)


def test_sm90_route_refuses_f32_before_loading(no_library):
    x, dt, A, Bm, Cm, init = _inputs(torch.float32)
    with pytest.raises(ValueError, match="takes bf16"):
        ss._launch("sm90", x, dt, A, Bm, Cm, 16, 2, init)


def test_simt_route_refuses_chunk_past_128_before_loading(no_library):
    x, dt, A, Bm, Cm, init = _inputs(torch.float32, s=256)
    with pytest.raises(ValueError, match="at most"):
        ss._launch("simt", x, dt, A, Bm, Cm, 256, 2, init)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_call_takes_the_plain_version(no_library, dtype, with_state):
    x, dt, A, Bm, Cm, init = _inputs(dtype, with_state=with_state)
    kw = dict(chunk=16, heads_per_group=2, initial_state=init)
    before = (ss.ssd_scan.launches, dict(ss.ssd_scan.launches_by_route))
    y, st = ss.ssd_scan(x, dt, A, Bm, Cm, **kw)
    want_y, want_st = ss.ssd_scan_plain(x, dt, A, Bm, Cm, **kw)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert (ss.ssd_scan.launches, ss.ssd_scan.launches_by_route) == before


def test_simt_entry_needs_a_cuda_tensor(no_library):
    x, dt, A, Bm, Cm, init = _inputs()
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss._ssd_scan_simt(x, dt, A, Bm, Cm, chunk=16, heads_per_group=2)


def test_launch_count_by_route_is_exact_across_threads():
    """The total equals the sum over routes, and no launch is lost."""
    threads, each = 8, 2000
    before_total = ss.ssd_scan.launches
    before = dict(ss.ssd_scan.launches_by_route)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=lambda r=ROUTES[i % 2]: [ss._count_launch(r)
                                                                 for _ in range(each)])
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    per_route = threads // 2 * each
    assert ss.ssd_scan.launches == before_total + threads * each
    assert ss.ssd_scan.launches_by_route == {r: before[r] + per_route for r in ROUTES}
    ss.ssd_scan.launches = before_total
    ss.ssd_scan.launches_by_route = before
