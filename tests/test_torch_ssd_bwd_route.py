"""How a call of K3's backward picks its CUDA kernel, on the CPU.

The backward takes the forward's routes (``_route``): bf16 with N and P
multiples of 8 and P ≤ 128 goes to the ``sm90`` backward
(``csrc/ssd_scan_bwd_sm90.cu``: wgmma + TMA, the chunks in parallel), f32
and every other bf16 shape to the ``simt`` backward
(``csrc/ssd_scan_bwd.cu``: CUDA cores). A chunk or state size neither kernel
takes raises ``ValueError`` before any library is loaded, and so does a
launch of the ``sm90`` backward at a shape it cannot take. The kernels
themselves run only on the card (``test_torch_train_cuda.py``).
"""
import importlib

import pytest
import torch

from repro_torch.kernels.ssd_scan import ROUTES, _route

ss = importlib.import_module("repro_torch.kernels.ssd_scan")

# (p, n, chunk): the shapes the main path and the tests give K3's backward
SHAPES = [(64, 128, 128), (64, 128, 1), (64, 128, 100), (64, 32, 1), (96, 24, 128),
          (64, 16, 16), (8, 8, 64), (128, 128, 128)]


@pytest.fixture
def no_library(monkeypatch):
    """Any library load fails the test."""
    def refuse():
        raise AssertionError("a library was loaded before the inputs were checked")
    for name in ("_lib", "_lib_sm90", "_lib_bwd", "_lib_bwd_sm90"):
        monkeypatch.setattr(ss, name, refuse)


def _inputs(dtype=torch.bfloat16, bh=4, s=128, p=32, n=16, g=2):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(bh, s, p, generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(bh, s, generator=gen))
    A = -torch.exp(torch.randn(bh, generator=gen) * 0.3)
    Bm, Cm = (torch.randn(bh // g, s, n, generator=gen).to(dtype) * 0.3 for _ in range(2))
    dy = torch.randn(bh, s, p, generator=gen).to(dtype)
    return x, dt, A, Bm, Cm, dy


@pytest.mark.parametrize("p,n,chunk", SHAPES)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"), (torch.float32, "simt")])
def test_backward_route_by_dtype_and_shape(no_library, monkeypatch, dtype, route, p, n, chunk):
    """A CUDA call reaches ``_launch_bwd`` with the forward's route for its
    dtype and shape."""
    seen = []
    monkeypatch.setattr(ss, "_launch_bwd", lambda r, *a: seen.append(r))
    x, dt, A, Bm, Cm, dy = _inputs(dtype, s=chunk, p=p, n=n)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    ss._direct_bwd(x, dt, A, Bm, Cm, dy, None, chunk, 2, None)
    assert seen == [route] == [_route(dtype, p, n, chunk)]


@pytest.mark.parametrize("p,n", [(64, 12), (36, 128), (136, 64), (100, 24)])
def test_bf16_shapes_sm90_cannot_take_route_to_simt(p, n):
    """bf16 with N or P not a multiple of 8, or P past 128, takes the simt
    backward by its shape."""
    assert _route(torch.bfloat16, p, n, 128) == "simt"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p,n,chunk,match", [(64, 64, 0, "chunk"), (64, 64, 129, "chunk"),
                                             (64, 136, 128, "state size 136")])
def test_shapes_neither_backward_takes_raise_before_any_library(no_library, dtype, p, n, chunk,
                                                                 match):
    """A chunk or state size that neither kernel takes raises in the launch
    checks, before a library loads (the CPU tensors stand in for the card's:
    the checks read shapes only)."""
    x, dt, A, Bm, Cm, dy = _inputs(dtype, s=max(chunk, 1) * 2, p=p, n=n)
    for route in ROUTES:
        if route == "sm90" and dtype != torch.bfloat16:
            continue
        with pytest.raises(ValueError, match=match):
            ss._launch_bwd(route, x, dt, A, Bm, Cm, dy, None, chunk, 2, None)


@pytest.mark.parametrize("dtype,p,n", [(torch.bfloat16, 64, 12), (torch.bfloat16, 36, 128),
                                       (torch.bfloat16, 136, 64), (torch.float32, 64, 128)])
def test_sm90_backward_refuses_what_it_cannot_take(no_library, dtype, p, n):
    """A launch of the sm90 backward refuses f32 and bf16 shapes it cannot
    take, before a library loads."""
    x, dt, A, Bm, Cm, dy = _inputs(dtype, p=p, n=n)
    with pytest.raises(ValueError, match="sm90 kernel takes"):
        ss._launch_bwd("sm90", x, dt, A, Bm, Cm, dy, None, 128, 2, None)


def test_the_simt_backward_for_timing_needs_the_card(no_library):
    x, dt, A, Bm, Cm, dy = _inputs()
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ss._ssd_scan_bwd_simt(x, dt, A, Bm, Cm, dy, chunk=128, heads_per_group=2)


def test_backward_launches_by_route_has_both_keys():
    assert set(ss.ssd_scan_bwd.launches_by_route) == set(ROUTES) == {"sm90", "simt"}
    assert ss.ssd_scan_bwd.launches == sum(ss.ssd_scan_bwd.launches_by_route.values())


def test_cpu_backward_takes_the_plain_version_and_counts_no_launch(no_library):
    x, dt, A, Bm, Cm, dy = _inputs(s=64)
    before = dict(ss.ssd_scan_bwd.launches_by_route)
    got = ss.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=32, heads_per_group=2)
    want = ss.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=32, heads_per_group=2)
    assert ss.ssd_scan_bwd.launches_by_route == before
    assert all(torch.equal(a, b) for a, b in zip(got[:5], want[:5]))
