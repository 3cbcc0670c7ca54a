"""How a flash-attention call picks its CUDA kernel, on the CPU.

bf16 goes to the ``sm90`` kernel (wgmma + TMA), f32 to the ``simt`` kernel
(CUDA cores), in the forward and in the backward; a call the chosen kernel
cannot take raises ``ValueError`` before any library is loaded. The kernels
themselves run only on the card (``test_torch_kernels_cuda.py``,
``test_torch_train_cuda.py``).
"""
import importlib
import sys
import threading
from unittest import mock

import pytest
import torch

from repro_torch.kernels.flash_attention import HEAD_DIMS, ROUTES, _route

# the module, not the function that the package exports under its name
fa = importlib.import_module("repro_torch.kernels.flash_attention")


@pytest.fixture
def no_library(monkeypatch):
    """Any library load fails the test."""
    def refuse():
        raise AssertionError("a library was loaded before the inputs were checked")
    monkeypatch.setattr(fa, "_lib", refuse)
    monkeypatch.setattr(fa, "_lib_sm90", refuse)
    monkeypatch.setattr(fa, "_lib_bwd", refuse)
    monkeypatch.setattr(fa, "_lib_bwd_sm90", refuse)


def _qkv(dtype=torch.bfloat16, bh=2, sq=16, sk=16, hd=64, g=1):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=gen).to(dtype)
            for s in ((bh, sq, hd), (bh // g, sk, hd), (bh // g, sk, hd))]


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"), (torch.float32, "simt")])
def test_route_by_dtype(dtype, route, hd):
    assert _route(dtype, hd) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [16, 96, 256])
def test_route_refuses_other_head_dims(dtype, hd):
    with pytest.raises(ValueError, match="head_dim"):
        _route(dtype, hd)


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        _route(torch.float16, 64)


@pytest.mark.parametrize("route", ROUTES)
def test_launch_refuses_head_dim_96_before_loading(no_library, route):
    q, k, v = _qkv(hd=96)
    with pytest.raises(ValueError, match="head_dim 96"):
        fa._launch(route, q, k, v, 1, True, None, 0)


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("route", ROUTES)
def test_launch_refuses_non_contiguous_before_loading(no_library, route, which):
    dtype = torch.bfloat16 if route == "sm90" else torch.float32
    t = dict(zip("qkv", _qkv(dtype)))
    t[which] = t[which].transpose(1, 2).contiguous().transpose(1, 2)
    assert not t[which].is_contiguous()
    with pytest.raises(ValueError, match=f"{which} must be contiguous"):
        fa._launch(route, t["q"], t["k"], t["v"], 1, True, None, 0)


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("route", ROUTES)
def test_launch_refuses_misaligned_before_loading(no_library, route, which):
    dtype = torch.bfloat16 if route == "sm90" else torch.float32
    t = dict(zip("qkv", _qkv(dtype)))
    flat = torch.empty(t[which].numel() + 1, dtype=dtype)
    t[which] = flat[1:].view(t[which].shape)      # one element past an aligned base
    assert t[which].is_contiguous() and t[which].data_ptr() % 16
    with pytest.raises(ValueError, match=f"{which} must be 16-byte aligned"):
        fa._launch(route, t["q"], t["k"], t["v"], 1, True, None, 0)


def test_sm90_route_refuses_f32_before_loading(no_library):
    q, k, v = _qkv(torch.float32)
    with pytest.raises(ValueError, match="takes bf16"):
        fa._launch("sm90", q, k, v, 1, True, None, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_call_takes_the_plain_version(no_library, dtype):
    q, k, v = _qkv(dtype, bh=4, g=2)
    before = (fa.flash_attention.launches, dict(fa.flash_attention.launches_by_route))
    got = fa.flash_attention(q, k, v, q_heads_per_kv=2)
    want = fa.flash_attention_plain(q, k, v, q_heads_per_kv=2)
    assert torch.equal(got, want)
    assert (fa.flash_attention.launches, fa.flash_attention.launches_by_route) == before


def test_simt_entry_needs_a_cuda_tensor(no_library):
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa._flash_attention_simt(*_qkv())


def test_launch_count_by_route_is_exact_across_threads():
    """The total equals the sum over routes, and no launch is lost."""
    threads, each = 8, 2000
    before_total = fa.flash_attention.launches
    before = dict(fa.flash_attention.launches_by_route)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=lambda r=ROUTES[i % 2]: [fa._count_launch(r)
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
    assert fa.flash_attention.launches == before_total + threads * each
    assert fa.flash_attention.launches_by_route == {r: before[r] + per_route for r in ROUTES}
    fa.flash_attention.launches = before_total
    fa.flash_attention.launches_by_route = before


# ---- the backward ----------------------------------------------------------

def _bwd_args(dtype=torch.bfloat16, bh=2, sq=16, sk=16, hd=64, g=1):
    """q, k, v, o, lse, do for the backward."""
    q, k, v = _qkv(dtype, bh, sq, sk, hd, g)
    gen = torch.Generator().manual_seed(1)
    o, do = (torch.randn((bh, sq, hd), generator=gen).to(dtype) for _ in range(2))
    return dict(q=q, k=k, v=v, o=o, lse=torch.randn((bh, sq), generator=gen), do=do)


def _launch_bwd(route, t, g=1):
    return fa._launch_bwd(route, t["q"], t["k"], t["v"], t["o"], t["lse"], t["do"], g, True,
                          None, 0)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"), (torch.float32, "simt")])
def test_backward_launches_the_route_of_its_dtype(monkeypatch, dtype, route, hd):
    """The wrapper hands a CUDA call to ``_launch_bwd`` with ``_route``'s choice."""
    taken = []
    monkeypatch.setattr(fa, "_launch_bwd", lambda r, *a: taken.append(r) or ("dq", "dk", "dv"))
    t = _bwd_args(dtype, hd=hd)
    with mock.patch.object(torch.Tensor, "device", new_callable=mock.PropertyMock,
                           return_value=torch.device("cuda", 0)):
        got = fa.flash_attention_bwd(t["q"], t["k"], t["v"], t["o"], t["lse"], t["do"])
    assert taken == [route] and got == ("dq", "dk", "dv")


@pytest.mark.parametrize("route", ROUTES)
def test_backward_refuses_head_dim_96_before_loading(no_library, route):
    dtype = torch.bfloat16 if route == "sm90" else torch.float32
    with pytest.raises(ValueError, match="head_dim 96"):
        _launch_bwd(route, _bwd_args(dtype, hd=96))


@pytest.mark.parametrize("which", ["q", "k", "v", "o", "lse", "do"])
@pytest.mark.parametrize("route", ROUTES)
def test_backward_refuses_non_contiguous_before_loading(no_library, route, which):
    dtype = torch.bfloat16 if route == "sm90" else torch.float32
    t = _bwd_args(dtype)
    t[which] = t[which].transpose(0, 1).contiguous().transpose(0, 1)
    assert not t[which].is_contiguous()
    with pytest.raises(ValueError, match=f"{which} must be contiguous"):
        _launch_bwd(route, t)


@pytest.mark.parametrize("which", ["q", "k", "v", "o", "lse", "do"])
@pytest.mark.parametrize("route", ROUTES)
def test_backward_refuses_misaligned_before_loading(no_library, route, which):
    dtype = torch.bfloat16 if route == "sm90" else torch.float32
    t = _bwd_args(dtype)
    flat = torch.empty(t[which].numel() + 1, dtype=t[which].dtype)
    t[which] = flat[1:].view(t[which].shape)      # one element past an aligned base
    assert t[which].is_contiguous() and t[which].data_ptr() % 16
    with pytest.raises(ValueError, match=f"{which} must be 16-byte aligned"):
        _launch_bwd(route, t)


def test_sm90_backward_refuses_f32_before_loading(no_library):
    with pytest.raises(ValueError, match="sm90 backward takes bf16"):
        _launch_bwd("sm90", _bwd_args(torch.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_backward_takes_the_plain_version(no_library, dtype):
    t = _bwd_args(dtype, bh=4, g=2)
    before = (fa.flash_attention_bwd.launches, dict(fa.flash_attention_bwd.launches_by_route))
    got = fa.flash_attention_bwd(*t.values(), q_heads_per_kv=2)
    want = fa.flash_attention_bwd_plain(*t.values(), q_heads_per_kv=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fa.flash_attention_bwd.launches,
            fa.flash_attention_bwd.launches_by_route) == before


def test_simt_backward_entry_needs_a_cuda_tensor(no_library):
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa._flash_attention_bwd_simt(*_bwd_args().values())


def test_backward_launch_count_by_route_is_exact_across_threads():
    """The total equals the sum over routes, and no launch is lost."""
    threads, each = 8, 2000
    before_total = fa.flash_attention_bwd.launches
    before = dict(fa.flash_attention_bwd.launches_by_route)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=lambda r=ROUTES[i % 2]: [fa._count_bwd_launch(r)
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
    assert fa.flash_attention_bwd.launches == before_total + threads * each
    assert fa.flash_attention_bwd.launches_by_route == {r: before[r] + per_route for r in ROUTES}
    fa.flash_attention_bwd.launches = before_total
    fa.flash_attention_bwd.launches_by_route = before
