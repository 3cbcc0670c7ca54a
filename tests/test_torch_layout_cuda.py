"""K2 and K3, forward and backward, in the model's (B, S, H, ·) layout on the card.

The ``sm90`` kernels read q, k, v, dO and x, B, C, dy where the model made
them: slices of one fused projection, transposed views, views of Mamba2's
convolution output (a token stride of x|B|C's whole width). At phi4's,
qwen3's, kimi-k2's (hd 112), whisper's (cross attention over 1500 frames)
and mamba2's shapes, and at jamba's 256 heads a group: each call on the
views equals the same kernel on ``.contiguous()`` copies of them bit for bit
(the tiles, their order and every sum are the same; only addresses
differ), stays within the tolerances of ``test_torch_kernels_cuda.py`` and
``test_torch_train_cuda.py`` against the plain versions (forward 2e-2 for
K2, 3e-2 for K3; backward 1e-2 of the largest gradient), counts one
``sm90`` launch, and dispatches no copy op (the wrappers hand the kernels
the views themselves).

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_layout_cuda.py``.
Without a card every case skips.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain

pytestmark = pytest.mark.cuda

# name: (B, Sq, Sk, H, Kv, hd, causal, window, q_offset)
ATTN = {
    "phi4-mini-3.8b": (4, 1024, 1024, 24, 8, 128, True, None, 0),
    "qwen3-14b": (4, 1024, 1024, 40, 8, 128, True, None, 0),
    "kimi-k2 hd 112": (4, 1024, 1024, 64, 8, 112, True, None, 0),
    "whisper cross": (4, 1024, 1500, 16, 16, 64, False, None, 0),
    "ragged window": (2, 130, 300, 8, 2, 128, False, 100, 170),
}
# fused: slices of one q|k|v (self attention) or k|v (cross) projection;
# transposed: (B, H, S, hd) tensors viewed as (B, S, H, hd)
ATTN_CASES = [(name, kind) for name in ATTN for kind in ("fused", "transposed")]
# name: (B, S, H, G, P, N, chunk, initial state)
SSD = {
    "mamba2-1.3b": (4, 1024, 64, 1, 64, 128, 128, False),
    "jamba-1.5-large-398b": (4, 1024, 256, 1, 64, 128, 128, False),
    "two groups, a state": (2, 256, 8, 2, 64, 64, 64, True),
}
SSD_CASES = [(name, kind) for name in SSD for kind in ("conv", "transposed")]
COPIES = {"copy_", "clone", "_to_copy", "contiguous"}


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


class _OpNames(TorchDispatchMode):
    """Records the name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


def _close(got, want, rel):
    for a, b in zip(got, want):
        scale = max(float(b.float().abs().max()), 1e-6)
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=rel * scale)


def _no_copy(fn, kernel):
    """``fn()`` with one ``sm90`` launch of ``kernel``, no layout copy counted
    and no copy op dispatched."""
    launches = dict(kernel.launches_by_route)
    copies = dict(kernel.layout_copies)
    with _OpNames() as rec:
        out = fn()
    torch.cuda.synchronize()
    assert kernel.launches_by_route == {**launches, "sm90": launches["sm90"] + 1}
    assert kernel.layout_copies == copies
    assert not COPIES & set(rec.names), rec.names
    return out


# ---- K2 -------------------------------------------------------------------------

def _attn_views(name, kind, seed=0):
    b, sq, sk, h, kv, hd, *_ = ATTN[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    if kind == "transposed":
        q, k, v, do = (rnd(b, h_, s, hd).transpose(1, 2)
                       for h_, s in ((h, sq), (kv, sk), (kv, sk), (h, sq)))
        return q, k, v, do
    if sq == sk:
        buf = rnd(b, sq, (h + 2 * kv) * hd)
        q, k, v = torch.split(buf, [h * hd, kv * hd, kv * hd], -1)
    else:
        q = rnd(b, sq, h * hd)
        k, v = torch.split(rnd(b, sk, 2 * kv * hd), [kv * hd, kv * hd], -1)
    do = rnd(b, sq, h * hd)
    return tuple(t.unflatten(-1, (t.shape[-1] // hd, hd)) for t in (q, k, v, do))


def _attn_opts(name):
    b, sq, sk, h, kv, hd, causal, window, q_offset = ATTN[name]
    return dict(q_heads_per_kv=h // kv, causal=causal, window=window, q_offset=q_offset)


@pytest.mark.parametrize("name,kind", ATTN_CASES, ids=str)
def test_attention_forward_on_views(name, kind):
    q, k, v, _ = _attn_views(name, kind)
    assert not (k.is_contiguous() or v.is_contiguous())
    kw = _attn_opts(name)
    out, lse = _no_copy(lambda: flash_attention(q, k, v, return_lse=True, **kw),
                        flash_attention)
    assert out.shape == q.shape and out.is_contiguous()
    again, lse2 = flash_attention(*(t.contiguous() for t in (q, k, v)), return_lse=True, **kw)
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name,kind", ATTN_CASES, ids=str)
def test_attention_backward_on_views(name, kind):
    q, k, v, do = _attn_views(name, kind, seed=1)
    kw = _attn_opts(name)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    got = _no_copy(lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw), flash_attention_bwd)
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    assert all(t.is_contiguous() for t in got)
    again = flash_attention_bwd(*(t.contiguous() for t in (q, k, v)), out, lse, do.contiguous(),
                                **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    _close(got, want, 1e-2)


# ---- K3 -------------------------------------------------------------------------

def _ssd_views(name, kind, seed=0):
    """x, dt, A, B, C, dy, the initial state and its gradient: x, B, C as views
    of one convolution output (B, S, H·P + 2·G·N) or as transposed views;
    dy as y's own layout ((B, H, S, P) memory) or contiguous; the model's A
    (-1 … -16 over a group's heads) and dt doubled."""
    b, s, h, g, p, n, chunk, with_state = SSD[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    if kind == "conv":
        buf = rnd(b, s, h * p + 2 * g * n)
        buf[..., h * p:] *= 0.3
        xs, bs, cs = torch.split(buf.to(torch.bfloat16), [h * p, g * n, g * n], -1)
        x, Bm, Cm = xs.unflatten(-1, (h, p)), bs.unflatten(-1, (g, n)), cs.unflatten(-1, (g, n))
        dy = rnd(b, h, s, p).to(torch.bfloat16).transpose(1, 2)
    else:
        x = rnd(b, h, s, p).to(torch.bfloat16).transpose(1, 2)
        Bm, Cm = ((rnd(b, g, s, n) * 0.3).to(torch.bfloat16).transpose(1, 2) for _ in range(2))
        dy = rnd(b, s, h, p).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(rnd(b, s, h)) * 2.0
    A = -torch.linspace(1.0, 16.0, h // g, device="cuda").repeat(b * g)
    init = rnd(b, h, n, p) if with_state else None
    dfinal = rnd(b, h, n, p) if with_state else None
    return (x, dt, A, Bm, Cm), dy, init, dfinal, dict(chunk=chunk, heads_per_group=h // g)


@pytest.mark.parametrize("name,kind", SSD_CASES, ids=str)
def test_ssd_forward_on_views(name, kind):
    args, _, init, _, kw = _ssd_views(name, kind)
    x = args[0]
    assert not x.is_contiguous()
    y, state = _no_copy(lambda: ssd_scan(*args, initial_state=init, **kw), ssd_scan)
    assert y.shape == x.shape and y.transpose(1, 2).is_contiguous()
    y2, state2 = ssd_scan(*(t.contiguous() for t in args), initial_state=init, **kw)
    assert torch.equal(y, y2) and torch.equal(state, state2)
    want_y, want_state = ssd_scan_plain(*args, initial_state=init, **kw)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(state, want_state, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("name,kind", SSD_CASES, ids=str)
def test_ssd_backward_on_views(name, kind):
    args, dy, init, dfinal, kw = _ssd_views(name, kind, seed=1)
    got = _no_copy(lambda: ssd_scan_bwd(*args, dy, dfinal, initial_state=init, **kw),
                   ssd_scan_bwd)
    x, dt, _, Bm, _ = args
    assert [t.shape for t in got[:5]] == [x.shape, dt.shape, args[2].shape, Bm.shape, Bm.shape]
    assert all(got[i].is_contiguous() for i in (0, 3, 4))
    assert got[1].transpose(1, 2).is_contiguous()            # ddt: the flattened rows' memory
    again = ssd_scan_bwd(*(t.contiguous() for t in args), dy.contiguous(), dfinal,
                         initial_state=init, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
    want = ssd_scan_bwd_plain(*args, dy, dfinal, initial_state=init, **kw)
    got, want = ([t for t in r if t is not None] for r in (got, want))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _close(got, want, 1e-2)


def test_ssd_forward_writes_y_only_inside_its_rows():
    """Chunks of 100 tokens over 1000 of the convolution output's 1024: each
    128-token box reaches past its chunk, where the map's chunk extent
    zero-fills it (the next chunk's tokens are not read), and y's rows stop
    at the chunk's end; against the plain version."""
    args, _, _, _, kw = _ssd_views("mamba2-1.3b", "conv")
    args = tuple(t[:, :1000] if t.dim() > 1 else t for t in args)
    kw = dict(kw, chunk=100)
    y, _ = ssd_scan(*args, **kw)
    want, _ = ssd_scan_plain(*args, **kw)
    torch.testing.assert_close(y.float(), want.float(), rtol=3e-2, atol=3e-2)
