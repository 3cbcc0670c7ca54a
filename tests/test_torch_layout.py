"""K2 and K3 in the model's (B, S, H, ·) layout, on the CPU.

``ops.flash_attention_bshd`` and ``ops.ssd_bshp`` hand the model's tensors
to the kernels as they come: q, k, v as slices of one fused projection or
as transposed views; x, B and C as views of the convolution's output. Here
the wrappers take the plain versions, against the reference's
``blockwise_attention`` and ``ssd_chunked`` under ``jax.grad``, at the
tolerances of ``test_torch_flash_backward.py`` (1e-4 of the largest
gradient against JAX, 2e-5 forward) and ``test_torch_ssd_backward.py``
(``F32``, 1e-4 of the largest gradient), and bit for bit against the same
calls on ``.contiguous()`` copies. The ``sm90`` launches run against a
stand-in library that records what the kernel would be given: the views'
own pointers and strides, no operand copied. ``layout.kernel_strides``,
the helper that turns operands into their maps' strides, is held to hand
counts and to its refusals.
"""
import ctypes
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blockwise_attention as jax_blockwise_attention
from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.layout import bshw_as_rows, kernel_strides, rows_as_bshw, rows_to_bshw

fa = importlib.import_module("repro_torch.kernels.flash_attention")
ss = importlib.import_module("repro_torch.kernels.ssd_scan")

# (batch, Sq, Sk, H, Kv, hd, causal, window, q_offset): B = 2, H != Kv throughout
ATTN = {
    "causal_gqa3": (2, 40, 40, 6, 2, 64, True, None, 0),
    "cross_ragged_sk": (2, 24, 75, 4, 2, 32, False, None, 0),
    "window_gqa2": (2, 33, 33, 4, 2, 64, True, 8, 0),
    "hd112_gqa4": (2, 20, 20, 8, 2, 112, True, None, 0),
}
# (batch, seq, heads, groups, P, N, chunk)
SSD = {
    "one_group": (2, 64, 4, 1, 16, 8, 16),
    "two_groups": (2, 48, 4, 2, 8, 16, 12),
    "head_a_group": (2, 32, 2, 2, 16, 8, 8),
}
F32 = dict(rtol=2e-4, atol=2e-4)


def _close(got, want, rel):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=rel * max(float(np.abs(np.asarray(b)).max()), 1e-6))


# ---- attention ---------------------------------------------------------------

def _attn_arrays(case):
    b, sq, sk, h, kv, hd, *_ = ATTN[case]
    rng = np.random.default_rng(sorted(ATTN).index(case))
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    return q, k, v, do


def _attn_opts(case):
    *_, causal, window, q_offset = ATTN[case]
    return dict(causal=causal, window=window, q_offset=q_offset)


def _fused_views(q, k, v):
    """q, k, v as slices of one (B, S, (H + 2·Kv)·hd) projection (self
    attention: Sq = Sk), and that buffer, as a fused QKV projection makes them."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    buf = torch.from_numpy(np.concatenate(
        [q.reshape(b, s, h * hd), k.reshape(b, s, kv * hd), v.reshape(b, s, kv * hd)], -1))
    buf.requires_grad_()
    cut = torch.split(buf, [h * hd, kv * hd, kv * hd], dim=-1)
    return [t.unflatten(-1, (n, hd)) for t, n in zip(cut, (h, kv, kv))], buf


def _transposed(a):
    """A (B, S, H, hd) view of a contiguous (B, H, S, hd) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2)


def _jax_attn(case, q, k, v, do):
    opts = _attn_opts(case)

    def loss(q, k, v):
        return jnp.sum(jax_blockwise_attention(q, k, v, **opts) * do)
    out = jax_blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **opts)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _attn_views(case, kind):
    """(leaves that take the gradient, q, k, v views) of one layout."""
    q, k, v, _ = _attn_arrays(case)
    if kind == "fused":
        (qv, kv, vv), buf = _fused_views(q, k, v)
        return [buf], (qv, kv, vv)
    leaves = [_transposed(a).detach().requires_grad_() for a in (q, k, v)]
    return leaves, tuple(leaves)


def _grads_of_views(case, kind, views, leaves, do):
    """Gradients of q, k, v as (B, S, ·, hd) numpy arrays."""
    if kind == "fused":
        b, s, h, hd = views[0].shape
        kv = views[1].shape[2]
        g = leaves[0].grad
        parts = torch.split(g, [h * hd, kv * hd, kv * hd], dim=-1)
        return [p.unflatten(-1, (n, hd)).numpy() for p, n in zip(parts, (h, kv, kv))]
    return [t.grad.numpy() for t in leaves]


# a fused projection gives q and k one sequence: cross attention takes the transposed views
VIEWS = [(case, kind) for case in sorted(ATTN) for kind in ("fused", "transposed")
         if kind == "transposed" or ATTN[case][1] == ATTN[case][2]]


@pytest.mark.parametrize("case,kind", VIEWS)
def test_attention_on_views_matches_jax(case, kind):
    q, k, v, do = _attn_arrays(case)
    leaves, views = _attn_views(case, kind)
    assert not any(t.is_contiguous() for t in views)
    out = ops.flash_attention_bshd(*views, **_attn_opts(case))
    assert out.shape == q.shape and out.is_contiguous()
    out.backward(torch.from_numpy(do))
    want_out, want_grads = _jax_attn(case, q, k, v, do)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=2e-5, atol=2e-5)
    _close(_grads_of_views(case, kind, views, leaves, do), want_grads, 1e-4)


@pytest.mark.parametrize("case,kind", VIEWS)
def test_attention_on_views_equals_contiguous_copies_bit_for_bit(case, kind):
    _, _, _, do = _attn_arrays(case)
    leaves, views = _attn_views(case, kind)
    out = ops.flash_attention_bshd(*views, **_attn_opts(case))
    out.backward(torch.from_numpy(do))
    got = _grads_of_views(case, kind, views, leaves, do)
    copies = [t.detach().contiguous().requires_grad_() for t in views]
    want = ops.flash_attention_bshd(*copies, **_attn_opts(case))
    want.backward(torch.from_numpy(do))
    assert torch.equal(out, want)
    for a, b in zip(got, copies):
        assert np.array_equal(a, b.grad.numpy())


# ---- the SSD scan ------------------------------------------------------------

def _ssd_arrays(case):
    b, s, h, g, p, n, _ = SSD[case]
    rng = np.random.default_rng(sorted(SSD).index(case))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    return x, dt, A, Bm, Cm, dy


def _xbc_views(x, Bm, Cm):
    """x, B, C as views of one (B, S, H·P + 2·G·N) tensor, as Mamba2's
    convolution output is cut (``models/ssm.py`` ``_cut_xbc``), and it."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    buf = torch.from_numpy(np.concatenate(
        [x.reshape(b, s, h * p), Bm.reshape(b, s, g * n), Cm.reshape(b, s, g * n)], -1))
    buf.requires_grad_()
    xs, bs, cs = torch.split(buf, [h * p, g * n, g * n], dim=-1)
    return (xs.unflatten(-1, (h, p)), bs.unflatten(-1, (g, n)), cs.unflatten(-1, (g, n))), buf


def _ssd_run(case, x, dt, A, Bm, Cm, dy):
    chunk = SSD[case][6]
    y, state = ops.ssd_bshp(x, dt, A, Bm, Cm, chunk=chunk)
    y.backward(dy)
    return y, state


@pytest.mark.parametrize("case", sorted(SSD))
def test_ssd_on_views_matches_jax(case):
    x, dt, A, Bm, Cm, dy = _ssd_arrays(case)
    (xv, bv, cv), buf = _xbc_views(x, Bm, Cm)
    assert not any(t.is_contiguous() for t in (xv, bv, cv))
    dtt, At = (torch.from_numpy(a).requires_grad_() for a in (dt, A))
    y, state = _ssd_run(case, xv, dtt, At, bv, cv, torch.from_numpy(dy))
    chunk = SSD[case][6]

    def loss(x, dt, A, Bm, Cm):
        return jnp.sum(ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)[0] * dy)
    args = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jy, jstate = ssd_chunked(*args, chunk=chunk)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(state.detach().numpy(), np.asarray(jstate), **F32)
    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)]
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    dx, dB, dC = torch.split(buf.grad, [h * p, g * n, g * n], dim=-1)
    got = [dx.unflatten(-1, (h, p)), dtt.grad, At.grad, dB.unflatten(-1, (g, n)),
           dC.unflatten(-1, (g, n))]
    _close([t.numpy() for t in got], want, 1e-4)


@pytest.mark.parametrize("case", sorted(SSD))
def test_ssd_on_views_equals_contiguous_copies_bit_for_bit(case):
    x, dt, A, Bm, Cm, dy = _ssd_arrays(case)
    (xv, bv, cv), buf = _xbc_views(x, Bm, Cm)
    dtt, At = (torch.from_numpy(a).requires_grad_() for a in (dt, A))
    y, state = _ssd_run(case, xv, dtt, At, bv, cv, torch.from_numpy(dy))
    copies = [t.detach().contiguous().requires_grad_() for t in (xv, dtt, At, bv, cv)]
    y2, state2 = _ssd_run(case, *copies, torch.from_numpy(dy))
    assert torch.equal(y, y2) and torch.equal(state, state2)
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    dx, dB, dC = torch.split(buf.grad, [h * p, g * n, g * n], dim=-1)
    got = [dx.unflatten(-1, (h, p)), dtt.grad, At.grad, dB.unflatten(-1, (g, n)),
           dC.unflatten(-1, (g, n))]
    for a, c in zip(got, copies):
        assert torch.equal(a, c.grad)


def test_ddt_keeps_the_memory_of_the_flattened_rows():
    """K3's backward hands dt's gradient back as (B, S, H) over (B, H, S)
    memory, the layout autograd gave it from the flattened (B·H, S) call, so
    softplus's adjoint and dt_bias's sum after it run on the same strides,
    in the same order: a mamba2 step's gradients equal the flattened
    call's bit for bit (a contiguous ddt changed dt_bias's sum order)."""
    x, dt, A, Bm, Cm, dy = _ssd_arrays("two_groups")
    (xv, bv, cv), _ = _xbc_views(x, Bm, Cm)
    b, s, h = dt.shape
    args = (xv.detach(), torch.from_numpy(dt), torch.from_numpy(A).repeat(b), bv.detach(),
            cv.detach())
    ddt = ss.ssd_scan_bwd(*args, torch.from_numpy(dy), chunk=SSD["two_groups"][6],
                          heads_per_group=2)[1]
    assert ddt.shape == (b, s, h) and ddt.stride() == (h * s, 1, s)


# ---- the map helper ------------------------------------------------------------

def bshw_strides(name, t, heads=1, mapped=True):
    """One operand's (batch, sequence, head) strides from ``kernel_strides``."""
    return tuple(kernel_strides([(name, t, heads, mapped)]))


def test_map_strides_of_the_fused_projection_views():
    b, s, h, kv, hd = 2, 16, 6, 2, 64
    buf = torch.zeros((b, s, (h + 2 * kv) * hd), dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (n, hd)) for t, n in
               zip(torch.split(buf, [h * hd, kv * hd, kv * hd], -1), (h, kv, kv)))
    row = (h + 2 * kv) * hd
    assert bshw_strides("q", q) == (s * row, row, hd)
    assert bshw_strides("k", k) == (s * row, row, hd)
    assert bshw_strides("v", v) == (s * row, row, hd)


def test_map_strides_of_mamba2s_convolution_views():
    """x, B, C of mamba2-1.3b's convolution output: a token stride of 4352."""
    b, s, h, p, g, n = 2, 8, 64, 64, 1, 128
    buf = torch.zeros((b, s, h * p + 2 * g * n), dtype=torch.bfloat16)
    x, bm, cm = torch.split(buf, [h * p, g * n, g * n], -1)
    assert bshw_strides("x", x.unflatten(-1, (h, p))) == (s * 4352, 4352, p)
    assert bshw_strides("B", bm.unflatten(-1, (g, n))) == (s * 4352, 4352, 8)   # one group
    assert bshw_strides("C", cm.unflatten(-1, (g, n)))[1] == 4352


def test_map_strides_of_a_transposed_view_and_the_flattened_layout():
    t = torch.zeros((2, 3, 5, 32), dtype=torch.bfloat16)                 # (B, H, S, hd)
    assert bshw_strides("q", t.transpose(1, 2)) == (3 * 5 * 32, 32, 5 * 32)
    rows = torch.zeros((6, 5, 32), dtype=torch.bfloat16)                 # (B·H, S, hd)
    assert bshw_strides("q", rows, 3) == (3 * 5 * 32, 32, 5 * 32)
    assert bshw_strides("q", rows, 3) == bshw_strides("q", rows_as_bshw(rows, 3))
    assert bshw_strides("k", rows) == (5 * 32, 32, 8)                      # H = 1


def test_map_refuses_a_non_unit_inner_stride():
    t = torch.zeros((2, 4, 3, 64), dtype=torch.bfloat16).transpose(-1, -2).contiguous()
    with pytest.raises(ValueError, match="contiguous in its last dim"):
        bshw_strides("q", t.transpose(-1, -2))


@pytest.mark.parametrize("width", [36, 60, 100])
def test_map_refuses_a_stride_off_16_bytes(width):
    """A slice of a row whose width is no multiple of 8 bf16 values."""
    buf = torch.zeros((2, 4, width), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        bshw_strides("x", buf[..., :32].unflatten(-1, (2, 16)))


def test_map_refuses_a_misaligned_base():
    flat = torch.zeros(2 * 4 * 32 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bshw_strides("x", flat[1:].view(2, 4, 2, 16))


def test_elementwise_strides_and_the_copies_of_the_flattened_layout():
    """dt (B, S, H) is read element by element at any strides; its flattened
    (B·H, S) form gives those of its (B, S, H) view."""
    dt = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    assert bshw_strides("dt", dt, mapped=False) == (15, 3, 1)
    assert bshw_strides("dt", dt[:, :, 1:], mapped=False) == (15, 3, 1)
    assert (bshw_strides("dt", bshw_as_rows(dt), 3, mapped=False)
            == bshw_strides("dt", rows_as_bshw(bshw_as_rows(dt), 3), mapped=False))
    rows = bshw_as_rows(dt)
    assert rows.shape == (6, 5) and rows.is_contiguous()
    assert torch.equal(rows_to_bshw(rows, 3), dt)
    assert torch.equal(rows_as_bshw(rows, 3), dt)


# ---- what the sm90 launches hand their kernels ---------------------------------------

class _Recorder:
    """A stand-in for a kernel library: records each entry point's arguments."""

    def __init__(self, *names):
        self.calls = {}
        for name in names:
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call

    def __getattr__(self, name):
        if name.endswith("_pad"):
            return lambda: 128
        if name.endswith("_state_blocks"):
            return lambda n, p: -(-n * p // 1024)
        if name.endswith("_error_string"):
            return lambda err: b"recorded"
        raise AttributeError(name)


@pytest.fixture
def no_stream(monkeypatch):
    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())


def _array(ptr_arg):
    return list(ptr_arg)


def test_sm90_attention_is_handed_the_views_pointers_and_strides(monkeypatch, no_stream):
    lib = _Recorder("flash_attention_sm90_fwd", "flash_attention_bwd_sm90")
    monkeypatch.setattr(fa, "_lib_sm90", lambda: lib)
    monkeypatch.setattr(fa, "_lib_bwd_sm90", lambda: lib)
    b, s, h, kv, hd = 2, 16, 6, 2, 64
    buf = torch.zeros((b, s, (h + 2 * kv) * hd), dtype=torch.bfloat16)
    qv, kvv, vv = (t.unflatten(-1, (n, hd)) for t, n in
                   zip(torch.split(buf, [h * hd, kv * hd, kv * hd], -1), (h, kv, kv)))
    before = dict(fa.flash_attention.layout_copies)
    before_bwd = dict(fa.flash_attention_bwd.layout_copies)
    out, lse = fa._launch("sm90", qv, kvv, vv, 3, True, None, 0, return_lse=True)
    args = lib.calls["flash_attention_sm90_fwd"]
    assert args[:3] == (qv.data_ptr(), kvv.data_ptr(), vv.data_ptr())
    row = (h + 2 * kv) * hd
    assert _array(args[5]) == [s * row, row, hd] * 3 + [s * h * hd, h * hd, hd]
    assert args[6:8] == (b, h) and out.shape == (b, s, h, hd) and out.is_contiguous()
    assert lse.shape == (b * h, s)
    assert fa.flash_attention.layout_copies == before
    dout = _transposed(np.zeros((b, s, h, hd), np.float32)).to(torch.bfloat16)
    dq, dk, dv = fa._launch_bwd("sm90", qv, kvv, vv, out, lse, dout, 3, True, None, 0)
    args = lib.calls["flash_attention_bwd_sm90"]
    assert args[:5] == tuple(t.data_ptr() for t in (qv, kvv, vv, out, dout))
    assert _array(args[10])[12:15] == [s * h * hd, hd, s * hd]          # dO as it came
    assert all(t.is_contiguous() for t in (dq, dk, dv)) and dk.shape == (b, s, kv, hd)
    assert fa.flash_attention_bwd.layout_copies == before_bwd


def test_sm90_attention_refuses_what_a_map_cannot_take(monkeypatch, no_stream):
    monkeypatch.setattr(fa, "_lib_sm90", lambda: pytest.fail("loaded before the checks"))
    q = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q must be contiguous in its last dim"):
        fa._launch("sm90", q.transpose(-1, -2).contiguous().transpose(-1, -2), k, k, 2, True,
                   None, 0)
    odd = torch.zeros((2, 8, 2 * 64 + 4), dtype=torch.bfloat16)[..., :128].unflatten(-1, (2, 64))
    with pytest.raises(ValueError, match="k: stride"):
        fa._launch("sm90", q, odd, k, 2, True, None, 0)


def test_simt_attention_copies_a_bshd_call_and_counts_it(monkeypatch, no_stream):
    """The f32 route's kernel takes the flattened layout: the fused views are
    copied to it and its output back (4 tensors); a transposed view is the
    flattened layout already, so only k, v and the output are copied."""
    lib = _Recorder("flash_attention_fwd")
    monkeypatch.setattr(fa, "_lib", lambda: lib)
    q, k, v, _ = _attn_arrays("causal_gqa3")
    (qv, kv, vv), _ = _fused_views(q, k, v)
    qv, kv, vv = (t.detach() for t in (qv, kv, vv))
    before = fa.flash_attention.layout_copies["simt"]
    out = fa._launch("simt", qv, kv, vv, 3, True, None, 0)
    assert fa.flash_attention.layout_copies["simt"] == before + 4
    assert lib.calls["flash_attention_fwd"][0] != qv.data_ptr()
    assert out.shape == qv.shape and out.is_contiguous()
    qt = _transposed(q)
    fa._launch("simt", qt, kv, vv, 3, True, None, 0)
    assert lib.calls["flash_attention_fwd"][0] == qt.data_ptr()
    assert fa.flash_attention.layout_copies["simt"] == before + 4 + 3


def test_sm90_ssd_scan_is_handed_the_views_pointers_and_strides(monkeypatch, no_stream):
    lib = _Recorder("ssd_scan_sm90_fwd", "ssd_scan_bwd_sm90")
    monkeypatch.setattr(ss, "_lib_sm90", lambda: lib)
    monkeypatch.setattr(ss, "_lib_bwd_sm90", lambda: lib)
    b, s, h, g, p, n = 2, 32, 4, 1, 64, 128
    width = h * p + 2 * g * n
    buf = torch.zeros((b, s, width), dtype=torch.bfloat16)
    xs, bs, cs = torch.split(buf, [h * p, g * n, g * n], -1)
    x, Bm, Cm = xs.unflatten(-1, (h, p)), bs.unflatten(-1, (g, n)), cs.unflatten(-1, (g, n))
    dt = torch.ones((b, s, h))
    A = -torch.ones(b * h)
    before = dict(ss.ssd_scan.layout_copies)
    y, state = ss._launch("sm90", x, dt, A, Bm, Cm, 16, h // g, None)
    args = lib.calls["ssd_scan_sm90_fwd"]
    assert (args[0], args[3], args[4]) == (x.data_ptr(), Bm.data_ptr(), Cm.data_ptr())
    assert args[1] == dt.data_ptr()
    assert _array(args[8]) == ([s * width, width, p] + [s * width, width, 8] * 2
                               + [s * h, h, 1])
    assert y.shape == (b, s, h, p) and y.transpose(1, 2).is_contiguous()
    assert state.shape == (b, h, n, p)
    assert ss.ssd_scan.layout_copies == before
    grads = ss._launch_bwd("sm90", x, dt, A, Bm, Cm, y, None, 16, h // g, None)
    args = lib.calls["ssd_scan_bwd_sm90"]
    assert args[6] == y.data_ptr()                        # dy in y's layout, not copied
    st = _array(args[20])
    assert st[3:6] == [h * s * p, p, s * p]               # dy: a (B, H, S, P) tensor
    dx, ddt, _, dB, _, _ = grads
    assert st[15:18] == list(dx.stride()[:3]) and dx.is_contiguous()
    assert st[18:21] == list(ddt.stride()) and dB.is_contiguous()


def test_flattened_calls_reach_the_same_kernel_as_their_bshw_views(monkeypatch, no_stream):
    """A (BH, S, ·) call is the (B, S, H, ·) layout of a contiguous (B, H, S, ·)
    tensor: the kernel gets the same pointers and the strides of that view."""
    lib = _Recorder("flash_attention_sm90_fwd")
    monkeypatch.setattr(fa, "_lib_sm90", lambda: lib)
    q = torch.zeros((6, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 8, 64), dtype=torch.bfloat16)
    fa._launch("sm90", q, k, k, 3, True, None, 0)
    args = lib.calls["flash_attention_sm90_fwd"]
    assert args[0] == q.data_ptr()
    assert _array(args[5])[:6] == [3 * 8 * 64, 64, 8 * 64, 8 * 64, 64, 8]
    assert args[6:8] == (2, 3)


# ---- meta tensors: the dry run ---------------------------------------------------

class _OpNames(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


COPIES = {"copy_", "clone", "_to_copy", "contiguous"}


def test_meta_calls_give_the_bshw_shapes_and_make_no_copy():
    """On meta tensors (the dry run) the model's layout reaches the custom
    ops as it is, forward and backward: no copy op around them."""
    from repro_torch.launch.op_analysis import analyze
    buf = torch.empty((2, 64, 12 * 128), device="meta", dtype=torch.bfloat16,
                      requires_grad=True)
    q, k, v = (t.unflatten(-1, (n, 128)) for t, n in
               zip(torch.split(buf, [8 * 128, 2 * 128, 2 * 128], -1), (8, 2, 2)))
    with _OpNames() as rec:
        out = ops.flash_attention_bshd(q, k, v)
        out.backward(torch.empty_like(out))
    assert out.shape == q.shape and out.is_contiguous()
    assert not COPIES & set(rec.names), rec.names
    assert {"flash_attention", "flash_attention_bwd"} <= set(rec.names)
    _, stats = analyze(ops.flash_attention_bshd, q.detach(), k.detach(), v.detach())
    assert stats.traffic_bytes == 2 * (2 * q.numel() + 2 * k.numel())   # q, k, v, o once
    xbc = torch.empty((2, 64, 4 * 64 + 2 * 128), device="meta", dtype=torch.bfloat16,
                      requires_grad=True)
    xs, bs, cs = torch.split(xbc, [4 * 64, 128, 128], -1)
    x, bm, cm = xs.unflatten(-1, (4, 64)), bs.unflatten(-1, (1, 128)), cs.unflatten(-1, (1, 128))
    dt = torch.empty((2, 64, 4), device="meta", requires_grad=True)
    A = torch.empty((4,), device="meta", requires_grad=True)
    with _OpNames() as rec:
        y, state = ops.ssd_bshp(x, dt, A, bm, cm, 32)
        y.backward(torch.empty_like(y))
    assert y.shape == x.shape and state.shape == (2, 4, 64, 128)
    assert not COPIES & set(rec.names), rec.names
    assert {"ssd_scan", "ssd_scan_bwd"} <= set(rec.names)


def test_flop_formulas_agree_across_the_two_layouts():
    from torch.utils.flop_counter import FlopCounterMode
    fa.register_flop_formulas()
    ss.register_flop_formulas()
    q = torch.empty((2, 64, 8, 128), device="meta", dtype=torch.bfloat16)
    k = torch.empty((2, 64, 2, 128), device="meta", dtype=torch.bfloat16)
    counts = []
    for args in ((q, k, k), (bshw_as_rows(q), bshw_as_rows(k), bshw_as_rows(k))):
        with FlopCounterMode(display=False) as fc:
            fa.flash_attention(*args, q_heads_per_kv=4)
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] > 0


# ---- the C entry points against their ctypes signatures ------------------------------

C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "const long long*": ctypes.POINTER(ctypes.c_longlong)}


def _c_params(source: str, entry: str) -> list:
    """The ctypes type of each parameter of ``extern "C" int entry(...)`` in
    ``csrc/<source>.cu``: any other pointer is a ``c_void_p``."""
    from pathlib import Path
    text = (Path(fa.__file__).parent / "csrc" / f"{source}.cu").read_text()
    head = text.split(f'extern "C" int {entry}(', 1)[1].split(")", 1)[0]
    types = []
    for param in head.split(","):
        words = param.split()
        ctype = " ".join(words[:-1]) + ("*" if words[-1].startswith("*") else "")
        types.append(C_TYPES.get(ctype.replace(" *", "*"), ctypes.c_void_p))
    return types


@pytest.mark.parametrize("module,loader,source,entry", [
    (fa, "_lib_sm90", "flash_attention_sm90", "flash_attention_sm90_fwd"),
    (fa, "_lib_bwd_sm90", "flash_attention_bwd_sm90", "flash_attention_bwd_sm90"),
    (ss, "_lib_sm90", "ssd_scan_sm90", "ssd_scan_sm90_fwd"),
    (ss, "_lib_bwd_sm90", "ssd_scan_bwd_sm90", "ssd_scan_bwd_sm90"),
])
def test_ctypes_signatures_match_the_sources(monkeypatch, module, loader, source, entry):
    """Each ``sm90`` entry point's ``argtypes`` has the C function's number
    of parameters, each of its type (a pointer to the strides, ints, int64s,
    the scale), read from the ``.cu`` itself: no card needed."""
    import types

    class _Entry:
        pass
    fake = types.SimpleNamespace()
    monkeypatch.setattr(module, "load_library", lambda name: fake)
    for name in ("flash_attention_sm90_fwd", "flash_attention_sm90_error_string",
                 "flash_attention_bwd_sm90", "flash_attention_bwd_sm90_pad",
                 "flash_attention_bwd_sm90_error_string", "ssd_scan_sm90_fwd",
                 "ssd_scan_sm90_error_string", "ssd_scan_bwd_sm90",
                 "ssd_scan_bwd_sm90_state_blocks", "ssd_scan_bwd_sm90_error_string"):
        setattr(fake, name, _Entry())
    getattr(module, loader).__wrapped__()
    assert list(getattr(fake, entry).argtypes) == _c_params(source, entry)
