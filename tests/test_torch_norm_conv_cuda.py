"""B4's and B5's kernels (``csrc/rms_norm.cu``, ``csrc/causal_conv1d.cu``) on
the card, each against its plain version on the same inputs.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_norm_conv_cuda.py``.
Without a card every case skips.

* B5's forward rounds every tap, add and SiLU as ``causal_conv1d_plain``'s
  eager ops do: output and new state equal bit for bit.
* B4's forward rounds as the eager chain does, but sums a row's squares in
  its own order. So its output is the eager chain's evaluated at the
  kernel's own rstd, bit for bit on every row: equal to the plain output on
  every row whose rstd equals the plain one (computed by the same ops as
  the plain forward); the rstd within 1e-5 of the plain one (relative: an
  f32 sum of at most 16384 squares in another order), which moves the
  output by at most two ulps of the dtype in bf16 (``round(x·rstd)`` by
  one, then the product with ``scale`` rounds again).
* The redesigned adjoints (the staged convolution adjoint, the one-pass
  norm adjoint) are held the same way at the edges of their plans: steps
  off the tile, channels off the chunk, S < W-1 with a state, the scalar
  route, grids of one block and of the card's wave; the staged kernel's
  recomputed pre-activation (packed bf16 products and sums) equals the
  plain chain's bit for bit.
* The adjoints differ from their plain versions (f32 on the card) only by
  the order of their f32 sums (a row's dot, the column sums of dscale, dD,
  dw and db): the relative error of the difference's norm is held within
  ``chip_smoke.norm_adj_tol``: 1e-5 in f32; in bf16 2e-4, or 2^-6/sqrt(n)
  for a gradient of n elements where that is more (each output is rounded
  once to bf16, and an f32 order difference moves a value across a
  rounding boundary by one ulp now and then), which an adjoint computing
  in bf16 (~4e-3) exceeds (``tests/test_torch_norm_conv.py`` holds that on
  the CPU).
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import causal_conv as cc
from repro_torch.kernels import ops
from repro_torch.kernels import rms_norm as rn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import norm_adj_tol  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = (torch.float32, torch.bfloat16)
# B4's plain widths: q/k norms (128), the trained and served models' d_model
PLAIN_WIDTHS = (128, 1024, 2048, 3072, 4096, 5120, 7168, 8192)
# the gated form (H, P): mamba2-1.3b's d_inner 4096, jamba's 16384
GATED = ((64, 64), (256, 64))
# B5's channels: mamba2-1.3b's 4352, jamba's 16640, a width off the vector route
CHANNELS = (4352, 16640, 77)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _randn(shape, gen, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _adjoint_close(got, want, dtype) -> bool:
    """An adjoint's output within ``norm_adj_tol`` of its plain version's."""
    return _rel(got, want) <= norm_adj_tol(str(dtype).split(".")[1], want.numel())


def _ulps(a, b):
    """|a - b| in units of b's last place (of its dtype: 8 bits of precision
    in bf16, 24 in f32)."""
    bits = 8 if b.dtype == torch.bfloat16 else 24
    _, e = torch.frexp(b.float())
    ulp = torch.ldexp(torch.ones_like(b, dtype=torch.float32), e - bits)
    return (a.float() - b.float()).abs() / ulp.clamp_min(torch.finfo(b.dtype).tiny)


def _took(fn, before):
    return {r: fn.launches_by_route[r] - before[r] for r in fn.launches_by_route}


def _statistic_rule(got, rstd, want, want_rstd, normed, scale):
    """The kernel's output is the eager chain's at the kernel's rstd, bit for
    bit (``normed`` the tensor the norm takes: x, or the gated product);
    rows whose rstd equals the plain one equal the plain output bit for bit;
    the rstd within 1e-5 of the plain one; bf16 outputs within two ulps."""
    again = (normed.float() * rstd[..., None]).to(got.dtype) * scale
    assert torch.equal(_bits(got), _bits(again.contiguous()))
    assert float(((rstd - want_rstd).abs() / want_rstd).max()) <= 1e-5
    same = (rstd == want_rstd).reshape(-1)
    rows_got, rows_want = got.reshape(same.numel(), -1), want.reshape(same.numel(), -1)
    assert torch.equal(_bits(rows_got[same]), _bits(rows_want[same]))
    if got.dtype == torch.bfloat16 and (~same).any():
        assert float(_ulps(rows_got[~same], rows_want[~same]).max()) <= 2.0
    return float(same.float().mean())


# ---------------------------------------------------------------------------
# B4, plain form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", PLAIN_WIDTHS)
@pytest.mark.parametrize("layout", ["contiguous", "last_rows"])
def test_rms_norm_forward_and_adjoint(dtype, d, layout):
    gen = _gen(d)
    rows = 40 * 64 if d == 128 else 256
    full = _randn((4, rows // 4, d), gen, dtype)
    x = full if layout == "contiguous" else full[:, -1:]       # rows S·D apart (logits)
    scale = _randn((d,), gen, dtype, 0.5) + 1
    before = dict(rn.rms_norm_fwd.launches_by_route)
    got, rstd = rn.rms_norm_fwd(x, scale, 1e-5, keep_rstd=True)
    assert _took(rn.rms_norm_fwd, before) == {"vector": 1, "scalar": 0}
    want, want_rstd = rn.rms_norm_fwd_plain(x, scale, 1e-5, keep_rstd=True)
    _statistic_rule(got, rstd, want, want_rstd, x, scale)
    g = _randn(x.shape, gen, dtype)
    before = dict(rn.rms_norm_bwd.launches_by_route)
    dx, ds = rn.rms_norm_bwd(g, x, scale, rstd)
    assert _took(rn.rms_norm_bwd, before) == {"vector": 1, "scalar": 0}
    wdx, wds = rn.rms_norm_bwd_plain(g, x, scale, rstd)
    assert dx.dtype == dtype and ds.dtype == dtype
    assert _adjoint_close(dx, wdx, dtype) and _adjoint_close(ds, wds, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [77, 1000, 3 * 1024 + 4])
def test_rms_norm_scalar_route(dtype, d):
    """A width that is no whole number of 16-byte units, and rows off
    16-byte alignment (a slice starting one element in): the scalar route."""
    gen = _gen(d)
    x = _randn((3, 50, d + 1), gen, dtype)[..., 1:]
    scale = _randn((d,), gen, dtype, 0.5) + 1
    before = dict(rn.rms_norm_fwd.launches_by_route)
    got, rstd = rn.rms_norm_fwd(x, scale, 1e-6, keep_rstd=True)
    assert _took(rn.rms_norm_fwd, before) == {"vector": 0, "scalar": 1}
    want, want_rstd = rn.rms_norm_fwd_plain(x, scale, 1e-6, keep_rstd=True)
    _statistic_rule(got, rstd, want, want_rstd, x, scale)
    g = _randn(x.shape, gen, dtype)
    dx, ds = rn.rms_norm_bwd(g, x, scale, rstd)
    wdx, wds = rn.rms_norm_bwd_plain(g, x, scale, rstd)
    assert _adjoint_close(dx, wdx, dtype) and _adjoint_close(ds, wds, dtype)


def test_rms_norm_refuses_what_it_does_not_take():
    x = torch.randn(4, 64, device="cuda")
    with pytest.raises(ValueError):
        rn.rms_norm_fwd(x, torch.ones(64, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        rn.rms_norm_fwd(x.half(), torch.ones(64, device="cuda", dtype=torch.half))
    with pytest.raises(ValueError):
        rn.rms_norm_fwd(torch.randn(2, rn.MAX_WIDTH + 8, device="cuda"),
                        torch.ones(rn.MAX_WIDTH + 8, device="cuda"))


# ---------------------------------------------------------------------------
# B4, gated form
# ---------------------------------------------------------------------------

def _gated(b, s, h, p, dtype, gen, decode=False):
    """The layouts ``mamba2_mixer`` hands over: y the SSD kernel's (B, H, S,
    P) buffer seen as (B, S, H, P) (at decode (B, 1, H, P) f32), xh the
    first H·P columns of the convolution's output, z the first H·P columns
    of the projection."""
    d = h * p
    if decode:
        y = _randn((b, h, p), gen, torch.float32)[:, None]
    else:
        y = _randn((b, h, s, p), gen, dtype).transpose(1, 2)
    xh = _randn((b, s, d + 256), gen, dtype)[..., :d].reshape(b, s, h, p)
    z = _randn((b, s, 2 * d + 320), gen, dtype)[..., :d]
    D = _randn((h,), gen, torch.float32)
    scale = _randn((d,), gen, dtype, 0.5) + 1
    return y, xh, D, z, scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hp", GATED)
def test_gated_forward_and_adjoint(dtype, hp):
    h, p = hp
    gen = _gen(h)
    y, xh, D, z, scale = _gated(2, 512, h, p, dtype, gen)
    before = dict(rn.gated_rms_norm_fwd.launches_by_route)
    got, rstd = rn.gated_rms_norm_fwd(y, xh, D, z, scale, 1e-5, keep_rstd=True)
    assert _took(rn.gated_rms_norm_fwd, before) == {"vector": 1, "scalar": 0}
    want, want_rstd = rn.gated_rms_norm_fwd_plain(y, xh, D, z, scale, 1e-5, keep_rstd=True)
    _statistic_rule(got, rstd, want, want_rstd, rn.gated_product_plain(y, xh, D, z), scale)
    g = _randn(z.shape, gen, dtype)
    before = dict(rn.gated_rms_norm_bwd.launches_by_route)
    grads = rn.gated_rms_norm_bwd(g, y, xh, D, z, scale, rstd)
    assert _took(rn.gated_rms_norm_bwd, before) == {"vector": 1, "scalar": 0}
    want = rn.gated_rms_norm_bwd_plain(g, y, xh, D, z, scale, rstd)
    assert grads[0].stride() == y.stride()             # dy in the SSD kernel's layout
    for name, a, w in zip(("dy", "dxh", "dD", "dz", "dscale"), grads, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert _adjoint_close(a, w, dtype), (name, _rel(a, w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_decode_step_takes_an_f32_y(dtype):
    gen = _gen(7)
    y, xh, D, z, scale = _gated(4, 1, 64, 64, dtype, gen, decode=True)
    got, rstd = rn.gated_rms_norm_fwd(y, xh, D, z, scale, 1e-5, keep_rstd=True)
    want, want_rstd = rn.gated_rms_norm_fwd_plain(y, xh, D, z, scale, 1e-5, keep_rstd=True)
    _statistic_rule(got, rstd, want, want_rstd, rn.gated_product_plain(y, xh, D, z), scale)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_scalar_route(dtype):
    """Heads of 5 elements: no whole 16-byte unit, the scalar route."""
    gen = _gen(9)
    y, xh, D, z, scale = _gated(2, 33, 12, 5, dtype, gen)
    before = dict(rn.gated_rms_norm_fwd.launches_by_route)
    got, rstd = rn.gated_rms_norm_fwd(y, xh, D, z, scale, 1e-5, keep_rstd=True)
    assert _took(rn.gated_rms_norm_fwd, before) == {"vector": 0, "scalar": 1}
    want, want_rstd = rn.gated_rms_norm_fwd_plain(y, xh, D, z, scale, 1e-5, keep_rstd=True)
    _statistic_rule(got, rstd, want, want_rstd, rn.gated_product_plain(y, xh, D, z), scale)
    g = _randn(z.shape, gen, dtype)
    grads = rn.gated_rms_norm_bwd(g, y, xh, D, z, scale, rstd)
    want = rn.gated_rms_norm_bwd_plain(g, y, xh, D, z, scale, rstd)
    for name, a, w in zip(("dy", "dxh", "dD", "dz", "dscale"), grads, want):
        assert _adjoint_close(a, w, dtype), (name, _rel(a, w))


# ---------------------------------------------------------------------------
# B5
# ---------------------------------------------------------------------------

def _conv(b, s, c, dtype, gen, with_state, strided=True):
    """x the x|B|C columns of a wider projection (as ``mamba2_mixer`` hands
    it), w (4, C) at the model's init scale, a small bias."""
    x = _randn((b, s, c + 4160), gen, dtype)[..., 4096:4096 + c] if strided else \
        _randn((b, s, c), gen, dtype)
    w = _randn((4, c), gen, dtype, 0.5)
    bias = _randn((c,), gen, dtype, 0.1)
    state = _randn((b, 3, c), gen, dtype) if with_state else None
    return x, w, bias, state


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1024, 1, 37])
def test_conv_forward_bits_and_adjoint(dtype, c, with_state, s):
    gen = _gen(c + s)
    x, w, bias, state = _conv(2 if c > 5000 else 4, s, c, dtype, gen, with_state)
    route = "vector" if c * x.element_size() % 8 == 0 else "scalar"
    # x's rows 16-byte apart: the staged forward but at a decode step
    fwd_route = "staged" if route == "vector" and s > 1 else route
    before = dict(cc.causal_conv1d_fwd.launches_by_route)
    out, new_state = cc.causal_conv1d_fwd(x, w, bias, state)
    assert _took(cc.causal_conv1d_fwd, before) == {r: int(r == fwd_route)
                                                   for r in cc.FWD_ROUTES}
    want, want_state = cc.causal_conv1d_plain(x, w, bias, state)
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(_bits(new_state), _bits(want_state.contiguous()))
    g = _randn(out.shape, gen, dtype)
    before = dict(cc.causal_conv1d_bwd.launches_by_route)
    grads = cc.causal_conv1d_bwd(g, x, w, bias, state, need_dstate=True)
    assert _took(cc.causal_conv1d_bwd, before) == {r: int(r == route) for r in cc.ROUTES}
    want = cc.causal_conv1d_bwd_plain(g, x, w, bias, state, need_dstate=True)
    for name, a, wv in zip(("dx", "dw", "db", "dstate"), grads, want):
        assert (a is None) == (wv is None), name
        if a is not None:
            assert a.shape == wv.shape and a.dtype == wv.dtype, name
            assert _adjoint_close(a, wv, dtype), (name, _rel(a, wv))


def test_conv_function_under_grad_on_the_card():
    """``ops.causal_conv1d`` under grad: the Function, its gradients those of
    autograd through the plain forward (f32), the new state's included."""
    gen = _gen(11)
    x, w, bias, state = _conv(2, 40, 96, torch.float32, gen, True)
    gs = _randn((2, 3, 96), gen, torch.float32)
    g = _randn((2, 40, 96), gen, torch.float32)

    def grads(fn):
        ins = [t.detach().clone().requires_grad_(True) for t in (x, w, bias, state)]
        out, ns = fn(*ins)
        torch.autograd.backward([out, ns], [g, gs])
        return [t.grad for t in ins]
    got = grads(ops.causal_conv1d)
    want = grads(cc.causal_conv1d_plain)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5


def test_norms_under_grad_on_the_card():
    """``ops.rms_norm`` and ``ops.gated_rms_norm`` under grad: the Functions,
    their gradients those of autograd through the plain forwards (f32)."""
    gen = _gen(12)
    x = _randn((2, 30, 256), gen, torch.float32)
    scale = _randn((256,), gen, torch.float32, 0.5) + 1
    g = _randn(x.shape, gen, torch.float32)

    def grads(fn, inputs, gout):
        ins = [t.detach().clone().requires_grad_(True) for t in inputs]
        torch.autograd.backward([fn(*ins)], [gout])
        return [t.grad for t in ins]
    for a, b in zip(grads(lambda *a: ops.rms_norm(*a, 1e-5), (x, scale), g),
                    grads(lambda *a: rn.rms_norm_plain(*a, 1e-5), (x, scale), g)):
        assert _rel(a, b) <= 1e-5
    y, xh, D, z, sc = _gated(2, 30, 8, 16, torch.float32, gen)
    gz = _randn(z.shape, gen, torch.float32)
    for a, b in zip(grads(lambda *a: ops.gated_rms_norm(*a, 1e-5), (y, xh, D, z, sc), gz),
                    grads(lambda *a: rn.gated_rms_norm_plain(*a, 1e-5), (y, xh, D, z, sc), gz)):
        assert _rel(a, b) <= 1e-5


# ---------------------------------------------------------------------------
# the redesigned adjoints at the edges of their plans
# ---------------------------------------------------------------------------

def _conv_adjoint_close(x, w, bias, state, gen, route):
    """The adjoint on ``route`` against the plain one; the staged kernel's
    recomputed pre-activation equal to the plain chain's bit for bit and its
    SiLU to the forward's output."""
    g = _randn(x.shape, gen, x.dtype)
    before = dict(cc.causal_conv1d_bwd.launches_by_route)
    grads = cc.causal_conv1d_bwd(g, x, w, bias, state, need_dstate=state is not None)
    assert _took(cc.causal_conv1d_bwd, before) == {r: int(r == route) for r in cc.ROUTES}
    want = cc.causal_conv1d_bwd_plain(g, x, w, bias, state, need_dstate=state is not None)
    for name, a, wv in zip(("dx", "dw", "db", "dstate"), grads, want):
        assert (a is None) == (wv is None), name
        if a is not None:
            assert _adjoint_close(a, wv, x.dtype), (name, _rel(a, wv))
    if route == "vector":
        pre = cc.conv_preactivation(g, x, w, bias, state)
        s = x.shape[1]
        xin = torch.cat([state if state is not None else x.new_zeros((x.shape[0], 3, x.shape[2])),
                         x], dim=1)
        chain = torch.zeros_like(pre)
        for i in range(4):
            chain = chain + xin[:, i:i + s] * w[i]
        chain = chain + bias
        assert torch.equal(_bits(pre), _bits(chain))
        out, _ = cc.causal_conv1d_fwd(x, w, bias, state)
        assert torch.equal(_bits(torch.nn.functional.silu(pre)), _bits(out))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [100, 65, 127, 2, 8])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv_staged_adjoint_ragged_steps(dtype, s, with_state):
    """S off the 64-step tile and the 8-step segment, and S < W-1 with a
    state (its gradient from the first segment's dpre alone)."""
    gen = _gen(s + 7)
    x, w, bias, state = _conv(3, s, 4352, dtype, gen, with_state)
    _conv_adjoint_close(x, w, bias, state, gen, "vector")


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 72), (torch.bfloat16, 4360),
                                     (torch.float32, 36), (torch.float32, 100)])
def test_conv_staged_adjoint_channels_off_the_chunk(dtype, c):
    """C a whole number of 16 bytes but not of the 128-byte chunk: the last
    chunk's channels past C are zero-filled by TMA and never stored."""
    gen = _gen(c)
    x, w, bias, state = _conv(2, 300, c, dtype, gen, True)
    _conv_adjoint_close(x, w, bias, state, gen, "vector")


@pytest.mark.parametrize("case", ["c_8_bytes", "x_offset_8_bytes"])
def test_conv_adjoint_takes_the_scalar_route_off_tma_alignment(case):
    """A layout the staged kernel's tensor maps do not take (C or x's start
    8-byte but not 16-byte aligned) goes to the scalar route, counted there;
    the forward takes the register-window kernel's 8-byte route."""
    gen = _gen(3)
    if case == "c_8_bytes":
        x, w, bias, state = _conv(2, 70, 4356, torch.bfloat16, gen, True)
    else:
        full = _randn((2, 70, 4352 + 8), gen, torch.bfloat16)
        x = full[..., 4:4 + 4352]
        _, w, bias, state = _conv(2, 70, 4352, torch.bfloat16, gen, True)
    before = dict(cc.causal_conv1d_fwd.launches_by_route)
    cc.causal_conv1d_fwd(x, w, bias, state)
    assert _took(cc.causal_conv1d_fwd, before) == {"staged": 0, "vector": 1, "scalar": 0}
    _conv_adjoint_close(x, w, bias, state, gen, "scalar")
    with pytest.raises(ValueError, match="16-byte"):
        cc.conv_preactivation(_randn(x.shape, gen, x.dtype), x, w, bias, state)


@pytest.mark.parametrize("sms,per_sm", [(1, 1), (3, 1), (132, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_staged_adjoint_on_small_grids(sms, per_sm, dtype, monkeypatch):
    """One block walking every tile of every chunk and sequence, three blocks
    whose ranges each cross many chunks (a partial row each time), and the
    card's own wave: the same gradients."""
    monkeypatch.setattr(cc, "_sm_count", lambda dev: sms)
    monkeypatch.setattr(cc, "_residency", lambda *a: per_sm)
    gen = _gen(sms)
    x, w, bias, state = _conv(2, 200, 1088, dtype, gen, True)
    _conv_adjoint_close(x, w, bias, state, gen, "vector")


# B4's one-pass plan at its edges: a 128-wide row on a quarter-warp, 2048 on
# 128 threads, 3072 on 192, 4096 gated on 512; a tpr rounded up to a
# multiple of 32, rows past 8192 (NU 2) and f32 past 8192 (NU 4)
EDGE_WIDTHS = (128, 2048, 3072, 4096, 4104, 136, 16384)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", EDGE_WIDTHS)
def test_rms_norm_one_pass_adjoint_widths(dtype, d):
    gen = _gen(d + 1)
    rows = 8 * 64 if d <= 4104 else 64
    x = _randn((rows, d), gen, dtype)
    scale = _randn((d,), gen, dtype, 0.5) + 1
    _, rstd = rn.rms_norm_fwd_plain(x, scale, 1e-5, keep_rstd=True)
    g = _randn(x.shape, gen, dtype)
    before = dict(rn.rms_norm_bwd.launches_by_route)
    dx, ds = rn.rms_norm_bwd(g, x, scale, rstd)
    assert _took(rn.rms_norm_bwd, before) == {"vector": 1, "scalar": 0}
    wdx, wds = rn.rms_norm_bwd_plain(g, x, scale, rstd)
    assert _adjoint_close(dx, wdx, dtype) and _adjoint_close(ds, wds, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hp", [(64, 64), (128, 64), (2, 64)])
@pytest.mark.parametrize("sms,per_sm", [(1, 1), (2, 1), (132, 2)])
def test_norm_adjoints_on_small_grids(dtype, hp, sms, per_sm, monkeypatch):
    """One block over every row (its row groups' shared accumulators added
    in order once), two blocks, and the card's wave; the gated form at
    mamba2's heads, twice as many, and two."""
    monkeypatch.setattr(rn, "_sm_count", lambda dev: sms)
    monkeypatch.setattr(rn, "_bwd_residency", lambda *a: per_sm)
    h, p = hp
    gen = _gen(h + sms)
    y, xh, D, z, scale = _gated(2, 96, h, p, dtype, gen)
    _, rstd = rn.gated_rms_norm_fwd_plain(y, xh, D, z, scale, 1e-5, keep_rstd=True)
    g = _randn(z.shape, gen, dtype)
    grads = rn.gated_rms_norm_bwd(g, y, xh, D, z, scale, rstd)
    want = rn.gated_rms_norm_bwd_plain(g, y, xh, D, z, scale, rstd)
    for name, a, w in zip(("dy", "dxh", "dD", "dz", "dscale"), grads, want):
        assert _adjoint_close(a, w, dtype), (name, _rel(a, w))
    x = _randn((3, 70, h * p // 2), gen, dtype)
    sc = _randn((h * p // 2,), gen, dtype, 0.5) + 1
    _, r = rn.rms_norm_fwd_plain(x, sc, 1e-5, keep_rstd=True)
    gx = _randn(x.shape, gen, dtype)
    dx, ds = rn.rms_norm_bwd(gx, x, sc, r)
    wdx, wds = rn.rms_norm_bwd_plain(gx, x, sc, r)
    assert _adjoint_close(dx, wdx, dtype) and _adjoint_close(ds, wds, dtype)


def test_plain_forward_caches_its_layout_and_keeps_its_refusals():
    """A layout's checks and plan are made once (the cache holds it after a
    call), a pointer off 16 bytes in a cached layout still takes the scalar
    route, and a refused layout raises every time."""
    gen = _gen(31)
    x = _randn((4, 1, 2048), gen, torch.bfloat16)
    scale = _randn((2048,), gen, torch.bfloat16, 0.5) + 1
    rn.rms_norm_fwd(x, scale)
    assert any(k[0] == x.shape and k[1] == x.stride() for k in rn._FWD_LAYOUTS)
    full = _randn((4, 1, 2048 + 8), gen, torch.bfloat16)
    shifted = full[..., 8:]                   # 16-byte aligned, x's strides
    odd = full[..., 4:4 + 2048]              # 8 bytes in: the scalar route
    for t, route in ((shifted, "vector"), (odd, "scalar")):
        before = dict(rn.rms_norm_fwd.launches_by_route)
        got, rstd = rn.rms_norm_fwd(t, scale, 1e-5, keep_rstd=True)
        assert _took(rn.rms_norm_fwd, before) == {r: int(r == route) for r in rn.ROUTES}
        want, want_rstd = rn.rms_norm_fwd_plain(t, scale, 1e-5, keep_rstd=True)
        _statistic_rule(got, rstd, want, want_rstd, t, scale)
    for _ in range(2):
        with pytest.raises(ValueError):
            rn.rms_norm_fwd(x, scale.float())


# ---------------------------------------------------------------------------
# B5's staged forward at the edges of its plan
# ---------------------------------------------------------------------------

def _fwd_bits(x, w, bias, state, route):
    """One forward call on ``route`` (counted there alone), its output and
    new state equal to the plain version's bit for bit."""
    before = dict(cc.causal_conv1d_fwd.launches_by_route)
    out, new_state = cc.causal_conv1d_fwd(x, w, bias, state)
    assert _took(cc.causal_conv1d_fwd, before) == {r: int(r == route) for r in cc.FWD_ROUTES}
    want, want_state = cc.causal_conv1d_plain(x, w, bias, state)
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(_bits(new_state), _bits(want_state.contiguous()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 2, 3, 8, 37, 63, 64, 65, 100, 127, 1024])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv_staged_forward_steps(dtype, s, with_state):
    """S off the 8-step segment and the 64-step tile, S < W-1 (the new state
    partly the old one's rows): x read in place from the wider projection.
    The decode step (S = 1 with the cache's state) takes the register
    window's 8-byte route."""
    gen = _gen(s + 3)
    x, w, bias, state = _conv(3, s, 4352, dtype, gen, with_state)
    _fwd_bits(x, w, bias, state, "staged" if s > 1 else "vector")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [72, 4360])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv_staged_forward_channels_off_the_chunk(dtype, c, with_state):
    """C a whole number of 16 bytes but not of the 512-byte chunk: TMA
    zero-fills the last chunk's channels past C, whose lanes store nothing."""
    gen = _gen(c + 5)
    x, w, bias, state = _conv(2, 300, c, dtype, gen, with_state)
    _fwd_bits(x, w, bias, state, "staged")


@pytest.mark.parametrize("sms,per_sm", [(1, 1), (3, 1), (132, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_staged_forward_on_small_grids(sms, per_sm, dtype, monkeypatch):
    """One block walking every tile of every chunk and sequence, three blocks
    whose ranges cross chunks and sequences mid-tile, and the card's wave."""
    monkeypatch.setattr(cc, "_sm_count", lambda dev: sms)
    monkeypatch.setattr(cc, "_fwd_residency", lambda *a: per_sm)
    monkeypatch.setattr(cc, "_FWD_LAYOUTS", {})
    gen = _gen(sms + 1)
    x, w, bias, state = _conv(2, 200, 1088, dtype, gen, True)
    _fwd_bits(x, w, bias, state, "staged")


@pytest.mark.parametrize("case,route", [("c_8_bytes", "vector"), ("x_offset_8_bytes", "vector"),
                                        ("row_stride_8_bytes", "vector"),
                                        ("x_offset_2_bytes", "scalar")])
def test_conv_forward_off_tma_alignment_takes_the_window_kernel(case, route):
    """Layouts TMA does not take go to the register-window kernel: its 8-byte
    route where C, the row strides and x's start are 8-byte aligned, else a
    channel at a time; counted by route, the same bits."""
    gen = _gen(17)
    c = 4356 if case == "c_8_bytes" else 4352
    width = {"row_stride_8_bytes": c + 4}.get(case, c + 8)
    offset = {"x_offset_8_bytes": 4, "x_offset_2_bytes": 1}.get(case, 0)
    x = _randn((2, 70, width), gen, torch.bfloat16)[..., offset:offset + c]
    _, w, bias, state = _conv(2, 70, c, torch.bfloat16, gen, True)
    _fwd_bits(x, w, bias, state, route)


@pytest.mark.parametrize("s,routes", [(1, ("vector", "vector", "scalar")),
                                      (2, ("staged", "vector", "scalar"))])
def test_conv_forward_caches_its_layout_and_keeps_its_refusals(s, routes):
    """A layout's checks, route and plan are made once (the cache holds it
    after a call); the same layout 8 and 2 bytes off takes the 8-byte and
    the scalar route; a refused layout raises every time, before and after a
    cached one. A decode step's x|B|C slice and a two-step one."""
    gen = _gen(41 + s)
    full = _randn((4, s, 8512 + 8), gen, torch.bfloat16)
    x = full[..., 3840:3840 + 4352]
    _, w, bias, state = _conv(4, s, 4352, torch.bfloat16, gen, True)
    for _ in range(2):
        with pytest.raises(ValueError):
            cc.causal_conv1d_fwd(x, w.float(), bias, state)
    for offset, route in zip((0, 4, 1), routes):
        _fwd_bits(full[..., 3840 + offset:3840 + offset + 4352], w, bias, state, route)
    assert cc._layout_key(x, w, bias, state) in cc._FWD_LAYOUTS
    for _ in range(2):
        with pytest.raises(ValueError):
            cc.causal_conv1d_fwd(x, w.float(), bias, state)


@pytest.mark.parametrize("width", [1, 4])
def test_conv_forward_silu_equals_f_silu_on_every_bf16_input(width):
    """The staged forward's SiLU (a fast form, the exact chain near bf16
    rounding boundaries) on each of the 65,536 bf16 bit patterns as a
    pre-activation: w's last tap 1, the others and the bias 0, so the
    pre-activation is x itself (-0 becomes +0, as in the plain chain). Width
    1 takes every pattern, infinities and NaNs included; width 4 the finite
    ones (a zero tap times an infinity is NaN). Every output equals the plain
    version's bit for bit, NaN where it is NaN."""
    pats = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    if width == 4:
        pats = torch.where(torch.isfinite(pats), pats, torch.zeros_like(pats))
    x = pats.reshape(1, 256, 256).cuda()
    w = torch.zeros((width, 256), dtype=torch.bfloat16, device="cuda")
    w[-1] = 1
    bias = torch.zeros(256, dtype=torch.bfloat16, device="cuda")
    before = dict(cc.causal_conv1d_fwd.launches_by_route)
    out, _ = cc.causal_conv1d_fwd(x, w, bias)
    assert _took(cc.causal_conv1d_fwd, before) == {"staged": 1, "vector": 0, "scalar": 0}
    want, _ = cc.causal_conv1d_plain(x, w, bias)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(_bits(out)[~nan], _bits(want)[~nan])
