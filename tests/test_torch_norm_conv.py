"""B4 (RMSNorm, plain and Mamba2's gated form) and B5 (Mamba2's causal
convolution) on the CPU: their plain adjoints against ``jax.vjp`` of the
reference's functions, their ``autograd.Function``s against autograd of
the plain forwards, the layouts the model hands them, and the launches
``chip_smoke.py`` expects of them against the calls a forward makes.

The same inputs, made from a seed with numpy, go through both frameworks.
Tolerances are on the relative error of the difference's norm: 1e-5 in f32
(the plain adjoints compute in f32 what ``jax.vjp`` computes in f32, in
another order). In bf16 the plain adjoints are held to ``jax.vjp`` of the
reference's function evaluated in f32 at the same bf16 values, within
1e-2: the plain adjoints round the forward's intermediates to bf16 as the
forward does (one bf16 ulp is 2^-8, 3.9e-3 of a value) and each gradient
once; ``jax.vjp`` in bf16 rounds its cotangents at every op and adds the
row sums in bf16, 1.5-2.4% off at these shapes. D's gradient, a sum over
B·S·P products of varying sign, keeps the forward's bf16 roundings where
the sum cancels them: it is held within 2e-2 (1.0e-2 measured at 3 heads of
96 products). Autograd of the plain forward is compared in f32 within 1e-5
(f64 for the convolution, within 1e-10: its plain version computes in x's
dtype); the same arithmetic in another order.
"""
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import causal_conv as cc
from repro_torch.kernels import ops
from repro_torch.kernels import rms_norm as rn
from repro_torch.launch.serve import stub_cross_src
from repro_torch.models import forward_decode, forward_prefill, forward_train, init_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    diff = (got.float() - want).norm()
    return float(diff / want.norm().clamp_min(1e-30))


def _both(a: np.ndarray, dtype: str):
    """The torch tensor in ``dtype`` and the JAX array of its values in f32."""
    return torch.from_numpy(a).to(TORCH[dtype]), _jf32(a, dtype)


def _jf32(a: np.ndarray, dtype: str):
    """``a`` rounded to ``dtype``, as an f32 JAX array: the reference
    evaluated in f32 at the values the port takes."""
    return jnp.asarray(a).astype(JNP[dtype]).astype(jnp.float32)


# ---------------------------------------------------------------------------
# the plain adjoints against jax.vjp of the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 7, 96), (3, 128), (2, 5, 77)])
def test_rms_norm_adjoint_matches_reference_vjp(dtype, shape):
    rng = np.random.default_rng(0)
    x, scale, g = _normal(rng, *shape), _normal(rng, shape[-1]), _normal(rng, *shape)
    (xt, xj), (st, sj), (gt, gj) = _both(x, dtype), _both(scale, dtype), _both(g, dtype)
    _, vjp = jax.vjp(lambda a, b: jax_layers.rms_norm(a, b, 1e-6), xj, sj)
    jdx, jds = vjp(gj)
    _, rstd = rn.rms_norm_fwd_plain(xt, st, 1e-6, keep_rstd=True)
    dx, ds = rn.rms_norm_bwd_plain(gt, xt, st, rstd)
    assert dx.dtype == xt.dtype and ds.dtype == st.dtype
    assert _rel(dx, jdx) <= REL[dtype] and _rel(ds, jds) <= REL[dtype]


def _jax_gated(y, xh, D, z, scale, eps):
    """The reference's tail of ``mamba2_mixer`` (src/repro/models/ssm.py:200-202)."""
    b, s, h, p = xh.shape
    yy = y + xh * D[None, None, :, None]
    yy = yy.reshape(b, s, h * p).astype(z.dtype)
    return jax_layers.rms_norm(yy * jax.nn.silu(z), scale, eps).astype(z.dtype)


def _gated_inputs(rng, b, s, h, p, dtype):
    """y in the SSD kernel's (B, H, S, P) buffer seen as (B, S, H, P); xh the
    first H·P columns of a wider convolution output; z the first H·P
    columns of a wider projection: the layouts ``mamba2_mixer`` hands over."""
    d = h * p
    y = _normal(rng, b, h, s, p)
    conv = _normal(rng, b, s, d + 12)
    proj = _normal(rng, b, s, 2 * d + 20)
    D, scale, g = _normal(rng, h), _normal(rng, d, scale=0.5) + 1, _normal(rng, b, s, d)
    yt = torch.from_numpy(y).to(TORCH[dtype]).transpose(1, 2)
    xht = torch.from_numpy(conv).to(TORCH[dtype])[..., :d].reshape(b, s, h, p)
    zt = torch.from_numpy(proj).to(TORCH[dtype])[..., :d]
    st, gt = torch.from_numpy(scale).to(TORCH[dtype]), torch.from_numpy(g).to(TORCH[dtype])
    jx = lambda a: _jf32(a, dtype)  # noqa: E731
    jargs = (jx(np.swapaxes(y, 1, 2)), jx(conv[..., :d].reshape(b, s, h, p)), jnp.asarray(D),
             jx(proj[..., :d]), jx(scale))
    return (yt, xht, torch.from_numpy(D), zt, st, gt), jargs, jx(g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 6, 3, 8), (1, 5, 2, 5)])
def test_gated_adjoint_matches_reference_vjp(dtype, dims):
    rng = np.random.default_rng(1)
    (yt, xht, Dt, zt, st, gt), jargs, gj = _gated_inputs(rng, *dims, dtype)
    assert not yt.is_contiguous() and not xht.is_contiguous() and not zt.is_contiguous()
    out, vjp = jax.vjp(lambda *a: _jax_gated(*a, 1e-5), *jargs)
    got, rstd = rn.gated_rms_norm_fwd_plain(yt, xht, Dt, zt, st, 1e-5, keep_rstd=True)
    assert _rel(got, out) <= REL[dtype]
    grads = rn.gated_rms_norm_bwd_plain(gt, yt, xht, Dt, zt, st, rstd)
    want = vjp(gj)
    for name, a, w in zip(("dy", "dxh", "dD", "dz", "dscale"), grads, want):
        assert tuple(a.shape) == w.shape, name
        tol = 2e-2 if name == "dD" and dtype == "bfloat16" else REL[dtype]
        assert _rel(a, w) <= tol, (name, _rel(a, w))
    assert grads[0].dtype == yt.dtype and grads[2].dtype == torch.float32


def _conv_inputs(rng, b, s, c, width, dtype, with_state, strided):
    proj = _normal(rng, b, s, c + 9 if strided else c)
    w, bias = _normal(rng, width, c, scale=0.5), _normal(rng, c, scale=0.1)
    state = _normal(rng, b, width - 1, c) if with_state else None
    g = _normal(rng, b, s, c)
    x = torch.from_numpy(proj).to(TORCH[dtype])[..., 3:3 + c] if strided else \
        torch.from_numpy(proj).to(TORCH[dtype])
    xn = proj[..., 3:3 + c] if strided else proj
    t = lambda a: None if a is None else torch.from_numpy(a).to(TORCH[dtype])  # noqa: E731
    j = lambda a: None if a is None else _jf32(a, dtype)  # noqa: E731
    return (x, t(w), t(bias), t(state), t(g)), (j(xn), j(w), j(bias), j(state), j(g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", [(2, 9, 24, 4, True), (1, 2, 7, 4, False), (2, 5, 11, 3, True)])
def test_conv_adjoint_matches_reference_vjp(dtype, with_state, shape):
    b, s, c, width, strided = shape
    rng = np.random.default_rng(2)
    (x, w, bias, state, g), (jx, jw, jb, jst, jg) = _conv_inputs(
        rng, b, s, c, width, dtype, with_state, strided)
    if with_state:
        (out, new_state), vjp = jax.vjp(lambda *a: jax_ssm.causal_conv1d(*a), jx, jw, jb, jst)
        jgrads = vjp((jg, jnp.zeros_like(new_state)))
    else:
        (out, new_state), vjp = jax.vjp(lambda *a: jax_ssm.causal_conv1d(*a), jx, jw, jb)
        jgrads = vjp((jg, jnp.zeros_like(new_state)))
    got, got_state = cc.causal_conv1d_plain(x, w, bias, state)
    assert _rel(got, out) <= REL[dtype]
    np.testing.assert_array_equal(got_state.float().numpy(), np.asarray(new_state, np.float32))
    dx, dw, db, dstate = cc.causal_conv1d_bwd_plain(g, x, w, bias, state, need_dstate=True)
    assert (dstate is None) == (state is None)
    for name, a, want in zip(("dx", "dw", "db", "dstate"), (dx, dw, db, dstate), jgrads):
        assert tuple(a.shape) == want.shape and a.dtype == x.dtype, name
        assert _rel(a, want) <= REL[dtype], (name, _rel(a, want))


# ---------------------------------------------------------------------------
# the Functions against autograd of the plain forwards (f64)
# ---------------------------------------------------------------------------

def _grads(fn, inputs, g):
    inputs = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward([o for o, gg in zip(outs, g) if gg is not None],
                            [gg for gg in g if gg is not None])
    return [o.detach() for o in outs], [None if t is None else t.grad for t in inputs]


def _close(a, b, tol=1e-5):
    assert (a is None) == (b is None)
    if a is not None:
        assert float((a - b).norm() / b.norm().clamp_min(1e-300)) <= tol


@pytest.mark.parametrize("rows_view", ["contiguous", "last_row"])
def test_rms_norm_function_matches_autograd(rows_view):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_normal(rng, 2, 6, 40))
    scale = torch.from_numpy(_normal(rng, 40))
    if rows_view == "last_row":                  # logits' x[:, -1:], rows S·D apart
        x = x[:, -1:]
    g = torch.from_numpy(_normal(rng, *x.shape))
    got, ggot = _grads(lambda a, b: rn.RmsNormFn.apply(a, b, 1e-5), [x, scale], [g])
    want, gwant = _grads(lambda a, b: rn.rms_norm_plain(a, b, 1e-5), [x, scale], [g])
    _close(got[0], want[0])
    for a, b in zip(ggot, gwant):
        _close(a, b)


def test_gated_function_matches_autograd():
    rng = np.random.default_rng(4)
    (yt, xht, Dt, zt, st, gt), _, _ = _gated_inputs(rng, 2, 5, 3, 4, "float32")
    ins = [yt, xht, Dt, zt, st]
    got, ggot = _grads(lambda *a: rn.GatedRmsNormFn.apply(*a, 1e-5), ins, [gt])
    want, gwant = _grads(lambda *a: rn.gated_rms_norm_plain(*a, 1e-5), ins, [gt])
    _close(got[0], want[0])
    for a, b in zip(ggot, gwant):
        _close(a, b)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [9, 2])
def test_conv_function_matches_autograd_with_the_new_states_gradient(with_state, s):
    """Both outputs reach the loss: the new state's gradient goes back to the
    rows of x (and, where S < W-1, of the state) it copies."""
    rng = np.random.default_rng(5)
    (x, w, bias, state, g), _ = _conv_inputs(rng, 2, s, 6, 4, "float32", with_state, True)
    gs = torch.from_numpy(_normal(rng, 2, 3, 6)).double()
    ins = [x.double(), w.double(), bias.double(), None if state is None else state.double()]
    got, ggot = _grads(lambda *a: cc.CausalConv1dFn.apply(*a), ins, [g.double(), gs])
    want, gwant = _grads(lambda *a: cc.causal_conv1d_plain(*a), ins, [g.double(), gs])
    for a, b in zip(got, want):
        _close(a, b, 1e-10)
    for a, b in zip(ggot, gwant):
        _close(a, b, 1e-10)


def test_ops_take_the_functions_under_grad_and_the_eager_chains_on_meta():
    x = torch.randn(2, 3, 8, requires_grad=True)
    scale = torch.ones(8)
    assert type(ops.rms_norm(x, scale).grad_fn).__name__ == "RmsNormFnBackward"
    with torch.no_grad():
        assert torch.equal(ops.rms_norm(x, scale), rn.rms_norm_plain(x, scale))
    meta = ops.rms_norm(x.detach().to("meta").requires_grad_(True), scale.to("meta"))
    assert meta.is_meta and type(meta.grad_fn).__name__ != "RmsNormFnBackward"
    w, b = torch.randn(4, 8, requires_grad=True), torch.zeros(8)
    out, _ = ops.causal_conv1d(x, w, b)
    assert type(out.grad_fn).__name__ == "CausalConv1dFnBackward"


@pytest.mark.parametrize("fn", ["rms_norm", "gated_rms_norm", "causal_conv1d"])
def test_ops_run_dtensors_on_their_shards(fn):
    """A ``DTensor`` (here on the 1×1 CPU mesh) goes to the shard path,
    whose local call takes the Function under grad: the same values and
    gradients as the plain tensors' call. (The 2×2 gloo mesh of
    ``test_torch_moe_mesh.py`` shards them.)"""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import mesh as mesh_mod
    rng = np.random.default_rng(9)
    if fn == "gated_rms_norm":
        args = [torch.from_numpy(_normal(rng, *sh)) for sh in
                ((2, 5, 3, 4), (2, 5, 3, 4), (3,), (2, 5, 12), (12,))]
    elif fn == "rms_norm":
        args = [torch.from_numpy(_normal(rng, 2, 5, 12)), torch.from_numpy(_normal(rng, 12))]
    else:
        args = [torch.from_numpy(_normal(rng, *sh)) for sh in ((2, 6, 8), (4, 8), (8,))]
    mesh = mesh_mod.make_host_mesh("cpu")
    try:
        placed = [DTensor.from_local(a.clone(), mesh, [Replicate()] * 2).requires_grad_(True)
                  for a in args]
        plain = [a.clone().requires_grad_(True) for a in args]
        shard_path = getattr(ops, {"rms_norm": "_norm_on_shards",
                                   "gated_rms_norm": "_gated_on_shards",
                                   "causal_conv1d": "_conv_on_shards"}[fn])
        with mock.patch.object(ops, shard_path.__name__, wraps=shard_path) as spy:
            got = getattr(ops, fn)(*placed)
        want = getattr(ops, fn)(*plain)
        got, want = (got, want) if fn != "causal_conv1d" else (got[0], want[0])
        assert spy.call_count == 1 and isinstance(got, DTensor)
        assert torch.equal(got.to_local(), want)
        g = torch.from_numpy(_normal(rng, *want.shape))
        got.backward(DTensor.from_local(g, mesh, [Replicate()] * 2))
        want.backward(g)
        for a, b in zip(placed, plain):
            _close(a.grad.to_local(), b.grad, 1e-6)
    finally:
        mesh_mod.release()


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def _mixer_layouts(b=2, s=5, h=3, p=8, gn=4, dtype=torch.bfloat16):
    """The layouts ``mamba2_mixer`` hands B4 and B5: the projection's x|B|C
    slice (the convolution's x), y the SSD kernel's (B, H, S, P) buffer
    seen as (B, S, H, P), xh the first H·P columns of the convolution's
    output, z the first H·P columns of the projection."""
    d = h * p
    proj = torch.randn(b, s, 2 * d + 2 * gn + h).to(dtype)
    xbc = proj[..., d:2 * d + 2 * gn]
    conv = (xbc, torch.randn(4, d + 2 * gn).to(dtype), torch.zeros(d + 2 * gn, dtype=dtype))
    y = torch.randn(b, h, s, p).to(dtype).transpose(1, 2)
    xh = torch.randn(b, s, d + 2 * gn).to(dtype)[..., :d].reshape(b, s, h, p)
    gated = (y, xh, torch.randn(h), proj[..., :d], torch.ones(d, dtype=dtype))
    return conv, gated


def test_kernel_checks_take_the_layouts_the_model_hands_over():
    """Every condition of the card's checks holds for the layouts the model
    hands the kernels (evaluated on CPU tensors: they read shapes, dtypes,
    strides and devices only), the logits' last rows included."""
    from repro_torch.kernels.build import require
    conv, gated = _mixer_layouts()
    x = torch.randn(3, 7, 16).bfloat16()
    scale = torch.ones(16, dtype=torch.bfloat16)
    for rows in (x, x[:, -1:]):
        require("rms_norm", rn.norm_checks(rows, scale, rn._row_stride(rows)), rows, scale)
    require("gated", rn.gated_checks(*gated), *gated)
    require("conv", cc.conv_checks(*conv, None), *conv)
    state = torch.zeros(2, 3, conv[0].shape[-1], dtype=torch.bfloat16)
    require("conv", cc.conv_checks(*conv, state), *conv, state)


@pytest.mark.parametrize("case,want", [
    ("rows_transposed", "rows evenly spaced"), ("scale_dtype", "of one dtype"),
    ("scale_width", "scale \\(d,\\)"), ("too_wide", "rows of 1..MAX_WIDTH"),
    ("heads_apart", "heads adjacent"), ("D_bf16", "D \\(H,\\) f32"),
    ("x_channels_strided", "channels contiguous"), ("state_shape", "state \\(B, W-1, C\\)"),
    ("width_5", "width 1..MAX_W")])
def test_kernel_checks_refuse_with_the_failed_condition(case, want):
    """``build.require`` raises for the first failed condition, naming it and
    each input's shape, dtype and strides."""
    from repro_torch.kernels.build import require
    conv, gated = _mixer_layouts()
    x, scale = torch.randn(3, 7, 16).bfloat16(), torch.ones(16, dtype=torch.bfloat16)
    wide = torch.zeros(1, rn.MAX_WIDTH + 8, dtype=torch.bfloat16)
    y, xh, D, z, sc = gated
    cx, w, b = conv
    checks = {
        "rows_transposed": lambda: rn.norm_checks(x.transpose(0, 1), scale,
                                                  rn._row_stride(x.transpose(0, 1))),
        "scale_dtype": lambda: rn.norm_checks(x, scale.float(), rn._row_stride(x)),
        "scale_width": lambda: rn.norm_checks(x, scale[:8], rn._row_stride(x)),
        "too_wide": lambda: rn.norm_checks(wide, torch.ones(rn.MAX_WIDTH + 8,
                                                            dtype=torch.bfloat16), wide.shape[-1]),
        "heads_apart": lambda: rn.gated_checks(y, xh.transpose(1, 2).contiguous().transpose(1, 2),
                                               D, z, sc),
        "D_bf16": lambda: rn.gated_checks(y, xh, D.bfloat16(), z, sc),
        "x_channels_strided": lambda: cc.conv_checks(cx[..., ::2], w[:, ::2].contiguous(),
                                                     b[::2].contiguous(), None),
        "state_shape": lambda: cc.conv_checks(cx, w, b, torch.zeros(2, 2, cx.shape[-1],
                                                                    dtype=torch.bfloat16)),
        "width_5": lambda: cc.conv_checks(cx, torch.zeros(5, cx.shape[-1], dtype=torch.bfloat16),
                                          b, None)}
    with pytest.raises(ValueError, match=f"{case}: want .*{want}.*; got \\("):
        require(case, checks[case](), x)


def test_one_slice_xbc_equals_the_concatenation():
    """``mamba2_mixer`` hands the convolution the x|B|C columns of the
    projection as one slice: the values of the reference's concatenation."""
    d_inner, gn, heads = 16, 6, 4
    proj = torch.randn(2, 5, 2 * d_inner + 2 * gn + heads).bfloat16()
    x = proj[..., d_inner:2 * d_inner]
    bm = proj[..., 2 * d_inner:2 * d_inner + gn]
    cm = proj[..., 2 * d_inner + gn:2 * d_inner + 2 * gn]
    xbc = proj[..., d_inner:2 * d_inner + 2 * gn]
    assert torch.equal(xbc.view(torch.int16), torch.cat([x, bm, cm], dim=-1).view(torch.int16))


def test_gated_plain_is_the_mixers_eager_chain_bit_for_bit():
    """The gated form's plain version is the chain it replaces in
    ``mamba2_mixer``: ``y + xh·D`` in f32, cast, ``·silu(z)``, the norm."""
    rng = np.random.default_rng(6)
    (yt, xht, Dt, zt, st, _), _, _ = _gated_inputs(rng, 2, 7, 4, 8, "bfloat16")
    b, s, h, p = xht.shape
    y = (yt + xht * Dt[None, None, :, None]).reshape(b, s, h * p).to(torch.bfloat16)
    x32 = (y * F.silu(zt)).float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    want = (x32 * torch.rsqrt(var + 1e-5)).to(torch.bfloat16) * st
    got = ops.gated_rms_norm(yt, xht, Dt, zt, st, 1e-5)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_row_strides_and_dense_layouts():
    x = torch.randn(3, 5, 8)
    assert rn._row_stride(x) == 8
    assert rn._row_stride(x[:, -1:]) == 40          # the logits' last rows
    assert rn._row_stride(x[..., :4]) == 8
    assert rn._row_stride(x.transpose(0, 1)) is None
    assert rn._row_stride(x[:, ::2]) is None
    y = torch.randn(2, 3, 5, 4).transpose(1, 2)      # the SSD kernel's (B, H, S, P)
    assert rn._like_strided(y).stride() == y.stride()
    assert rn._like_strided(x[..., :4]).is_contiguous()


@pytest.mark.parametrize("d,esize,vector,tpr", [
    (128, 2, True, 4), (2048, 2, True, 64), (3072, 2, True, 128), (4096, 2, True, 128),
    (16384, 2, True, 512), (16384, 4, True, 512), (77, 4, False, 4), (5, 2, False, 1),
    (16384, 2, False, 512)])
def test_norm_plan(d, esize, vector, tpr):
    """A row's threads hold it at ``ELEMS`` elements each, a power of two;
    ``csrc/rms_norm.cu``'s ``plan_ok`` takes the same."""
    got, block = rn.plan(d, vector, esize)
    assert got == tpr and block == max(rn.ROW_BLOCK, tpr)
    v = 16 // esize if vector else 1
    assert got * (rn.ELEMS // v) >= d // v and (got == 1 or (got // 2) * (rn.ELEMS // v) < d // v)


def test_norm_refuses_rows_wider_than_the_kernel_takes():
    with pytest.raises(ValueError, match="at most"):
        rn.plan(rn.MAX_WIDTH + 8, True, 2)


def test_the_cu_constants_match_the_bindings():
    """``csrc/*.cu``'s layout constants equal the wrappers' own."""
    csrc = Path(rn.__file__).parent / "csrc"
    norm = (csrc / "rms_norm.cu").read_text()
    for name, value in (("ELEMS", rn.ELEMS), ("MAX_TPR", rn.MAX_TPR),
                        ("ROW_BLOCK", rn.ROW_BLOCK)):
        assert f"constexpr int {name} = {value};" in norm, name
    conv = (csrc / "causal_conv1d.cu").read_text()
    for name, value in (("L", cc.L), ("UNITS_X", cc.UNITS_X), ("TILES_Y", cc.TILES_Y),
                        ("MAX_W", cc.MAX_W), ("FWD_SEG", cc.FWD_SEG),
                        ("FWD_WARPS", cc.FWD_TL // cc.FWD_SEG),
                        ("FWD_ROW_BYTES", cc.FWD_CHUNK_BYTES)):
        assert f"constexpr int {name} = {value};" in conv, name


def test_the_adjoints_cu_constants_match_the_bindings():
    """The one-pass norm adjoint's and the staged convolution adjoint's
    layout constants in ``csrc/*.cu`` equal the wrappers' own."""
    csrc = Path(rn.__file__).parent / "csrc"
    norm = (csrc / "rms_norm.cu").read_text()
    for name, value in (("BWD_MAX_TPR", rn.BWD_MAX_TPR), ("BWD_ROW_BLOCK", rn.BWD_ROW_BLOCK)):
        assert f"constexpr int {name} = {value};" in norm, name
    conv = (csrc / "causal_conv1d.cu").read_text()
    for name, value in (("TL", cc.TL), ("SEG", cc.SEG), ("ROW_BYTES", cc.CHUNK_BYTES)):
        assert f"constexpr int {name} = {value};" in conv, name


# B5's staged adjoint on a card of `sms` SMs holding `per_sm` of its blocks:
# (B, S, C, bytes an element), mamba2-1.3b's and jamba's training shapes, a
# ragged S, S < W-1, C off the chunk, f32
CONV_PLANS = [(4, 1024, 4352, 2), (2, 1024, 16640, 2), (2, 100, 72, 2), (3, 2, 40, 4),
              (4, 1024, 4352, 4), (1, 37, 8, 2)]
CARDS = [(132, 4), (132, 3), (1, 1), (7, 2)]


@pytest.mark.parametrize("shape", CONV_PLANS)
@pytest.mark.parametrize("sms,per_sm", CARDS)
def test_conv_plan_is_one_whole_wave_covering_every_tile(shape, sms, per_sm):
    """``plan``'s staged grid is at most the blocks the card holds at once
    (one wave), at least a tile's units each; the blocks' ranges cover every
    (chunk, sequence, segment) unit once, in order, their sizes within one
    of each other; and ``slots`` bounds the blocks any chunk's units meet."""
    b, s, c, es = shape
    grid, slots = cc.plan(b, s, c, es, "vector", sms, per_sm)
    units, per_chunk = cc.staged_units(b, s, c, es)
    assert units == -(-c * es // cc.CHUNK_BYTES) * b * -(-s // cc.SEG)
    assert 1 <= grid <= sms * per_sm and grid <= -(-units // (cc.TL // cc.SEG))
    # each block's units, [g·units//grid, (g+1)·units//grid), as the kernel splits them
    ranges = [(g * units // grid, (g + 1) * units // grid) for g in range(grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(grid - 1))
    sizes = {hi - lo for lo, hi in ranges}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    for chunk in range(units // per_chunk):
        lo, hi = chunk * per_chunk, (chunk + 1) * per_chunk
        meet = sum(1 for r0, r1 in ranges if r0 < hi and r1 > lo)
        assert meet <= slots, (chunk, meet, slots)


# B5's staged forward: (B, S, C, bytes an element): mamba2-1.3b's training
# shape and decode step, jamba's training shape, S < W-1, C off the 512-byte
# chunk, f32, a ragged S
FWD_PLANS = [(4, 1024, 4352, 2), (4, 1, 4352, 2), (4, 1024, 16640, 2), (3, 2, 40, 4),
             (2, 300, 72, 2), (4, 1024, 4352, 4), (1, 37, 8, 2)]


@pytest.mark.parametrize("shape", FWD_PLANS)
@pytest.mark.parametrize("sms,per_sm", CARDS)
def test_conv_fwd_plan_is_one_whole_wave_covering_every_tile(shape, sms, per_sm):
    """``fwd_plan``'s grid is at most the blocks the card holds at once (one
    wave) and at most a block a unit; the blocks' ranges of (chunk,
    sequence, segment) units, as the kernel splits them, cover every unit
    once, in order, each block's within one unit of every other's."""
    b, s, c, es = shape
    grid = cc.fwd_plan(b, s, c, es, sms, per_sm)
    units = cc.fwd_units(b, s, c, es)
    assert units == -(-c * es // cc.FWD_CHUNK_BYTES) * b * -(-s // cc.FWD_SEG)
    assert 1 <= grid <= sms * per_sm and grid <= units
    ranges = [(g * units // grid, (g + 1) * units // grid) for g in range(grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(grid - 1))
    sizes = {hi - lo for lo, hi in ranges}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert grid == min(units, sms * per_sm)         # a block a unit up to a full wave


@pytest.mark.parametrize("layout,want", [
    ((1024, 4352, 2, 8512 * 1024, 8512, 8192), "staged"),          # mamba2's x|B|C slice
    ((1024, 16640, 2, 33280 * 1024, 33280, 32768), "staged"),       # jamba's
    ((1, 4352, 2, 8512, 8512, 8192), "vector"),                    # mamba2's decode step
    ((2, 4352, 2, 8512 * 2, 8512, 8192), "staged"),                # two steps
    ((1024, 4352, 4, 4352 * 1024, 4352, 0), "staged"),             # contiguous f32
    ((300, 72, 2, 72 * 300, 72, 0), "staged"),                     # C off the chunk
    ((70, 4356, 2, 4364 * 70, 4364, 0), "vector"),                 # C 8-byte aligned
    ((70, 4352, 2, 4356 * 70, 4356, 0), "vector"),                 # a row 8-byte aligned
    ((70, 4352, 2, 4360 * 70, 4360, 8), "vector"),                 # x 8 bytes in
    ((70, 4352, 2, 4360 * 70, 4360, 2), "scalar"),                 # x 2 bytes in
    ((9, 77, 2, 77 * 9, 77, 0), "scalar"),                         # C odd
    ((1, 77, 4, 77, 77, 0), "scalar")])
def test_conv_fwd_route_follows_the_layout(layout, want):
    """The forward's route from S, C's bytes, x's strides and the pointers'
    alignment alone: TMA's 16 bytes and more than one step for the staged
    kernel, 8 bytes for the register window's vector units (a decode step's
    route), else a channel at a time."""
    assert cc.fwd_route(*layout) == want


@pytest.mark.parametrize("sms,per_sm", [(132, 4), (132, 2)])
def test_conv_partial_rows_stay_few(sms, per_sm):
    """At mamba2-1.3b's training shape the staged adjoint's f32 partial rows
    of dw and db (slots x (W+1) x C) stay under 1% of the bytes its inputs
    and dx move, at most ten rows a chunk, and every block of the wave has
    work."""
    b, s, c, es = 4, 1024, 4352, 2
    grid, slots = cc.plan(b, s, c, es, "vector", sms, per_sm)
    assert slots * 5 * c * 4 < 0.01 * 3 * b * s * c * es
    assert slots <= 10
    assert grid == sms * per_sm


def test_conv_scalar_plan_stays_within_a_wave_of_its_blocks():
    """The scalar route's register-window kernel: blocks over the tiles
    (grid.y) at most a wave over the channel blocks, one partial row each."""
    grid, slots = cc.plan(4, 1024, 4352, 2, "scalar", 132, 2)
    gx = -(-4352 // cc.UNITS_X)
    assert grid == slots and 1 <= grid and (grid - 1) * gx < 132 * 2


# B4's one-pass adjoint: (d, vector, bytes an element, gated) -> (NU, tpr)
NORM_PLANS = [((128, True, 2, False), (2, 8)), ((2048, True, 2, False), (2, 128)),
              ((3072, True, 2, False), (2, 192)), ((4096, True, 2, True), (1, 512)),
              ((16384, True, 2, True), (2, 1024)), ((16384, True, 4, False), (4, 1024)),
              ((512, True, 4, False), (2, 64)), ((4096, True, 4, True), (1, 1024)),
              ((77, False, 4, False), (16, 8)), ((3076, False, 2, False), (16, 224)),
              ((16384, False, 2, True), (16, 1024))]


@pytest.mark.parametrize("key,want", NORM_PLANS)
def test_norm_bwd_plan(key, want):
    """The one-pass adjoint's threads hold the row at NU units each; tpr a
    power of two up to 32 (a 128-wide row on a quarter-warp), else a
    multiple of 32; the block BWD_ROW_BLOCK // tpr rows below
    BWD_ROW_BLOCK, else one; ``csrc/rms_norm.cu``'s ``bwd_plan_ok`` takes
    the same."""
    d, vector, es, gated = key
    nu, tpr, block = rn.bwd_plan(d, vector, es, gated)
    assert (nu, tpr) == want
    v = 16 // es if vector else 1
    assert tpr * nu * v >= d and tpr <= rn.BWD_MAX_TPR
    assert (tpr & (tpr - 1)) == 0 if tpr <= 32 else tpr % 32 == 0
    assert block == (tpr if tpr >= rn.BWD_ROW_BLOCK else rn.BWD_ROW_BLOCK // tpr * tpr)


@pytest.mark.parametrize("rows,groups", [(4096, 4), (4096, 1), (65536, 64), (163840, 64),
                                         (3, 1), (50, 64)])
@pytest.mark.parametrize("sms,per_sm", CARDS)
def test_norm_bwd_blocks_are_one_whole_wave(rows, groups, sms, per_sm):
    """``bwd_blocks``: at most the blocks the card holds at once, no more than
    the row groups; the blocks' row groups (a grid's worth apart) differ by
    at most one, so the wave ends together."""
    blocks = rn.bwd_blocks(rows, groups, sms, per_sm)
    nrg = -(-rows // groups)
    assert 1 <= blocks <= min(nrg, sms * per_sm)
    per_block = [len(range(g, nrg, blocks)) for g in range(blocks)]
    assert sum(per_block) == nrg and max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("kernel,n", [("rms_norm", 128), ("rms_norm", 2048), ("gated", 64),
                                      ("gated", 256), ("conv", 77), ("conv", 4352)])
def test_the_bf16_adjoint_limit_refuses_bf16_arithmetic(kernel, n):
    """``chip_smoke.norm_adj_tol``'s control (``adjoint_readings``): each plain
    adjoint with its arithmetic narrowed to bf16 (``narrow_adjoints``) lies
    beyond the limit on every output, at the checked sizes and at short
    vectors (a scale of 128, D of 64 heads, 77 channels), while an adjoint
    equal to the plain one passes."""
    torch.manual_seed(n)
    bf = torch.bfloat16
    if kernel == "rms_norm":
        x, g = torch.randn(1024, n).to(bf), torch.randn(1024, n).to(bf)
        scale = (torch.randn(n) * 0.5 + 1).to(bf)
        rstd = rn._rstd_plain(x, 1e-5)
        names, bwd = ("dx", "dscale"), lambda: rn.rms_norm_bwd_plain(g, x, scale, rstd)
    elif kernel == "gated":
        b, s, h, p = 2, 256, n, 16
        y, xh = torch.randn(b, h, s, p).to(bf).transpose(1, 2), torch.randn(b, s, h, p).to(bf)
        D, z = torch.randn(h), torch.randn(b, s, h * p).to(bf)
        scale, g = (torch.randn(h * p) * 0.5 + 1).to(bf), torch.randn(b, s, h * p).to(bf)
        rstd = rn.gated_rms_norm_fwd_plain(y, xh, D, z, scale, 1e-5, keep_rstd=True)[1]
        names = ("dy", "dxh", "dD", "dz", "dscale")
        bwd = lambda: rn.gated_rms_norm_bwd_plain(g, y, xh, D, z, scale, rstd)  # noqa: E731
    else:
        x, g = torch.randn(2, 256, n).to(bf), torch.randn(2, 256, n).to(bf)
        w, b = (torch.randn(4, n) * 0.5).to(bf), (torch.randn(n) * 0.1).to(bf)
        state = torch.randn(2, 3, n).to(bf)
        names = ("dx", "dw", "db", "dstate")
        bwd = lambda: cc.causal_conv1d_bwd_plain(g, x, w, b, state, need_dstate=True)  # noqa: E731
    wants = bwd()
    got = chip_smoke.adjoint_readings(names, wants, wants, "bfloat16", bwd)
    assert got["ok"] and set(got["bf16_control_rel_err"]) == set(names)
    for name in names:
        assert got["adjoint_rel_err"][name] == 0.0
        assert got["bf16_control_rel_err"][name] > got["adjoint_tol"][name], name


def test_norm_adj_tol():
    """1e-5 in f32; in bf16 2e-4, raised to 2^-6/sqrt(n) below 6104 elements."""
    assert chip_smoke.norm_adj_tol("float32", 64) == 1e-5
    assert chip_smoke.norm_adj_tol("bfloat16", 4096 * 2048) == 2e-4
    assert chip_smoke.norm_adj_tol("bfloat16", 128) == pytest.approx(2.0 ** -6 / 128 ** 0.5)
    assert chip_smoke.norm_adj_tol("bfloat16", 6200) == 2e-4


# ---------------------------------------------------------------------------
# the launches chip_smoke.py expects, against the calls a forward makes
# ---------------------------------------------------------------------------

FWD = {"rms_norm_fwd": rn, "gated_rms_norm_fwd": rn, "causal_conv1d_fwd": cc}
BWD = {"rms_norm_bwd": rn, "gated_rms_norm_bwd": rn, "causal_conv1d_bwd": cc}


def _counting(calls):
    """Every B4/B5 wrapper, where ``ops`` and the Functions call it, wrapped
    to count its calls into ``calls``."""
    stack = []
    for name, module in {**FWD, **BWD}.items():
        real = getattr(module, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        stack.append(mock.patch.object(module, name, counted))
        if hasattr(ops, name):
            stack.append(mock.patch.object(ops, name, counted))
    return stack


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b", "olmoe-1b-7b",
                                  "jamba-1.5-large-398b", "whisper-medium",
                                  "llama-3.2-vision-11b", "phi4-mini-3.8b"])
def test_expected_launches_count_every_norm_and_convolution(arch):
    """A prefill and two decode steps, then a train step with remat, on the
    smoke config: each B4/B5 wrapper is called as often as
    ``chip_smoke.expected_launches`` and ``train_launches`` say it
    launches on the card."""
    cfg = get_smoke_config(arch)
    model = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    cross = stub_cross_src(cfg, 2, torch.device("cpu"), getattr(torch, cfg.dtype))
    calls = dict.fromkeys({**FWD, **BWD}, 0)
    patches = _counting(calls)
    for p in patches:
        p.start()
    try:
        with torch.inference_mode():
            logits, caches, n = forward_prefill(model, tokens, 12, cross)
            for _ in range(2):
                logits, caches, n = forward_decode(model, logits.argmax(-1), caches, n)
        want = chip_smoke.expected_launches(cfg, 2)
        assert calls == {k: want[k] for k in calls}
        calls.update(dict.fromkeys(calls, 0))
        model.requires_grad_(True)
        forward_train(model, tokens, cross, remat=True).float().sum().backward()
        want = chip_smoke.train_launches(cfg, 1)
        assert calls == {k: want[k] for k in calls}
    finally:
        for p in patches:
            p.stop()
