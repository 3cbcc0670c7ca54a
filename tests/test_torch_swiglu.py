"""B8 (SwiGLU's gate ``silu(g)·u``) and the split of Mamba2's projection on
the CPU: ``ops.silu_mul``, ``layers.swiglu`` and ``moe.expert_swiglu``
against the reference's ``swiglu`` and ``moe_ffn``'s expert block (with
``jax.vjp``), ``SwigluFn`` against autograd of the eager chain, the meta and
``DTensor`` routes, the kernels' checks and routes, the launches
``chip_smoke.py`` expects of B8 against the calls a prefill, decode steps
and a train step make, and ``mamba2_mixer``'s gradients through
``torch.split`` against the basic slices and the reference's ``jax.grad``.

The same inputs, made from a seed with numpy, go through both frameworks
(weights carried to the port by ``models.convert``). Tolerances:

* f32: the port within 1e-6 relative (L2) of the reference, outputs and
  gradients (the same f32 arithmetic; the products sum in another order);
* bf16: the gate at bf16 g, u and dh against the reference evaluated in
  f32 at the same bf16 values, each element of h, dg and du within 1.5
  bf16 ulps of the f32 value (the port rounds ``silu(g)`` or ``dh·u`` to
  bf16, half an ulp of that factor, at most 2^-8 of the result and so
  under one ulp of it, then the result itself, half an ulp more; one ulp
  alone does not hold: at g ~ N(0, 4) the product reads 1.2 ulps off);
* ``SwigluFn`` against autograd of ``F.silu(g) * u``: bit for bit (its
  plain adjoint is the ops autograd calls);
* the mixer's gradients with the split against the slices: ``torch.equal``
  (one ``cat`` in place of adds into zeros: the same values); against the
  reference's ``jax.grad``: ``test_torch_ssm.py``'s 2e-4.
"""
import contextlib
import re
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import swiglu as sw
from repro_torch.kernels.build import require
from repro_torch.launch.serve import stub_cross_src
from repro_torch.models import (forward_decode, forward_prefill, forward_train, init_params,
                                layers, moe, ssm)
from repro_torch.models.convert import _tensor
from repro_torch.train import cross_entropy_loss

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
SSM_TOL = dict(rtol=2e-4, atol=2e-4)              # test_torch_ssm.py's


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    return float((got.detach().float() - want).norm() / want.norm().clamp_min(1e-30))


def _within_ulps(got: torch.Tensor, want, ulps: float = 1.5) -> bool:
    """Each bf16 element of ``got`` within ``ulps`` bf16 ulps of the f32
    ``want``."""
    w = torch.from_numpy(np.array(want, dtype=np.float32))
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8).clamp_min(2.0 ** -133)
    return bool(((got.detach().float() - w).abs() <= ulps * ulp).all())


def _jax_gate(g, u):
    return jax.nn.silu(g) * u                       # src/repro/models/layers.py:28


def _jax_experts(buf, w_gate, w_up, w_down):
    """The reference's expert block, src/repro/models/moe.py:113-116."""
    g = jnp.einsum("ecd,edf->ecf", buf, w_gate)
    u = jnp.einsum("ecd,edf->ecf", buf, w_up)
    h = jax.nn.silu(g) * u
    return jnp.einsum("ecf,efd->ecd", h, w_down)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 1, 40), (4, 7, 33)])
def test_gate_and_its_adjoint_match_reference_silu_times_up(dtype, shape):
    """``ops.silu_mul`` (``SwigluFn`` on the CPU: the plain forward and
    adjoint) against the reference's ``jax.nn.silu(g) * u`` and its
    ``jax.vjp``, g spread wide (SiLU's tails), an odd width included."""
    rng = np.random.default_rng(sum(shape))
    gn, un, dhn = _normal(rng, *shape, scale=4.0), _normal(rng, *shape), _normal(rng, *shape)
    jg, ju, jdh = (jnp.asarray(a).astype(JNP[dtype]) for a in (gn, un, dhn))
    g, u = (_tensor(a, "cpu").requires_grad_(True) for a in (jg, ju))
    h = ops.silu_mul(g, u)
    assert type(h.grad_fn).__name__ == "SwigluFnBackward"
    h.backward(_tensor(jdh, "cpu"))
    f32 = (jg.astype(jnp.float32), ju.astype(jnp.float32))
    want, vjp = jax.vjp(_jax_gate, *f32)
    dg, du = vjp(jdh.astype(jnp.float32))
    for got, w in ((h, want), (g.grad, dg), (u.grad, du)):
        assert got.dtype == TORCH[dtype]
        if dtype == "float32":
            assert _rel(got, _np(w)) <= 1e-6
        else:
            assert _within_ulps(got, _np(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_reference_and_is_the_eager_chain(dtype):
    """``layers.swiglu`` against the reference's ``swiglu`` and its
    ``jax.vjp`` by x and the three weights (f32: within 1e-6); at either
    dtype equal bit for bit to ``matmul(F.silu(g) * u, w_down)``, the eager
    chain it replaced, forward and every gradient."""
    rng = np.random.default_rng(11)
    d, f = 48, 96
    arrays = [_normal(rng, 2, 6, d), _normal(rng, d, f, scale=d ** -0.5),
              _normal(rng, d, f, scale=d ** -0.5), _normal(rng, f, d, scale=f ** -0.5)]
    jx = [jnp.asarray(a).astype(JNP[dtype]) for a in arrays]
    ts = [_tensor(a, "cpu").requires_grad_(True) for a in jx]
    ref = [t.detach().clone().requires_grad_(True) for t in ts]
    with mock.patch.object(ops, "silu_mul", wraps=ops.silu_mul) as spy:
        out = layers.swiglu(*ts)
    assert spy.call_count == 1
    x, wg, wu, wd = ref
    eager = (F.silu(x @ wg) * (x @ wu)) @ wd
    gout = _normal(rng, 2, 6, d)
    out.backward(torch.from_numpy(gout).to(TORCH[dtype]))
    eager.backward(torch.from_numpy(gout).to(TORCH[dtype]))
    assert torch.equal(out, eager)
    assert all(torch.equal(a.grad, b.grad) for a, b in zip(ts, ref))
    if dtype == "float32":
        want, vjp = jax.vjp(jax_layers.swiglu, *jx)
        grads = vjp(jnp.asarray(gout))
        assert _rel(out, _np(want)) <= 1e-6
        assert all(_rel(t.grad, _np(w)) <= 1e-6 for t, w in zip(ts, grads))


@pytest.mark.parametrize("cast", [False, True])
def test_expert_swiglu_matches_reference_expert_block(cast):
    """``moe.expert_swiglu`` over (E, C, D) against the reference's expert
    block and its ``jax.vjp`` (f32 within 1e-6); with bf16 experts under an
    f32 buffer (the per-expert cast) each expert's gate goes through
    ``ops.silu_mul`` too, equal to the eager chain bit for bit."""
    rng = np.random.default_rng(12)
    e, c, d, f = 4, 5, 32, 24
    arrays = [_normal(rng, e, c, d), _normal(rng, e, d, f, scale=d ** -0.5),
              _normal(rng, e, d, f, scale=d ** -0.5), _normal(rng, e, f, d, scale=f ** -0.5)]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    if cast:
        ts = [ts[0]] + [t.detach().bfloat16() for t in ts[1:]]
    with mock.patch.object(ops, "silu_mul", wraps=ops.silu_mul) as spy:
        out = moe.expert_swiglu(*ts)
    assert spy.call_count == (e if cast else 1)
    gout = _normal(rng, e, c, d)
    out.backward(torch.from_numpy(gout))
    if cast:
        buf = ts[0].detach().clone().requires_grad_(True)
        want = torch.cat([torch.bmm(F.silu(torch.bmm(buf[i:i + 1], ts[1][i:i + 1].float()))
                                    * torch.bmm(buf[i:i + 1], ts[2][i:i + 1].float()),
                                    ts[3][i:i + 1].float()) for i in range(e)])
        want.backward(torch.from_numpy(gout))
        assert torch.equal(out, want) and torch.equal(ts[0].grad, buf.grad)
        return
    want, vjp = jax.vjp(_jax_experts, *(jnp.asarray(a) for a in arrays))
    grads = vjp(jnp.asarray(gout))
    assert _rel(out, _np(want)) <= 1e-6
    assert all(_rel(t.grad, _np(w)) <= 1e-6 for t, w in zip(ts, grads))


def test_moe_ffn_dense_oracle_stays_eager():
    """``moe_ffn_dense``, the MoE layer's oracle, keeps the reference's
    eager gate: it never reaches ``ops.silu_mul``."""
    cfg = get_smoke_config("olmoe-1b-7b")
    model = init_params(cfg, seed=0, device="cpu")
    params = dict(model.blocks[0].moe)
    x = torch.randn(2, 3, cfg.d_model)
    with mock.patch.object(ops, "silu_mul", wraps=ops.silu_mul) as spy:
        moe.moe_ffn_dense(params, x, cfg.num_experts, cfg.experts_per_token)
    assert spy.call_count == 0


# ---------------------------------------------------------------------------
# the Function and the routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_equals_autograd_of_the_eager_chain_bit_for_bit(dtype):
    """``SwigluFn`` (``swiglu_bwd_plain`` on the CPU) against autograd
    through ``F.silu(g) * u``, bit for bit, with a strided output gradient
    and g spread into SiLU's tails."""
    rng = np.random.default_rng(2)
    gn, un = _normal(rng, 3, 9, 40, scale=6.0), _normal(rng, 3, 9, 40)
    g1, u1, g2, u2 = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                      for a in (gn, un, gn, un))
    got = sw.SwigluFn.apply(g1, u1)
    want = F.silu(g2) * u2
    dh = torch.from_numpy(_normal(rng, 40, 9, 3)).to(dtype).transpose(0, 2)
    got.backward(dh)
    want.backward(dh)
    assert torch.equal(got, want) and torch.equal(g1.grad, g2.grad)
    assert torch.equal(u1.grad, u2.grad)
    dg, du = sw.swiglu_bwd_plain(dh, g1.detach(), u1.detach())
    assert torch.equal(dg, g2.grad) and torch.equal(du, u2.grad)
    assert torch.equal(sw.swiglu_fwd(g1.detach(), u1.detach()), want.detach())


def test_routes_by_grad_and_device_kind():
    """Under grad ``SwigluFn``; without, the forward wrapper; meta tensors
    the eager chain (``swiglu_plain``), no Function."""
    g, u = torch.randn(2, 3, 8), torch.randn(2, 3, 8)
    with torch.no_grad(), mock.patch.object(ops, "swiglu_fwd", wraps=ops.swiglu_fwd) as fwd:
        h = ops.silu_mul(g.requires_grad_(True), u)
    assert fwd.call_count == 1 and h.grad_fn is None
    m = torch.empty(2, 5, 24, device="meta", dtype=torch.bfloat16, requires_grad=True)
    with mock.patch.object(ops, "swiglu_plain", wraps=ops.swiglu_plain) as spy:
        hm = ops.silu_mul(m, m)
    assert spy.call_count == 1 and hm.is_meta and hm.shape == m.shape
    assert type(hm.grad_fn).__name__ == "MulBackward0"


def test_gate_runs_dtensors_on_their_shards():
    """``DTensor``s g and u (here on the 1×1 CPU mesh) go to
    ``_silu_on_shards``: the same values and gradients as the plain
    tensors'; a partial sum is reduced before the gate."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.launch import mesh as mesh_mod
    rng = np.random.default_rng(8)
    gn, un = _normal(rng, 2, 5, 16), _normal(rng, 2, 5, 16)
    mesh = mesh_mod.make_host_mesh("cpu")
    try:
        placed = [DTensor.from_local(torch.from_numpy(a), mesh, [Replicate()] * 2)
                  .requires_grad_(True) for a in (gn, un)]
        plain = [torch.from_numpy(a).requires_grad_(True) for a in (gn, un)]
        with mock.patch.object(ops, "_silu_on_shards", wraps=ops._silu_on_shards) as spy:
            got = ops.silu_mul(*placed)
        want = ops.silu_mul(*plain)
        assert spy.call_count == 1 and isinstance(got, DTensor)
        assert torch.equal(got.to_local(), want)
        gh = _normal(rng, 2, 5, 16)
        got.backward(DTensor.from_local(torch.from_numpy(gh), mesh, [Replicate()] * 2))
        want.backward(torch.from_numpy(gh))
        for a, b in zip(placed, plain):
            assert torch.equal(a.grad.to_local(), b.grad)
        partial = DTensor.from_local(torch.from_numpy(gn), mesh, [Partial(), Replicate()])
        out = ops.silu_mul(partial, placed[1].detach())
        assert not any(p.is_partial() for p in out.placements)
        assert torch.equal(out.to_local(), want.detach())
    finally:
        mesh_mod.release()


# ---------------------------------------------------------------------------
# the kernels' checks and routes
# ---------------------------------------------------------------------------

def test_kernel_checks_take_the_layouts_the_model_hands_over():
    """Every condition of the card's checks holds for the model's layouts
    (evaluated on CPU tensors: they read shapes, dtypes, strides and
    devices only): the MLP's products (B, S, F), the experts' (E, C, F),
    a decode step's (B, 1, F), and an output gradient as the products'
    backward gives it."""
    x = torch.randn(2, 6, 32).bfloat16()
    w = torch.randn(32, 80).bfloat16()
    for g in (x @ w, torch.bmm(torch.randn(3, 4, 32).bfloat16(), torch.randn(3, 32, 80).bfloat16()),
              (x @ w)[:, :1]):
        u = g.clone()
        require("swiglu", sw.swiglu_checks(g, u, g.clone()), g, u)


@pytest.mark.parametrize("case,want", [
    ("shape", "one shape"), ("dtype", "one dtype"), ("half", "f32 or bf16"),
    ("last_strided", "last dim contiguous"), ("rows_uneven", "rows evenly spaced"),
    ("dh_dtype", "one dtype")])
def test_kernel_checks_refuse_with_the_failed_condition(case, want):
    g = torch.randn(4, 6, 16)
    u = torch.randn(4, 6, 16)
    args = {"shape": (g, u[:, :, :8]), "dtype": (g, u.double()), "half": (g.half(), u.half()),
            "last_strided": (g, u.transpose(1, 2).contiguous().transpose(1, 2)),
            "rows_uneven": (g, torch.randn(4, 8, 16)[:, :6].transpose(0, 1).contiguous()
                            .transpose(0, 1)),
            "dh_dtype": (g, u, u.bfloat16())}[case]
    with pytest.raises(ValueError, match=want):
        require("swiglu", sw.swiglu_checks(*args), *args)


@pytest.mark.parametrize("dtype,width,layout,route", [
    (torch.bfloat16, 64, "contiguous", "vector"), (torch.float32, 64, "contiguous", "vector"),
    (torch.bfloat16, 1001, "contiguous", "scalar"), (torch.float32, 6, "contiguous", "scalar"),
    (torch.bfloat16, 64, "strided", "vector"), (torch.bfloat16, 64, "unaligned", "scalar"),
    (torch.float32, 12, "strided", "vector")])
def test_plan_routes_by_width_strides_and_pointers(dtype, width, layout, route):
    """``_plan``'s rows, columns, row strides and route: ``vector`` where the
    width is whole 16-byte units and every row stride and pointer is
    16-byte aligned, ``scalar`` otherwise."""
    def one():
        if layout == "contiguous":
            return torch.randn(3, 5, width, dtype=dtype)
        wide = torch.randn(3, 5, width + 16, dtype=dtype)
        return wide[..., :width] if layout == "strided" else wide[..., 1:width + 1]
    g, u = one(), one()
    rows, cols, strides, got, _ = sw._plan("swiglu", (g, u))
    assert (rows, cols) == (15, width) and got == route
    assert strides == [g.stride(1), u.stride(1)]


def test_plan_is_cached_a_layout_but_reads_each_call_s_pointers():
    """The checks and the plan are made once a layout; the route still
    follows each call's pointers (the same shape and strides one element
    off 16-byte alignment take ``scalar``); a layout the checks refuse
    raises whatever was cached before."""
    sw._LAYOUTS.clear()
    wide = torch.randn(3, 5, 80, dtype=torch.bfloat16)
    on, off = wide[..., :64], wide[..., 1:65]
    assert on.stride() == off.stride() and on.data_ptr() % 16 == 0
    with mock.patch.object(sw, "swiglu_checks", wraps=sw.swiglu_checks) as checks:
        assert sw._plan("swiglu", (on, on))[3] == "vector"
        assert sw._plan("swiglu", (off, off))[3] == "scalar"
        assert sw._plan("swiglu", (on, on))[3] == "vector"
    assert checks.call_count == 1 and len(sw._LAYOUTS) == 1
    with pytest.raises(ValueError, match="one dtype"):
        sw._plan("swiglu", (on, on.float()))


def test_the_cu_constants_match_the_bindings():
    src = (CSRC / "swiglu.cu").read_text()
    for name, value in (("THREADS", sw.THREADS), ("NI", sw.NI)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    modes = dict(re.findall(r"(MODE_\w+) = (\d+)", src))
    assert (int(modes["MODE_VECTOR"]), int(modes["MODE_DTYPE"]),
            int(modes["MODE_DEVICE_SHIFT"])) == (sw._MODE_VECTOR, sw._MODE_DTYPE,
                                                 sw._MODE_DEVICE_SHIFT)
    assert "silu_exact" in (CSRC / "common.cuh").read_text()
    assert "float silu_exact" not in (CSRC / "causal_conv1d.cu").read_text()


# ---------------------------------------------------------------------------
# the launches chip_smoke.py expects, against the calls a forward makes
# ---------------------------------------------------------------------------

def _counting(calls):
    """B8's wrappers, where ``ops`` and ``SwigluFn`` call them, wrapped to
    count their calls into ``calls``."""
    stack = []
    for name in chip_smoke.B8:
        real = getattr(sw, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        stack.append(mock.patch.object(sw, name, counted))
        if hasattr(ops, name):
            stack.append(mock.patch.object(ops, name, counted))
    return stack


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b", "olmoe-1b-7b", "kimi-k2-1t-a32b",
                                  "jamba-1.5-large-398b", "whisper-medium",
                                  "llama-3.2-vision-11b", "phi4-mini-3.8b"])
def test_expected_launches_count_every_gate(arch):
    """A prefill and two decode steps, then a train step with remat, on the
    smoke config: each B8 wrapper is called as often as
    ``chip_smoke.expected_launches`` and ``train_launches`` say it launches
    on the card (once an MLP or MoE layer a prefill and a decode step, an
    encoder's layers too; in training twice a layer and one adjoint)."""
    cfg = get_smoke_config(arch)
    model = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    cross = stub_cross_src(cfg, 2, torch.device("cpu"), getattr(torch, cfg.dtype))
    calls = dict.fromkeys(chip_smoke.B8, 0)
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
        assert calls["swiglu_fwd"] > 0 or arch == "mamba2-1.3b"
        calls.update(dict.fromkeys(calls, 0))
        model.requires_grad_(True)
        labels = torch.roll(tokens, -1, dims=1)
        cross_entropy_loss(forward_train(model, tokens, cross, remat=True), labels).backward()
        want = chip_smoke.train_launches(cfg, 1)
        assert calls == {k: want[k] for k in calls}
    finally:
        for p in patches:
            p.stop()


# ---------------------------------------------------------------------------
# Mamba2's projection split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    cfg = get_smoke_config("mamba2-1.3b")
    jcfg = jax_smoke_config("mamba2-1.3b")
    jparams = jax_ssm.init_mamba2(jax.random.PRNGKey(0), jcfg.d_model, jcfg.d_inner,
                                  jcfg.ssm_state, jcfg.ssm_heads, jcfg.ssm_groups,
                                  jcfg.ssm_conv_width)
    return cfg, jcfg, jparams


def _slices_proj(proj, d_inner, gn, heads):
    """The cut before the split: basic slices, x|B|C as one."""
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * gn],
            proj[..., 2 * d_inner + 2 * gn:])


def _slices_xbc(xbc, d_inner, gn):
    return xbc[..., :d_inner], xbc[..., d_inner:d_inner + gn], xbc[..., d_inner + gn:]


class _Ops(TorchDispatchMode):
    """The aten ops run while ``on``: those of the cuts' backward nodes."""

    def __init__(self):
        super().__init__()
        self.on, self.seen = False, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.on:
            self.seen.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _mixer_grads(cfg, jparams, x, gout, cuts=(None, None)):
    """The mixer's output, the gradients of xin, every parameter and
    ``proj`` (the in_proj product), with the cuts swapped in where given,
    and the aten ops that the cuts' backward nodes ran."""
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jparams.items()}
    xin = torch.from_numpy(x).requires_grad_(True)
    kept, mode = {}, _Ops()
    real_matmul = ssm.matmul

    def matmul(a, w):
        out = real_matmul(a, w)
        if w is params["in_proj"]:
            out.retain_grad()
            kept["proj"] = out
        return out

    def watched(cut):
        def run(*a):
            parts = cut(*a)
            for node in {t.grad_fn for t in parts}:
                node.register_prehook(lambda *_: setattr(mode, "on", True))
                node.register_hook(lambda *_: setattr(mode, "on", False))
            return parts
        return run
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(ssm, "matmul", matmul))
        for name, cut in zip(("_cut_proj", "_cut_xbc"), cuts):
            stack.enter_context(mock.patch.object(ssm, name, watched(cut or getattr(ssm, name))))
        out = ssm.mamba2_mixer(params, xin, cfg)
    with mode:
        out.backward(torch.from_numpy(gout))
    grads = {"xin": xin.grad, "proj": kept["proj"].grad,
             **{k: p.grad for k, p in params.items()}}
    return out.detach(), grads, mode.seen


@pytest.mark.parametrize("s", [16, 12])
def test_mixer_gradients_through_the_split_equal_the_slices(mamba, s):
    """``mamba2_mixer``'s gradients with ``torch.split`` (the mixer as it
    is) equal those through the basic slices bit for bit (proj's, in_proj's,
    conv_w's and every other), the output too; the split's backward is one
    ``cat`` a cut and nothing else (the slices' backward nodes fill zero
    tensors as wide as what they cut, which autograd then adds)."""
    cfg, _, jparams = mamba
    rng = np.random.default_rng(s)
    x = _normal(rng, 2, s, cfg.d_model)
    gout = _normal(rng, 2, s, cfg.d_model)
    out, grads, seen = _mixer_grads(cfg, jparams, x, gout)
    out_s, grads_s, seen_s = _mixer_grads(cfg, jparams, x, gout, (_slices_proj, _slices_xbc))
    assert torch.equal(out, out_s)
    assert set(grads) == set(grads_s)
    for k in grads:
        assert torch.equal(grads[k], grads_s[k]), k
    assert seen == ["cat", "cat"]
    assert seen_s and "cat" not in seen_s


def test_mixer_cuts_are_one_split_on_plain_tensors_and_slices_on_meta(mamba):
    cfg, _, _ = mamba
    gn = cfg.ssm_groups * cfg.ssm_state
    width = 2 * cfg.d_inner + 2 * gn + cfg.ssm_heads
    proj = torch.randn(2, 4, width, requires_grad=True)
    z, xbc, dt = ssm._cut_proj(proj * 1, cfg.d_inner, gn, cfg.ssm_heads)
    assert type(z.grad_fn).__name__ == "SplitWithSizesBackward0"
    assert (z.shape[-1], xbc.shape[-1], dt.shape[-1]) == (cfg.d_inner, cfg.d_inner + 2 * gn,
                                                          cfg.ssm_heads)
    assert xbc.stride()[:-1] == proj.stride()[:-1]        # B5 still reads it in place
    parts = ssm._cut_xbc(xbc * 1, cfg.d_inner, gn)
    assert [p.shape[-1] for p in parts] == [cfg.d_inner, gn, gn]
    meta = torch.empty(2, 4, width, device="meta", requires_grad=True) * 1
    mz, mxbc, mdt = ssm._cut_proj(meta, cfg.d_inner, gn, cfg.ssm_heads)
    assert type(mz.grad_fn).__name__ == "SliceBackward0" and mxbc.is_meta
    assert type(ssm._cut_xbc(mxbc, cfg.d_inner, gn)[0].grad_fn).__name__ == "SliceBackward0"


def test_mixer_gradients_match_reference_grad(mamba):
    """``jax.grad`` of the reference's mixer (summed against a fixed output
    gradient) by xin and every parameter, against the port's through the
    split, within ``test_torch_ssm.py``'s tolerance."""
    cfg, jcfg, jparams = mamba
    rng = np.random.default_rng(3)
    x, gout = _normal(rng, 2, 16, cfg.d_model), _normal(rng, 2, 16, cfg.d_model)
    _, grads, _ = _mixer_grads(cfg, jparams, x, gout)

    def loss(params, xin):
        return jnp.sum(jax_ssm.mamba2_mixer(params, xin, jcfg) * gout)
    jgrads, jx = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    np.testing.assert_allclose(grads["xin"].numpy(), np.asarray(jx), **SSM_TOL)
    for k, v in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(v), **SSM_TOL, err_msg=k)
