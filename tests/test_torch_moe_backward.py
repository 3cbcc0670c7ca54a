"""B2's backward on the CPU: the plain adjoints of the MoE layer's fill and
combine (``moe_fill_bwd_plain``, ``moe_combine_bwd_plain``), the autograd
Functions around them (``MoeFillFn``, ``MoeCombineFn``), and the port's MoE
gradients through those Functions against ``jax.grad`` of the reference.

Tolerances:

* the plain adjoints against autograd of the plain forwards on the same
  table: y's gradient bit for bit (one product a slot, rounded as autograd
  rounds it); the rows' and the gates' gradients differ only by the order
  of their f32 sums: within 1e-6 of the largest in f32, and within one
  bf16 ulp (2^-7 relative) in bf16, where each is rounded once;
* ``torch.autograd.gradcheck`` of both Functions in f64, at its defaults;
* ``moe_ffn``'s gradients against ``jax.grad`` of the reference's
  ``moe_ffn`` (f32, the same numpy weights): 1e-5 of each gradient's
  largest entry, ``test_torch_moe.py``'s tolerance of the values;
* ``forward_train`` of the MoE smoke configs against ``jax.grad``: 1e-4 of
  each leaf's largest entry, ``test_torch_forward_train.py``'s.

The reference runs in f32 on the CPU as its own tests run it.
"""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _families import make_pair
from test_torch_forward_train import _jax_loss_and_grads, port_loss_and_grads

from repro.models import moe as jax_moe
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ops
from repro_torch.models import forward_train, moe, params_from_jax
from repro_torch.models.config import ATTN_MOE, SSM_MOE
from repro_torch.models.transformer import layer_kinds
from repro_torch.train import cross_entropy_loss

CSRC = Path(md.__file__).resolve().parent / "csrc" / "moe_dispatch.cu"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (tokens, k, experts, d, capacity factor, an expert left without tokens)
CASES = {
    "default": (16, 2, 8, 32, 1.25, False),
    "drops": (24, 2, 8, 32, 0.5, False),
    "capacity_1": (4, 8, 64, 16, 1.25, False),      # olmoe-like decode: C = 1
    "k1_empty_expert": (12, 1, 4, 24, 1.0, True),
    "k8_empty_expert": (32, 8, 16, 40, 1.25, True),
    "k8_drops": (48, 8, 16, 24, 0.5, False),
    "odd_width": (10, 3, 6, 13, 1.0, False),
}
MOE_ARCHS = ("olmoe-1b-7b", "jamba-1.5-large-398b", "kimi-k2-1t-a32b")


def _setup(case, seed=0):
    """The case's (a name of ``CASES`` or its tuple) route table and numpy
    draws: expert ids k distinct a token (expert 0 never where the case
    leaves it empty), normalised gates."""
    t, k, e, d, cf, empty = CASES[case] if isinstance(case, str) else case
    rng = np.random.default_rng(seed)
    lo = 1 if empty else 0
    idx = np.stack([lo + rng.permutation(e - lo)[:k] for _ in range(t)]).astype(np.int64)
    g = rng.random((t, k)).astype(np.float32) + 0.05
    gates = torch.from_numpy((g / g.sum(axis=1, keepdims=True)).astype(np.float32))
    cap = moe.capacity(t, k, e, cf)
    plan = moe.dispatch_plan(torch.from_numpy(idx), e, cap)
    return t, k, e, d, cap, moe.route_table(plan, gates, cap), rng


def _randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _order_close(got, want, dtype):
    """Equal but for the order of an f32 sum (the module docstring)."""
    if dtype == torch.float32:
        scale = max(float(want.abs().max()), 1e-30)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * scale)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_backwards_match_autograd_of_the_plain_forwards(case, dtype):
    tdt = DTYPES[dtype]
    t, k, e, d, cap, routes, rng = _setup(case)
    rows = _randn(rng, (t, d), tdt).requires_grad_(True)
    grad_buf = _randn(rng, (e, cap, d), tdt)
    md.moe_fill_plain(rows, routes.dest, routes.kept, cap).backward(grad_buf)
    dx = md.moe_fill_bwd_plain(grad_buf, routes.dest)
    assert dx.dtype == tdt and dx.shape == (t, d)
    _order_close(dx, rows.grad, tdt)

    y = _randn(rng, (e, cap, d), tdt).requires_grad_(True)
    gate = routes.gate.clone().requires_grad_(True)
    grad_out = _randn(rng, (t, d), tdt)
    md.moe_combine_plain(y, routes.dest, gate).backward(grad_out)
    dy, dgate = md.moe_combine_bwd_plain(grad_out, y.detach(), routes.dest, routes.gate)
    assert dy.dtype == tdt and dgate.dtype == torch.float32
    assert torch.equal(dy, y.grad)
    _order_close(dgate, gate.grad, tdt)
    dropped = routes.dest < 0
    assert torch.equal(dgate[dropped], torch.zeros_like(dgate[dropped]))
    # the slots no kept route reaches take zeros
    reached = torch.zeros(e * cap, dtype=torch.bool)
    reached[routes.dest[~dropped].long()] = True
    assert not dy.reshape(e * cap, d)[~reached].any()


def test_the_fill_adjoint_adds_in_ascending_expert_id():
    """Three f32 rows whose sum depends on the order: the adjoint adds token
    0's slots by expert id, not by route."""
    cap, d = 1, 1
    dest = torch.tensor([[2, 0, 1]], dtype=torch.int32)        # experts 2, 0, 1
    grad_buf = torch.tensor([1e8, 1.0, -1e8]).reshape(3, cap, d)
    by_expert = (torch.tensor(1e8) + torch.tensor(1.0)) + torch.tensor(-1e8)
    by_route = (torch.tensor(-1e8) + torch.tensor(1e8)) + torch.tensor(1.0)
    assert float(by_expert) != float(by_route)
    assert float(md.moe_fill_bwd_plain(grad_buf, dest)) == float(by_expert)


# small enough for gradcheck's numerical Jacobian: drops, an expert
# without tokens, capacity 1
GRADCHECK_CASES = {"drops": (8, 2, 4, 5, 0.5, False), "empty_expert": (6, 3, 6, 4, 1.25, True),
                   "capacity_1": (3, 4, 16, 3, 1.25, False)}


@pytest.mark.parametrize("case", GRADCHECK_CASES)
def test_functions_pass_gradcheck_in_f64(case):
    t, k, e, d, cap, routes, rng = _setup(GRADCHECK_CASES[case])
    dest, kept = routes.dest, routes.kept
    rows = _randn(rng, (t, d), torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda r: md.MoeFillFn.apply(r, dest, kept, cap), (rows,))
    y = _randn(rng, (e, cap, d), torch.float64).requires_grad_(True)
    gate = routes.gate.double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda y_, g_: md.MoeCombineFn.apply(y_, dest, g_, kept, 0), (y, gate))


def _counted_backwards(monkeypatch):
    """Counts each Function's backward calls."""
    calls = {"fill": 0, "combine": 0}
    for name, fn in (("fill", md.MoeFillFn), ("combine", md.MoeCombineFn)):
        backward = fn.backward

        def counted(ctx, *g, name=name, backward=backward):
            calls[name] += 1
            return backward(ctx, *g)
        monkeypatch.setattr(fn, "backward", staticmethod(counted))
    return calls


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_gradients_match_jax_grad(cf, monkeypatch):
    """x, the router and the three expert tensors through ``MoeFillFn`` and
    ``MoeCombineFn`` against ``jax.grad`` of the reference's ``moe_ffn``
    on the same weights, with and without capacity drops."""
    b, s, d, e, k, ff = 2, 24, 32, 8, 2, 48
    jp = jax_moe.init_moe(jax.random.PRNGKey(3), d, e, ff, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((b, s, d)).astype(np.float32)
    names = ("router", "w_gate", "w_up", "w_down")

    def jloss(xj, pj):
        return jnp.sum(jax_moe.moe_ffn(pj, xj, e, k, cf) * w)
    want_x, want_p = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)

    calls = _counted_backwards(monkeypatch)
    params = {n: torch.from_numpy(np.asarray(jp[n]).copy()).requires_grad_(True) for n in names}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = moe.moe_ffn(params, xt, e, k, cf)
    (out * torch.from_numpy(w)).sum().backward()
    assert calls == {"fill": 1, "combine": 1}
    _, idx, _ = moe.router_topk(xt.detach().reshape(-1, d), params["router"].detach(), k)
    plan = moe.dispatch_plan(idx, e, moe.capacity(b * s, k, e, cf))
    assert int((~plan.keep).sum()) > 0 if cf < 1 else True
    for got, want in [(xt.grad, want_x)] + [(params[n].grad, want_p[n]) for n in names]:
        want = np.asarray(want)
        assert got is not None and np.all(np.isfinite(got.numpy()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(float(np.abs(want).max()), 1e-8))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_train_takes_the_functions(arch, monkeypatch):
    """``forward_train`` (remat on) of the MoE smoke configs: the loss and
    every gradient through ``MoeFillFn`` and ``MoeCombineFn``, each
    backward counted once an MoE layer, against ``jax.grad``."""
    cfg, jcfg, jparams, _, tokens, cross = make_pair(arch)
    tokens = tokens[:, :16]
    calls = _counted_backwards(monkeypatch)
    want_loss, want = _jax_loss_and_grads(jcfg, jparams, jnp.asarray(tokens),
                                          None if cross is None else jnp.asarray(cross))
    got_loss, got = port_loss_and_grads(cfg, jax.tree.map(np.asarray, jparams), tokens, cross,
                                        remat=True)
    n_moe = sum(kind in (ATTN_MOE, SSM_MOE) for kind in layer_kinds(cfg))
    assert n_moe > 0 and calls == {"fill": n_moe, "combine": n_moe}
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(float(np.abs(w).max()), 1e-8))


def test_remat_rebuilds_the_same_route_table(monkeypatch):
    """With remat, each MoE layer's table is made in the forward and again
    in the backward's recomputation: the same dest, gates and kept counts."""
    cfg, _, jparams, _, tokens, _ = make_pair("olmoe-1b-7b")
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    model.requires_grad_(True)
    tables = []
    route_table = moe.route_table
    monkeypatch.setattr(moe, "route_table",
                        lambda *a, **kw: tables.append(route_table(*a, **kw)) or tables[-1])
    tok = torch.from_numpy(tokens[:, :16]).long()
    loss = cross_entropy_loss(forward_train(model, tok, None, remat=True),
                              torch.roll(tok, -1, dims=1))
    n = len(tables)
    assert n == cfg.num_layers
    loss.backward()
    assert len(tables) == 2 * n
    # the backward recomputes the repetitions last to first
    for made, again in zip(tables[:n], reversed(tables[n:])):
        assert torch.equal(made.dest, again.dest) and torch.equal(made.kept, again.kept)
        assert torch.equal(made.gate, again.gate)


def test_entry_points_take_the_functions_under_grad_only():
    t, k, e, d, cap, routes, rng = _setup("drops")
    rows = _randn(rng, (t, d), torch.float32)
    y = _randn(rng, (e, cap, d), torch.float32)
    assert ops.fill_expert_slots(rows, routes.dest, routes.kept, cap).grad_fn is None
    buf = ops.fill_expert_slots(rows.requires_grad_(True), routes.dest, routes.kept, cap)
    assert type(buf.grad_fn).__name__ == "MoeFillFnBackward"
    with torch.no_grad():
        assert ops.fill_expert_slots(rows, routes.dest, routes.kept, cap).grad_fn is None
    with pytest.raises(ValueError, match="needs kept"):
        ops.combine_expert_rows(y.requires_grad_(True), routes.dest, routes.gate)
    out = ops.combine_expert_rows(y, routes.dest, routes.gate, kept=routes.kept)
    assert type(out.grad_fn).__name__ == "MoeCombineFnBackward"
    gate = routes.gate.clone().requires_grad_(True)
    out = ops.combine_expert_rows(y.detach(), routes.dest, gate, kept=routes.kept)
    assert type(out.grad_fn).__name__ == "MoeCombineFnBackward"
    out.sum().backward()
    assert gate.grad is not None and y.grad is None


def test_meta_tensors_keep_the_plain_forward():
    """The dry run: meta tensors under grad go through the plain forwards,
    which autograd differentiates, as before the Functions."""
    t, k, e, d, cap = 64, 8, 16, 24, 40
    meta = dict(device="meta")
    rows = torch.empty((t, d), dtype=torch.bfloat16, **meta).requires_grad_(True)
    dest = torch.empty((t, k), dtype=torch.int32, **meta)
    kept = torch.empty((e,), dtype=torch.int32, **meta)
    buf = ops.fill_expert_slots(rows, dest, kept, cap)
    assert buf.is_meta and "MoeFillFn" not in type(buf.grad_fn).__name__
    y = torch.empty((e, cap, d), dtype=torch.bfloat16, **meta).requires_grad_(True)
    out = ops.combine_expert_rows(y, dest, torch.empty((t, k), **meta), kept=kept)
    assert out.is_meta and "MoeCombineFn" not in type(out.grad_fn).__name__


def test_cpu_backward_wrappers_are_the_plain_versions_and_launch_nothing():
    t, k, e, d, cap, routes, rng = _setup("k8_drops")
    grad_buf = _randn(rng, (e, cap, d), torch.bfloat16)
    grad_out = _randn(rng, (t, d), torch.bfloat16)
    y = _randn(rng, (e, cap, d), torch.bfloat16)
    counters = (md.moe_fill_bwd, md.moe_combine_bwd)
    before = [(c.launches, dict(c.launches_by_route)) for c in counters]
    assert torch.equal(md.moe_fill_bwd(grad_buf, routes.dest),
                       md.moe_fill_bwd_plain(grad_buf, routes.dest))
    got = md.moe_combine_bwd(grad_out, y, routes.dest, routes.gate, routes.kept)
    want = md.moe_combine_bwd_plain(grad_out, y, routes.dest, routes.gate)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [(c.launches, dict(c.launches_by_route)) for c in counters] == before
    assert all(set(c.launches_by_route) == set(md.ROUTES) for c in counters)


def test_backward_refusals_before_any_launch():
    dest = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"grad_buf \(E, C, D\)"):
        md.moe_fill_bwd(torch.zeros(6, 4), dest)
    y = torch.zeros(2, 3, 4)
    kept = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"grad_out \(T, D\)"):
        md.moe_combine_bwd(torch.zeros(5, 5), y, dest, torch.zeros(5, 2), kept)
    with pytest.raises(ValueError, match=r"kept \(E,\)"):
        md.moe_combine_bwd(torch.zeros(5, 4), y, dest, torch.zeros(5, 2), kept[:1])


def _c_params(text, name):
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text).group(1)
    return [p.strip() for p in sig.split(",")]


@pytest.mark.parametrize("name,argtypes", [("moe_fill_bwd", "_FILL_BWD_ARGTYPES"),
                                           ("moe_combine_bwd", "_COMBINE_BWD_ARGTYPES")])
def test_cu_adjoints_match_the_binding(name, argtypes):
    """The adjoints' C signatures against the ctypes argtypes: a pointer
    where the binding passes one, a 64-bit int where it passes one."""
    params = _c_params(CSRC.read_text(), name)
    argtypes = getattr(md, argtypes)
    assert len(params) == len(argtypes)
    for p, a in zip(params, argtypes):
        assert ("*" in p, "long long" in p) == (a is md._P, a is md._LL), (name, p, a)


def test_ops_has_no_refusal_for_b2_under_grad():
    """A CUDA input that requires a gradient is no longer refused by the
    MoE entry points (only K1's keeps ``_no_cuda_grad``)."""
    src = Path(importlib.import_module("repro_torch.kernels.ops").__file__).read_text()
    calls = re.findall(r'_no_cuda_grad\("(\w+)"', src)
    assert calls == ["quantize_rows"]
