"""B2, the MoE layer's dispatch and combine (``repro_torch.kernels.moe_dispatch``),
on the CPU, against the JAX package's own expressions.

The same plan and numpy inputs go through both:

* the plain fill against the reference's buffer, ``jnp.zeros((E, C+1,
  D)).at[sorted_expert, slot].set(x[sorted_token])[:, :C]``, exactly;
* the plain combine against the reference's ``ypad[sorted_expert, slot] *
  gate``, ``where(keep, …)`` and ``zeros.at[sorted_token].add(…)``: exactly
  in f32, and in bf16 within ``test_torch_moe.py``'s bf16 tolerance (XLA's
  scatter-add starts from a zero row and may keep its own precision);
* the combine kernel's arithmetic, written in torch over what it reads
  (the plan and its inverse permutation, ``inverse_order``), against the
  plain combine bit for bit;
* ``moe_ffn`` through the new ops against the indexing it had before them,
  bit for bit, values and gradients.

Cases: drops, capacity 1 (decode), an expert with no tokens, k = 1 and 8,
a width that is no whole number of 16-byte vectors.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ops
from repro_torch.models import moe

CSRC = Path(md.__file__).resolve().parent / "csrc" / "moe_dispatch.cu"
BF16_TOL = dict(rtol=2e-2, atol=2e-2)       # test_torch_moe.py's bf16 tolerance
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}

# (tokens, k, experts, d, capacity factor, an expert left without tokens)
CASES = {
    "default": (16, 2, 8, 32, 1.25, False),
    "drops": (24, 2, 8, 32, 0.5, False),
    "capacity_1": (4, 8, 64, 16, 1.25, False),      # olmoe-like decode: C = 1
    "k1_empty_expert": (12, 1, 4, 24, 1.0, True),
    "k8_empty_expert": (32, 8, 16, 40, 1.25, True),
    "odd_width": (10, 3, 6, 13, 1.0, False),
}


def _routing(t, k, e, empty, seed):
    """Expert ids (T, k), k distinct a token (expert 0 never where ``empty``),
    and gates (T, k) normalised as ``router_topk`` normalises them."""
    rng = np.random.default_rng(seed)
    lo = 1 if empty else 0
    idx = np.stack([lo + rng.permutation(e - lo)[:k] for _ in range(t)])
    g = rng.random((t, k)).astype(np.float32) + 0.05
    return idx.astype(np.int64), (g / g.sum(axis=1, keepdims=True)).astype(np.float32)


def _setup(case, seed=0):
    t, k, e, d, cf, empty = CASES[case]
    idx, gates = _routing(t, k, e, empty, seed)
    cap = moe.capacity(t, k, e, cf)
    plan = moe.dispatch_plan(torch.from_numpy(idx), e, cap)
    return t, k, e, d, cap, idx, gates, plan


def _bits(a):
    """A torch or JAX array's bits as numpy (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16).astype(np.int16) if a.dtype.name == "bfloat16" else a


def _jax_fill(x, plan, e, cap, jdt):
    """The reference's buffer (``repro.models.moe.moe_ffn``, :108-110)."""
    buf = jnp.zeros((e, cap + 1, x.shape[1]), jdt)
    buf = buf.at[plan.expert.numpy(), plan.slot.numpy()].set(
        jnp.asarray(x).astype(jdt)[plan.token.numpy()])
    return buf[:, :cap]


def _jax_combine(y, plan, gates, t, jdt):
    """The reference's combine (:121-124)."""
    e, _, d = y.shape
    yj = jnp.asarray(y).astype(jdt)
    ypad = jnp.concatenate([yj, jnp.zeros((e, 1, d), jdt)], axis=1)
    sorted_gate = jnp.asarray(gates.reshape(-1)[plan.order.numpy()])
    contrib = ypad[plan.expert.numpy(), plan.slot.numpy()] * sorted_gate[:, None].astype(jdt)
    contrib = jnp.where(plan.keep.numpy()[:, None], contrib, jnp.zeros((), jdt))
    return jnp.zeros((t, d), jdt).at[plan.token.numpy()].add(contrib)


def _kernel_in_torch(y, expert, slot, gate, keep, order, k):
    """The combine kernel's arithmetic over what it reads: each token's k
    sorted positions from the inverse permutation, put in ascending order
    (as a warp ranks them), the plan's entries at them; then, in that order,
    the product rounded to y's dtype (+0.0 where dropped), the first term as
    it is and every later one by a rounded sum."""
    cap = y.shape[1]
    flat = y.reshape(-1, y.shape[2])
    pos = md.inverse_order(order).view(-1, k).sort(dim=1).values
    out = None
    for j in range(k):
        p = pos[:, j]
        row = torch.where(keep[p], expert[p] * cap + slot[p], torch.zeros_like(p))
        prod = flat[row] * gate[p][:, None].to(y.dtype)
        term = torch.where(keep[p][:, None], prod, torch.zeros((), dtype=y.dtype))
        out = term if out is None else out + term
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_fill_is_the_reference_buffer(case, dtype):
    t, k, e, d, cap, idx, gates, plan = _setup(case)
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(1).standard_normal((t, d)).astype(np.float32)
    src = moe.slot_sources(plan, e, cap, t)
    assert src.dtype == torch.int32 and src.is_contiguous() and tuple(src.shape) == (e, cap)
    got = md.moe_fill_plain(torch.from_numpy(x).to(tdt), src, t)
    want = _jax_fill(x, plan, e, cap, jdt)
    assert got.is_contiguous() and tuple(got.shape) == (e, cap, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if CASES[case][5]:
        assert not got[0].any()                              # the expert without tokens
    assert int((src != t).sum()) == int(plan.keep.sum())     # one slot a kept assignment


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_combine_is_the_reference_scatter_add(case, dtype):
    t, k, e, d, cap, idx, gates, plan = _setup(case)
    tdt, jdt = DTYPES[dtype]
    y = np.random.default_rng(2).standard_normal((e, cap, d)).astype(np.float32)
    sorted_gate = torch.from_numpy(gates).reshape(-1)[plan.order]
    got = md.moe_combine_plain(torch.from_numpy(y).to(tdt), plan.expert, plan.slot, sorted_gate,
                               plan.keep, plan.order, k)
    want = _jax_combine(y, plan, gates, t, jdt)
    assert tuple(got.shape) == (t, d) and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                                   **BF16_TOL)
    if case == "drops":
        assert int((~plan.keep).sum()) > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_kernel_arithmetic_over_the_plan_is_the_plain_combine(case, dtype):
    """What the combine kernel computes from the plan and its inverse
    permutation equals the plain combine bit for bit (signs of zero
    included); each token's sorted positions rise with its expert ids."""
    t, k, e, d, cap, idx, gates, plan = _setup(case, seed=3)
    tdt, _ = DTYPES[dtype]
    y = torch.from_numpy(np.random.default_rng(4).standard_normal((e, cap, d))
                         .astype(np.float32)).to(tdt)
    y[:, :, 0] = -0.0                        # a column whose sums are signed zeros
    sorted_gate = torch.from_numpy(gates).reshape(-1)[plan.order]
    inverse = md.inverse_order(plan.order)
    assert torch.equal(plan.order[inverse], torch.arange(t * k))
    pos = inverse.view(t, k).sort(dim=1).values
    assert torch.equal(plan.expert[pos], torch.from_numpy(np.sort(idx, axis=1)))
    args = (plan.expert, plan.slot, sorted_gate, plan.keep, plan.order, k)
    got = _kernel_in_torch(y, *args)
    want = md.moe_combine_plain(y, *args)
    assert torch.equal(_bits_t(got), _bits_t(want))


def _bits_t(a):
    return a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)


def test_a_dropped_assignment_still_takes_part_in_the_sum():
    """Where a token's kept products are -0.0, the sum is -0.0 with every
    assignment kept and +0.0 once a dropped one (+0.0) joins it."""
    y = torch.full((2, 1, 4), -0.0)
    expert = torch.tensor([0, 1])
    order = torch.tensor([0, 1])
    gate = torch.tensor([0.5, 0.5])
    both = md.moe_combine_plain(y, expert, torch.tensor([0, 0]), gate, torch.tensor([True, True]),
                                order, 2)
    dropped = (expert, torch.tensor([0, 1]), gate, torch.tensor([True, False]), order, 2)
    one = md.moe_combine_plain(y, *dropped)
    assert torch.signbit(both).all() and not torch.signbit(one).any()
    assert torch.equal(_bits_t(_kernel_in_torch(y, *dropped)), _bits_t(one))


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    t, k, e, d, cap, idx, gates, plan = _setup("drops")
    x = torch.randn(t, d, dtype=torch.bfloat16)
    src = moe.slot_sources(plan, e, cap, t)
    y = torch.randn(e, cap, d, dtype=torch.bfloat16)
    sg = torch.from_numpy(gates).reshape(-1)[plan.order]
    before = (md.moe_fill.launches, md.moe_combine.launches, dict(md.moe_fill.launches_by_route),
              dict(md.moe_combine.launches_by_route))
    assert torch.equal(ops.fill_expert_slots(x, src, t), md.moe_fill_plain(x, src, t))
    assert torch.equal(ops.combine_expert_rows(y, plan.expert, plan.slot, sg, plan.keep,
                                               plan.order, k),
                       md.moe_combine_plain(y, plan.expert, plan.slot, sg, plan.keep,
                                            plan.order, k))
    assert (md.moe_fill.launches, md.moe_combine.launches, dict(md.moe_fill.launches_by_route),
            dict(md.moe_combine.launches_by_route)) == before
    assert set(md.moe_fill.launches_by_route) == set(md.ROUTES) == {"vector", "scalar"}


def test_meta_route_returns_the_shapes():
    t, k, e, d, cap = 64, 8, 16, 24, 40
    rows = torch.empty((t, d), dtype=torch.bfloat16, device="meta")
    src = torch.empty((e, cap), dtype=torch.int32, device="meta")
    buf = md.moe_fill(rows, src, t)
    assert buf.device.type == "meta" and tuple(buf.shape) == (e, cap, d)
    assert buf.dtype == torch.bfloat16
    n = t * k
    meta = dict(device="meta")
    out = md.moe_combine(torch.empty((e, cap, d), dtype=torch.bfloat16, **meta),
                         torch.empty(n, dtype=torch.long, **meta),
                         torch.empty(n, dtype=torch.long, **meta),
                         torch.empty(n, **meta), torch.empty(n, dtype=torch.bool, **meta),
                         torch.empty(n, dtype=torch.long, **meta), k)
    assert out.device.type == "meta" and tuple(out.shape) == (t, d)
    assert out.dtype == torch.bfloat16


def test_refusals_before_any_launch():
    rows = torch.zeros(5, 4)
    with pytest.raises(ValueError, match="sentinel"):
        md.moe_fill(rows, torch.zeros((2, 3), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        md.moe_fill(rows.view(-1), torch.zeros((2, 3), dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="T·k"):
        md.moe_combine(torch.zeros(2, 3, 4), *[torch.zeros(5, dtype=torch.long)] * 2,
                       torch.zeros(5), torch.zeros(5, dtype=torch.bool),
                       torch.zeros(5, dtype=torch.long), 2)


def _moe_ffn_before(params, x, num_experts, k, capacity_factor=1.25):
    """``moe_ffn`` as it was before B2: the (E, C+1, D) buffer by index_put,
    the combine over ``ypad``, verbatim."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, idx, probs = moe.router_topk(x2d, params["router"], k)
    cap = moe.capacity(t, k, num_experts, capacity_factor)
    plan = moe.dispatch_plan(idx, num_experts, cap)
    wdt = torch.promote_types(x.dtype, params["w_gate"].dtype)
    buf = torch.zeros((num_experts, cap + 1, d), dtype=wdt, device=x.device)
    buf[plan.expert, plan.slot] = x2d.to(wdt)[plan.token]
    y = moe.expert_swiglu(buf[:, :cap], params["w_gate"], params["w_up"], params["w_down"])
    ypad = torch.cat([y, torch.zeros((num_experts, 1, d), dtype=y.dtype, device=y.device)],
                     dim=1)
    gate = gates.reshape(-1)[plan.order]
    contrib = ypad[plan.expert, plan.slot] * gate[:, None].to(ypad.dtype)
    contrib = torch.where(plan.keep[:, None], contrib, torch.zeros((), dtype=ypad.dtype))
    inverse = torch.empty_like(plan.order)
    inverse[plan.order] = torch.arange(plan.order.shape[0])
    per_token = contrib[inverse.view(-1, k).sort(dim=1).values]
    out2d = per_token[:, 0]
    for j in range(1, k):
        out2d = out2d + per_token[:, j]
    return out2d.reshape(b, s, d).to(x.dtype)


@pytest.mark.parametrize("dtype,x_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32")])   # the f32 witness
@pytest.mark.parametrize("b,s,d,e,k,ff,cf", [
    (2, 16, 32, 8, 2, 64, 1.25),
    (4, 1, 32, 8, 8, 16, 1.25),       # decode-like: capacity 1, k = E
    (1, 24, 16, 8, 1, 32, 0.5),       # k = 1, heavy drops
])
def test_moe_ffn_through_the_ops_equals_the_indexing_before(b, s, d, e, k, ff, cf, dtype,
                                                            x_dtype):
    gen = torch.Generator().manual_seed(7)
    params = moe.init_moe(gen, d, e, ff, dtype=getattr(torch, dtype))
    x = torch.randn((b, s, d), generator=gen).to(getattr(torch, x_dtype))
    got = moe.moe_ffn(params, x, e, k, cf)
    want = _moe_ffn_before(params, x, e, k, cf)
    assert got.dtype == x.dtype
    assert torch.equal(_bits_t(got), _bits_t(want))


def test_moe_ffn_gradients_through_the_plain_versions_equal_the_indexing_before():
    """CPU training keeps the plain versions and their autograd: x's and
    every expert tensor's gradient equal the old indexing's."""
    gen = torch.Generator().manual_seed(8)
    params = moe.init_moe(gen, 16, 8, 32)
    x = torch.randn((2, 12, 16), generator=gen)
    grads = []
    for fn in (moe.moe_ffn, _moe_ffn_before):
        p = {n: v.clone().requires_grad_(True) for n, v in params.items()}
        xi = x.clone().requires_grad_(True)
        out = fn(p, xi, 8, 2, 0.75)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum().backward()
        grads.append([xi.grad] + [p[n].grad for n in ("w_gate", "w_up", "w_down", "router")])
    for g_new, g_old in zip(*grads):
        torch.testing.assert_close(g_new, g_old, rtol=1e-6, atol=1e-7)


def test_slot_sources_on_the_mesh_equal_the_body_before():
    """``slot_sources`` at the padded capacity, cut to a device's experts,
    is the mesh body's table as it built it before B2 (int64 then)."""
    t, k, e, d, cap, idx, gates, plan = _setup("k8_empty_expert")
    capp, e0, el = cap + 3, 4, 8
    old = torch.full((e, capp + 1), t, dtype=plan.token.dtype)
    old[plan.expert, torch.where(plan.keep, plan.slot, capp)] = plan.token
    old = old[e0:e0 + el, :capp]
    got = moe.slot_sources(plan, e, capp, t)[e0:e0 + el]
    assert got.is_contiguous() and torch.equal(got.long(), old)


def test_cu_constants_match_the_binding():
    text = CSRC.read_text()
    assert int(re.search(r"constexpr int MAX_K = (\d+);", text).group(1)) == md.MAX_K
    assert re.search(r'extern "C" int moe_fill\(', text)
    assert re.search(r'extern "C" int moe_combine\(', text)
    # no atomics: the combine's bits do not depend on the order of blocks
    assert "atomic" not in re.sub(r"//.*", "", text)
