"""B2, the MoE layer's dispatch and combine (``repro_torch.kernels.moe_dispatch``),
on the CPU, against the JAX package's own expressions.

The same plan and numpy inputs go through both:

* the route table (``moe.route_table``) against the sorted plan's entries,
  dropped assignments, experts without tokens and the mesh's local slice at
  a padded capacity included;
* the plain fill against the reference's buffer, ``jnp.zeros((E, C+1,
  D)).at[sorted_expert, slot].set(x[sorted_token])[:, :C]``, exactly;
* the plain combine against the reference's ``ypad[sorted_expert, slot] *
  gate``, ``where(keep, …)`` and ``zeros.at[sorted_token].add(…)``: exactly
  in f32, and in bf16 within ``test_torch_moe.py``'s bf16 tolerance (XLA's
  scatter-add starts from a zero row and may keep its own precision);
* both plain versions against the slot-major ones they replaced (over the
  sorted plan and its inverse permutation), bit for bit;
* the kernels' arithmetic, written in torch over what they read (the
  table), against the plain versions bit for bit;
* ``moe_ffn`` through the ops against the indexing it had before them,
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
# one device's slice of the experts on a mesh: (first expert, experts, capacity padding)
MESH_SLICES = {"middle": (4, 8, 3), "first": (0, 4, 1), "last": (12, 4, 2)}


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
    routes = moe.route_table(plan, torch.from_numpy(gates), cap)
    return t, k, e, d, cap, idx, gates, plan, routes


def _bits(a):
    """A torch or JAX array's bits as numpy (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16).astype(np.int16) if a.dtype.name == "bfloat16" else a


def _bits_t(a):
    return a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)


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


# ---- the slot-major plain versions B2 had before the route table, verbatim ----

def _slot_sources_before(plan, num_experts, cap, fill):
    src = torch.full((num_experts, cap + 1), fill, dtype=torch.int32)
    src[plan.expert, torch.where(plan.keep, plan.slot, cap)] = plan.token.to(torch.int32)
    return src[:, :cap].contiguous()


def _fill_before(rows, src, fill):
    padded = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    return padded[src].contiguous()


def _inverse_order(order):
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0])
    return inverse


def _combine_before(y, expert, slot, gate, keep, order, k):
    e, _, d = y.shape
    ypad = torch.cat([y, torch.zeros((e, 1, d), dtype=y.dtype)], dim=1)
    contrib = ypad[expert, slot] * gate[:, None].to(ypad.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros((), dtype=ypad.dtype))
    per_token = contrib[_inverse_order(order).view(-1, k).sort(dim=1).values]
    out2d = per_token[:, 0]
    for j in range(1, k):
        out2d = out2d + per_token[:, j]
    return out2d


# ---- the kernels' arithmetic, written in torch over what they read ----

def _fill_in_torch(rows, dest, kept, cap):
    """The fill kernel's writes: each empty slot (c >= kept[e]) zeroed, each
    token's row stored to each of its kept destinations. Every slot must be
    written exactly once."""
    e, d = kept.shape[0], rows.shape[1]
    out = torch.full((e * cap, d), float("nan"), dtype=torch.float64)
    writes = torch.zeros(e * cap, dtype=torch.long)
    r = torch.arange(e * cap)
    empty = r % cap >= kept.long()[r // cap]
    out[empty] = 0.0
    writes[empty] += 1
    for t, j in zip(*torch.nonzero(dest >= 0, as_tuple=True)):
        s = int(dest[t, j])
        out[s] = rows[t].double()
        writes[s] += 1
    assert bool((writes == 1).all()), "a slot written twice or never"
    return out.to(rows.dtype).view(e, cap, d)


def _combine_in_torch(y, dest, gate, expert0=0):
    """The combine kernel's arithmetic over the table: each token's k
    (dest, gate) pairs, one a lane, ranked by expert id with ties by lane
    (as the warp's shuffles rank them); then, in that order, the product
    rounded to y's dtype (+0.0 where dropped), the first term as it is and
    every later one by a rounded sum."""
    e, cap, d = y.shape
    k = dest.shape[1]
    flat = y.reshape(-1, d)
    key = torch.where(dest >= 0, dest // cap + expert0, -1 - dest).long()
    lane = torch.arange(k)
    before = (key[:, None, :] < key[:, :, None]) | (
        (key[:, None, :] == key[:, :, None]) & (lane[None, None, :] < lane[None, :, None]))
    rank = before.sum(-1)                                   # rank[t, j]
    src = torch.empty_like(rank).scatter_(1, rank, lane.expand_as(rank))
    out = None
    for r in range(k):
        row = dest.gather(1, src[:, r:r + 1])[:, 0]
        g = gate.gather(1, src[:, r:r + 1])[:, 0]
        prod = flat[row.clamp(min=0).long()] * g[:, None].to(y.dtype)
        term = torch.where((row >= 0)[:, None], prod, torch.zeros((), dtype=y.dtype))
        out = term if out is None else out + term
    return out


# ---- the route table ----

@pytest.mark.parametrize("case", CASES)
def test_route_table_is_the_sorted_plan(case):
    """Token t's j-th entry is its sorted assignment's ``expert·C + slot``
    where kept, ``-1 - expert`` where dropped; the gates are the router's;
    the kept counts are min(assignments, C) an expert."""
    t, k, e, d, cap, idx, gates, plan, routes = _setup(case)
    assert routes.dest.dtype == torch.int32 and tuple(routes.dest.shape) == (t, k)
    assert routes.dest.is_contiguous() and routes.kept.dtype == torch.int32
    # kept is derived from dest: the count of each expert's rows there
    live = routes.dest[routes.dest >= 0].long()
    assert torch.equal(routes.kept, torch.bincount(live // cap, minlength=e).to(torch.int32))
    assert torch.equal(routes.gate, torch.from_numpy(gates))
    tok, j = plan.order // k, plan.order % k
    want = torch.where(plan.keep, plan.expert * cap + plan.slot, -1 - plan.expert)
    assert torch.equal(routes.dest[tok, j].long(), want)
    assert torch.equal(torch.where(routes.dest >= 0, routes.dest // cap, -1 - routes.dest).long(),
                       torch.from_numpy(idx))
    counts = np.bincount(idx.reshape(-1), minlength=e)
    assert routes.kept.tolist() == np.minimum(counts, cap).tolist()
    if CASES[case][5]:
        assert int(routes.kept[0]) == 0                     # the expert without tokens
    if case == "drops":
        assert int((routes.dest < 0).sum()) == int((~plan.keep).sum()) > 0


@pytest.mark.parametrize("where", MESH_SLICES)
def test_route_table_on_the_mesh_is_the_body_before(where):
    """The table cut to a device's experts at the padded capacity gives the
    mesh body's buffer and partial combine as it built them before the
    table (the slot sources cut to its experts; expert, slot and keep masked
    to them), bit for bit; the slots from cap to capp stay empty."""
    t, k, e, d, cap, idx, gates, plan, _ = _setup("k8_empty_expert")
    e0, el, pad = MESH_SLICES[where]
    capp = cap + pad
    routes = moe.route_table(plan, torch.from_numpy(gates), capp, e0, el)
    live = routes.dest[routes.dest >= 0].long()
    assert torch.equal(routes.kept, torch.bincount(live // capp, minlength=el).to(torch.int32))
    assert torch.equal(routes.kept, plan.kept[e0:e0 + el]) and bool((routes.kept <= cap).all())
    rows = torch.from_numpy(np.random.default_rng(5).standard_normal((t, d)).astype(np.float32))
    src = _slot_sources_before(plan, e, capp, t)[e0:e0 + el]
    buf = md.moe_fill_plain(rows, routes.dest, routes.kept, capp)
    assert tuple(buf.shape) == (el, capp, d) and not buf[:, cap:].any()
    assert torch.equal(buf, _fill_before(rows, src, t))
    y = torch.from_numpy(np.random.default_rng(6).standard_normal((el, capp, d))
                         .astype(np.float32))
    y[:, :, 0] = -0.0
    local = plan.expert - e0
    mine = plan.keep & (local >= 0) & (local < el)
    want = _combine_before(y, torch.where(mine, local, torch.zeros_like(local)),
                           torch.where(mine, plan.slot, torch.full_like(plan.slot, capp)),
                           torch.from_numpy(gates).reshape(-1)[plan.order], mine, plan.order, k)
    got = md.moe_combine_plain(y, routes.dest, routes.gate, e0)
    assert torch.equal(_bits_t(got), _bits_t(want))
    assert torch.equal(_bits_t(_combine_in_torch(y, routes.dest, routes.gate, e0)),
                       _bits_t(want))


# ---- the plain versions ----

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_fill_is_the_reference_buffer(case, dtype):
    t, k, e, d, cap, idx, gates, plan, routes = _setup(case)
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(1).standard_normal((t, d)).astype(np.float32)
    got = md.moe_fill_plain(torch.from_numpy(x).to(tdt), routes.dest, routes.kept, cap)
    want = _jax_fill(x, plan, e, cap, jdt)
    assert got.is_contiguous() and tuple(got.shape) == (e, cap, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if CASES[case][5]:
        assert not got[0].any()                              # the expert without tokens
    assert int((routes.dest >= 0).sum()) == int(plan.keep.sum())   # one slot a kept assignment


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_combine_is_the_reference_scatter_add(case, dtype):
    t, k, e, d, cap, idx, gates, plan, routes = _setup(case)
    tdt, jdt = DTYPES[dtype]
    y = np.random.default_rng(2).standard_normal((e, cap, d)).astype(np.float32)
    got = md.moe_combine_plain(torch.from_numpy(y).to(tdt), routes.dest, routes.gate)
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
def test_plain_versions_equal_the_slot_major_ones_before(case, dtype):
    """The table's plain fill and combine against B2's plain versions over
    the sorted plan (the slot sources; the argsort's inverse), bit for bit,
    signed zeros included."""
    t, k, e, d, cap, idx, gates, plan, routes = _setup(case, seed=7)
    tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).to(tdt)
    got = md.moe_fill_plain(x, routes.dest, routes.kept, cap)
    assert torch.equal(_bits_t(got), _bits_t(_fill_before(x, _slot_sources_before(plan, e, cap, t),
                                                           t)))
    y = torch.from_numpy(rng.standard_normal((e, cap, d)).astype(np.float32)).to(tdt)
    y[:, :, 1] = -0.0
    sorted_gate = torch.from_numpy(gates).reshape(-1)[plan.order]
    want = _combine_before(y, plan.expert, plan.slot, sorted_gate, plan.keep, plan.order, k)
    assert torch.equal(_bits_t(md.moe_combine_plain(y, routes.dest, routes.gate)), _bits_t(want))


# ---- the kernels' arithmetic ----

@pytest.mark.parametrize("case", CASES)
def test_fill_kernel_writes_over_the_table_are_the_plain_fill(case):
    """What the fill kernel writes from the table (zeros past each kept
    count, each row to its destinations) covers every slot once and equals
    the plain fill."""
    t, k, e, d, cap, idx, gates, plan, routes = _setup(case, seed=9)
    rows = torch.from_numpy(np.random.default_rng(10).standard_normal((t, d))
                            .astype(np.float32)).to(torch.bfloat16)
    got = _fill_in_torch(rows, routes.dest, routes.kept, cap)
    assert torch.equal(_bits_t(got), _bits_t(md.moe_fill_plain(rows, routes.dest, routes.kept,
                                                               cap)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_kernel_arithmetic_over_the_plan_is_the_plain_combine(case, dtype):
    """What the combine kernel computes from the route table equals the
    plain combine bit for bit (signs of zero included); each token's
    expert-ordered entries rise with its expert ids."""
    t, k, e, d, cap, idx, gates, plan, routes = _setup(case, seed=3)
    tdt, _ = DTYPES[dtype]
    y = torch.from_numpy(np.random.default_rng(4).standard_normal((e, cap, d))
                         .astype(np.float32)).to(tdt)
    y[:, :, 0] = -0.0                        # a column whose sums are signed zeros
    order = md.expert_order(routes.dest, cap)
    dest = routes.dest.gather(1, order)
    assert torch.equal(torch.where(dest >= 0, dest // cap, -1 - dest).long(),
                       torch.from_numpy(np.sort(idx, axis=1)))
    got = _combine_in_torch(y, routes.dest, routes.gate)
    want = md.moe_combine_plain(y, routes.dest, routes.gate)
    assert torch.equal(_bits_t(got), _bits_t(want))


def test_a_dropped_assignment_still_takes_part_in_the_sum():
    """Where a token's kept products are -0.0, the sum is -0.0 with every
    assignment kept and +0.0 once a dropped one (+0.0) joins it, wherever
    it stands in the expert order."""
    y = torch.full((3, 1, 4), -0.0)
    gate = torch.tensor([[0.25, 0.5, 0.25]])
    both = md.moe_combine_plain(y, torch.tensor([[0, 1, 2]], dtype=torch.int32), gate)
    assert torch.signbit(both).all()
    for dropped in range(3):
        dest = torch.tensor([[0, 1, 2]], dtype=torch.int32)
        dest[0, dropped] = -1 - dropped
        one = md.moe_combine_plain(y, dest, gate)
        assert not torch.signbit(one).any()
        assert torch.equal(_bits_t(_combine_in_torch(y, dest, gate)), _bits_t(one))


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    t, k, e, d, cap, idx, gates, plan, routes = _setup("drops")
    x = torch.randn(t, d, dtype=torch.bfloat16)
    y = torch.randn(e, cap, d, dtype=torch.bfloat16)
    before = (md.moe_fill.launches, md.moe_combine.launches, dict(md.moe_fill.launches_by_route),
              dict(md.moe_combine.launches_by_route))
    assert torch.equal(ops.fill_expert_slots(x, routes.dest, routes.kept, cap),
                       md.moe_fill_plain(x, routes.dest, routes.kept, cap))
    assert torch.equal(ops.combine_expert_rows(y, routes.dest, routes.gate),
                       md.moe_combine_plain(y, routes.dest, routes.gate))
    assert (md.moe_fill.launches, md.moe_combine.launches, dict(md.moe_fill.launches_by_route),
            dict(md.moe_combine.launches_by_route)) == before
    assert set(md.moe_fill.launches_by_route) == set(md.ROUTES) == {"vector", "scalar"}


def test_meta_route_returns_the_shapes():
    t, k, e, d, cap = 64, 8, 16, 24, 40
    meta = dict(device="meta")
    rows = torch.empty((t, d), dtype=torch.bfloat16, **meta)
    dest = torch.empty((t, k), dtype=torch.int32, **meta)
    kept = torch.empty((e,), dtype=torch.int32, **meta)
    buf = md.moe_fill(rows, dest, kept, cap)
    assert buf.device.type == "meta" and tuple(buf.shape) == (e, cap, d)
    assert buf.dtype == torch.bfloat16
    out = md.moe_combine(torch.empty((e, cap, d), dtype=torch.bfloat16, **meta), dest,
                         torch.empty((t, k), **meta))
    assert out.device.type == "meta" and tuple(out.shape) == (t, d)
    assert out.dtype == torch.bfloat16


def test_refusals_before_any_launch():
    rows = torch.zeros(5, 4)
    dest = torch.zeros((5, 2), dtype=torch.int32)
    kept = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(T, D\)"):
        md.moe_fill(rows.view(-1), dest, kept, 3)
    with pytest.raises(ValueError, match=r"\(T, k\)"):
        md.moe_fill(rows, dest[:4], kept, 3)
    with pytest.raises(ValueError, match=r"\(T, k\)"):
        md.moe_combine(torch.zeros(2, 3, 4), dest, torch.zeros(5, 3))


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
    """CPU training goes through B2's Functions, whose backwards there are
    the plain adjoints: x's and every expert tensor's gradient equal the
    old indexing's autograd but for the order of f32 sums."""
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


def _c_params(text, name):
    """The parameters of ``extern "C" int name(...)`` in the source."""
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text).group(1)
    return [p.strip() for p in sig.split(",")]


def test_cu_constants_match_the_binding():
    text = CSRC.read_text()
    assert int(re.search(r"constexpr int MAX_K = (\d+);", text).group(1)) == md.MAX_K
    shifts = dict(re.findall(r"constexpr int MODE_(\w+)_SHIFT = (\d+);", text))
    assert {k: int(v) for k, v in shifts.items()} == {
        "DTYPE": md._MODE_DTYPE_SHIFT, "K": md._MODE_K_SHIFT, "DEVICE": md._MODE_DEVICE_SHIFT}
    # the mode's fields do not overlap: 1 bit of route, 1 of dtype, 6 of k
    assert md._mode(True, torch.bfloat16, md.MAX_K, 0) < 1 << md._MODE_DEVICE_SHIFT
    assert md._mode(True, torch.bfloat16, 5, 3) == 1 | 1 << 1 | 5 << 2 | 3 << 8
    assert md._mode(False, torch.float32, 1, 0) == 1 << 2
    for name, argtypes in (("moe_fill", md._FILL_ARGTYPES),
                           ("moe_combine", md._COMBINE_ARGTYPES)):
        params = _c_params(text, name)
        assert len(params) == len(argtypes)
        for p, a in zip(params, argtypes):
            want = ("*" in p, "long long" in p)
            assert want == (a is md._P, a is md._LL), (name, p, a)
    # no atomics: the combine's bits do not depend on the order of blocks
    assert "atomic" not in re.sub(r"//.*", "", text)
