"""B2's kernels (``csrc/moe_dispatch.cu``) on the card.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_moe_dispatch_cuda.py``.
Without a card every case skips.

The fill is a copy and the combine rounds every product and sum as
``moe_combine_plain``'s eager ops do, so both are held to their plain
versions bit for bit (``torch.equal`` on the bits), with no tolerance. Both
read the route table (``moe.route_table``).

Their adjoints likewise: the fill's adjoint (``moe_fill_bwd``, an f32 sum
in expert order rounded once) and the combine's ``dy`` (one rounded product
a slot) bit for bit; the combine's ``dgate`` differs from
``moe_combine_bwd_plain``'s only by the order of its f32 sum over D: in
bf16 within one bf16 ulp of the plain value, plus 4e-6 of the sum of the
products' magnitudes where the dot cancels to near zero (there an f32
order difference exceeds an ulp of the small result); in f32 within 1e-5
of the case's largest |dgate|.
"""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ops
from repro_torch.models import forward_prefill, init_params, moe
from repro_torch.models.config import ATTN_MOE, SSM_MOE
from repro_torch.models.transformer import layer_kinds

pytestmark = pytest.mark.cuda

DTYPES = (torch.float32, torch.bfloat16)
# (tokens, k, experts, d, capacity factor): olmoe's k and E at a narrow
# width, an odd width (the scalar route), one token, heavy drops, jamba's k,
# kimi-k2's and jamba's widths, a scalar width whose last pass a lane takes
# holds only two of a warp's lanes
SHAPES = {
    "olmoe_narrow": (512, 8, 64, 256, 1.25),
    "odd_width": (96, 4, 16, 77, 1.25),
    "one_token": (1, 8, 64, 128, 1.25),
    "drops": (256, 8, 64, 128, 0.5),
    "k2": (300, 2, 16, 136, 1.25),
    "kimi_k2_width": (64, 8, 384, 7168, 1.25),
    "jamba_width": (48, 2, 16, 8192, 1.25),
    "scalar_tail": (64, 8, 64, 2050, 1.25),   # a row of 2050: 2 units past 16 x 128
}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _plan(t, k, e, cf, gen):
    """A routing of k distinct experts a token with normalised gates: its
    plan, its route table and the capacity."""
    scores = torch.rand((t, e), generator=gen, device="cuda")
    gates, idx = torch.topk(scores, k, dim=-1)
    gates = gates.clamp(min=1e-3)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    cap = moe.capacity(t, k, e, cf)
    plan = moe.dispatch_plan(idx, e, cap)
    return plan, moe.route_table(plan, gates, cap), cap


def _bits(a):
    return a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)


def _fill_both(rows, routes, cap):
    fill = md.moe_fill
    before = (fill.launches, dict(fill.launches_by_route))
    got = fill(rows, routes.dest, routes.kept, cap)
    took = fill.launches - before[0]
    by_route = {r: fill.launches_by_route[r] - before[1][r] for r in md.ROUTES}
    want = md.moe_fill_plain(rows, routes.dest, routes.kept, cap)
    torch.cuda.synchronize()
    return got, want, took, by_route


def _combine_both(y, routes, expert0=0):
    before = (md.moe_combine.launches, dict(md.moe_combine.launches_by_route))
    got = md.moe_combine(y, routes.dest, routes.gate, expert0)
    took = md.moe_combine.launches - before[0]
    by_route = {r: md.moe_combine.launches_by_route[r] - before[1][r] for r in md.ROUTES}
    want = md.moe_combine_plain(y, routes.dest, routes.gate, expert0)
    torch.cuda.synchronize()
    return got, want, took, by_route


def _want_route(d, dtype):
    return "vector" if d * torch.empty((), dtype=dtype).element_size() % 16 == 0 else "scalar"


def _counted(fn, call):
    """``call()``'s result, ``fn``'s launches and its launches by route in it."""
    before = (fn.launches, dict(fn.launches_by_route))
    got = call()
    took = fn.launches - before[0]
    return got, took, {r: fn.launches_by_route[r] - before[1][r] for r in md.ROUTES}


def _dgate_close(got, want, grad_out, y, dest):
    """The module docstring's dgate tolerance."""
    if y.dtype == torch.float32:
        scale = max(float(want.abs().max()), 1e-30)
        return bool(((got - want).abs() <= 1e-5 * scale).all())
    e, cap, d = y.shape
    rows = y.reshape(e * cap, d)[torch.where(dest >= 0, dest, 0).long()]
    mag = (grad_out[:, None, :] * rows).abs().float().sum(dim=-1)
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
    return bool(((got - want).abs() <= ulp + 4e-6 * mag).all())


def _backward_both(grad_buf, grad_out, y, routes):
    """Both adjoints on the card and their plain versions: (dx, want dx,
    dy, want dy, dgate, want dgate, launches of each kernel, its routes)."""
    dx, took_f, route_f = _counted(md.moe_fill_bwd, lambda: md.moe_fill_bwd(grad_buf, routes.dest))
    (dy, dgate), took_c, route_c = _counted(
        md.moe_combine_bwd,
        lambda: md.moe_combine_bwd(grad_out, y, routes.dest, routes.gate, routes.kept))
    want_dx = md.moe_fill_bwd_plain(grad_buf, routes.dest)
    want_dy, want_dgate = md.moe_combine_bwd_plain(grad_out, y, routes.dest, routes.gate)
    torch.cuda.synchronize()
    return (dx, want_dx, dy, want_dy, dgate, want_dgate, (took_f, took_c), (route_f, route_c))


def _check_backward(grad_buf, grad_out, y, routes, route=None):
    dx, want_dx, dy, want_dy, dgate, want_dgate, took, by_route = _backward_both(
        grad_buf, grad_out, y, routes)
    assert dx.shape == want_dx.shape and torch.equal(_bits(dx), _bits(want_dx))
    assert dy.shape == want_dy.shape and torch.equal(_bits(dy), _bits(want_dy))
    assert dgate.dtype == torch.float32 and dgate.shape == routes.dest.shape
    assert _dgate_close(dgate, want_dgate, grad_out, y, routes.dest)
    dropped = routes.dest < 0
    assert not dgate[dropped].any() and not torch.signbit(dgate[dropped]).any()
    assert took == (1, 1)
    if route is not None:
        assert by_route == ({r: int(r == route) for r in md.ROUTES},) * 2
    return dx, dy, dgate


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fill_equals_plain(shape, dtype):
    t, k, e, d, cf = SHAPES[shape]
    gen = _gen(0)
    plan, routes, cap = _plan(t, k, e, cf, gen)
    rows = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    got, want, took, by_route = _fill_both(rows, routes, cap)
    assert got.is_contiguous() and got.shape == want.shape == (e, cap, d)
    assert torch.equal(_bits(got), _bits(want))
    route = _want_route(d, dtype)
    assert took == 1 and by_route == {r: int(r == route) for r in md.ROUTES}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_combine_equals_plain(shape, dtype):
    t, k, e, d, cf = SHAPES[shape]
    gen = _gen(1)
    plan, routes, cap = _plan(t, k, e, cf, gen)
    y = torch.randn((e, cap, d), generator=gen, device="cuda").to(dtype)
    y[:, :, 0] = -0.0                       # sums of signed zeros in one column
    got, want, took, by_route = _combine_both(y, routes)
    assert got.shape == want.shape == (t, d)
    assert torch.equal(_bits(got), _bits(want))
    route = _want_route(d, dtype)
    assert took == 1 and by_route == {r: int(r == route) for r in md.ROUTES}


@pytest.mark.parametrize("dtype", DTYPES)
def test_an_expert_without_tokens_and_one_full_expert(dtype):
    t, k, e, d = 200, 2, 8, 64
    gen = _gen(2)
    # every token picks expert 1 (full: 200 assignments for 63 slots) and
    # one other, never expert 0
    other = torch.randint(2, e, (t, 1), generator=gen, device="cuda")
    idx = torch.cat([torch.ones_like(other), other], dim=1)
    cap = moe.capacity(t, k, e, 1.25)
    plan = moe.dispatch_plan(idx, e, cap)
    routes = moe.route_table(plan, torch.rand((t, k), generator=gen, device="cuda"), cap)
    assert routes.kept[0].item() == 0 and routes.kept[1].item() == cap
    rows = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    got, want, _, _ = _fill_both(rows, routes, cap)
    assert torch.equal(_bits(got), _bits(want)) and not got[0].any()
    y = torch.randn((e, cap, d), generator=gen, device="cuda").to(dtype)
    got, want, _, _ = _combine_both(y, routes)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_sentinels_and_all_dropped(dtype):
    """Every slot empty (every assignment dropped, kept counts 0): the
    buffer all zeros, the output +0.0 throughout."""
    t, e, d, k = 16, 4, 40, 2
    _, routes, cap = _plan(t, k, e, 1.0, _gen(3))
    dropped = -1 - torch.where(routes.dest >= 0, routes.dest // cap, -1 - routes.dest)
    none = routes._replace(dest=dropped.to(torch.int32).contiguous(),
                           kept=torch.zeros_like(routes.kept))
    rows = torch.randn((t, d), device="cuda").to(dtype)
    got, want, took, _ = _fill_both(rows, none, cap)
    assert took == 1 and torch.equal(_bits(got), _bits(want)) and not got.any()
    y = -torch.rand((e, cap, d), device="cuda").to(dtype)
    got, want, _, _ = _combine_both(y, none)
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.signbit(got).any()     # +0.0 throughout


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_token_whose_assignments_are_all_dropped(dtype):
    """Every token routes to expert 0 and one other, capacity 1: most
    tokens keep nothing, their output rows +0.0 and nothing of theirs in
    the buffer; the -0.0 column of y shows the sign of every zero sum."""
    t, k, e, d = 40, 2, 8, 256
    gen = _gen(9)
    other = torch.randint(1, e, (t, 1), generator=gen, device="cuda")
    idx = torch.cat([torch.zeros_like(other), other], dim=1)
    plan = moe.dispatch_plan(idx, e, 1)
    routes = moe.route_table(plan, torch.rand((t, k), generator=gen, device="cuda"), 1)
    all_dropped = (routes.dest < 0).all(dim=1)
    assert int(all_dropped.sum()) > 0
    rows = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    got, want, _, _ = _fill_both(rows, routes, 1)
    assert torch.equal(_bits(got), _bits(want))
    y = torch.randn((e, 1, d), generator=gen, device="cuda").to(dtype)
    y[:, :, 0] = -0.0
    got, want, _, _ = _combine_both(y, routes)
    assert torch.equal(_bits(got), _bits(want))
    assert not got[all_dropped].any() and not torch.signbit(got[all_dropped]).any()


@pytest.mark.parametrize("tokens", [1, 2, 3])
@pytest.mark.parametrize("d", [2048, 10000])
def test_fewer_tokens_than_a_block_has_warps(tokens, d):
    """Fewer tokens than a block's eight warps, rows of olmoe's D and of
    20,000 bytes (not a whole number of a lane's 4 x 32 units): most warps
    only zero slots."""
    gen = _gen(10)
    plan, routes, cap = _plan(tokens, 8, 64, 1.25, gen)
    rows = torch.randn((tokens, d), generator=gen, device="cuda").to(torch.bfloat16)
    got, want, took, by_route = _fill_both(rows, routes, cap)
    assert torch.equal(_bits(got), _bits(want)) and by_route["vector"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_mesh_slice_at_a_padded_capacity(dtype):
    """A device's experts of a 2-way expert split at a capacity padded by
    3: slots from cap to capp zero, the combine over its experts only
    (expert0 16 of 32)."""
    t, k, e, d = 256, 8, 32, 512
    gen = _gen(11)
    scores = torch.rand((t, e), generator=gen, device="cuda")
    gates, idx = torch.topk(scores, k, dim=-1)
    cap = moe.capacity(t, k, e, 1.25)
    plan = moe.dispatch_plan(idx, e, cap)
    routes = moe.route_table(plan, gates, cap + 3, 16, 16)
    rows = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    got, want, _, _ = _fill_both(rows, routes, cap + 3)
    assert torch.equal(_bits(got), _bits(want)) and not got[:, cap:].any()
    y = torch.randn((16, cap + 3, d), generator=gen, device="cuda").to(dtype)
    y[:, :, 0] = -0.0
    got, want, _, _ = _combine_both(y, routes, 16)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_views_off_alignment_take_the_scalar_route(dtype):
    t, k, e, d = 64, 4, 8, 64
    gen = _gen(4)
    plan, routes, cap = _plan(t, k, e, 1.25, gen)
    base = torch.randn(t * d + 1, generator=gen, device="cuda").to(dtype)
    rows = base[1:].view(t, d)              # one element off 16 bytes
    got, want, _, by_route = _fill_both(rows, routes, cap)
    assert torch.equal(_bits(got), _bits(want)) and by_route["scalar"] == 1
    ybase = torch.randn(e * cap * d + 1, generator=gen, device="cuda").to(dtype)
    y = ybase[1:].view(e, cap, d)
    got, want, _, by_route = _combine_both(y, routes)
    assert torch.equal(_bits(got), _bits(want)) and by_route["scalar"] == 1


def test_f32_rows_over_the_witness_buffer():
    """The f32 witness: x and the buffer f32, the combine over f32 experts'
    output."""
    t, k, e, d = 256, 8, 64, 128
    gen = _gen(5)
    plan, routes, cap = _plan(t, k, e, 1.25, gen)
    rows = torch.randn((t, d), generator=gen, device="cuda")
    got, want, _, _ = _fill_both(rows, routes, cap)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    y = torch.randn((e, cap, d), generator=gen, device="cuda")
    got, want, _, _ = _combine_both(y, routes)
    assert got.dtype == torch.float32 and torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernels_equal_plain(shape, dtype):
    t, k, e, d, cf = SHAPES[shape]
    gen = _gen(12)
    plan, routes, cap = _plan(t, k, e, cf, gen)
    grad_buf = torch.randn((e, cap, d), generator=gen, device="cuda").to(dtype)
    grad_out = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    y = torch.randn((e, cap, d), generator=gen, device="cuda").to(dtype)
    grad_buf[:, :, 0] = -0.0                # signed zeros through the adjoint's sum
    _check_backward(grad_buf, grad_out, y, routes, _want_route(d, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["empty_expert", "all_dropped_token", "mesh_slice",
                                  "off_alignment"])
def test_backward_kernels_at_the_edges(kind, dtype):
    """An expert without tokens (its dy slots all zero), tokens whose every
    route is dropped (dx +0.0, dgate 0), a device's experts at a padded
    capacity, and views off 16-byte alignment (the scalar route)."""
    gen = _gen(13)
    t, k, e, d = 200, 2, 8, 64
    route = "vector"
    if kind == "empty_expert":
        other = torch.randint(2, e, (t, 1), generator=gen, device="cuda")
        idx = torch.cat([torch.ones_like(other), other], dim=1)
        cap = moe.capacity(t, k, e, 1.25)
        routes = moe.route_table(moe.dispatch_plan(idx, e, cap),
                                 torch.rand((t, k), generator=gen, device="cuda"), cap)
    elif kind == "all_dropped_token":
        other = torch.randint(1, e, (t, 1), generator=gen, device="cuda")
        idx = torch.cat([torch.zeros_like(other), other], dim=1)
        cap = 1
        routes = moe.route_table(moe.dispatch_plan(idx, e, cap),
                                 torch.rand((t, k), generator=gen, device="cuda"), cap)
    elif kind == "mesh_slice":
        t, k, e, d = 256, 8, 32, 512
        gates, idx = torch.topk(torch.rand((t, e), generator=gen, device="cuda"), k, dim=-1)
        cap0 = moe.capacity(t, k, e, 1.25)
        cap = cap0 + 3
        routes = moe.route_table(moe.dispatch_plan(idx, e, cap0), gates, cap, 16, 16)
        e = 16
    else:
        _, routes, cap = _plan(t, k, e, 1.25, gen)
        route = "scalar"
    rnd = (lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype))
    if kind == "off_alignment":
        grad_buf = rnd(e * cap * d + 1)[1:].view(e, cap, d)
        grad_out = rnd(t * d + 1)[1:].view(t, d)
        y = rnd(e * cap * d + 1)[1:].view(e, cap, d)
    else:
        grad_buf, grad_out, y = rnd(e, cap, d), rnd(t, d), rnd(e, cap, d)
    dx, dy, dgate = _check_backward(grad_buf, grad_out, y, routes, route)
    empty = torch.arange(cap, device="cuda")[None, :] >= routes.kept[:, None]
    assert not dy[empty].any()
    if kind == "empty_expert":
        assert routes.kept[0].item() == 0 and not dy[0].any()
    if kind == "all_dropped_token":
        none = (routes.dest < 0).all(dim=1)
        assert int(none.sum()) > 0 and not dx[none].any()
        assert not torch.signbit(dx[none]).any()


def test_backward_kernels_give_the_same_bits_twice():
    gen = _gen(14)
    plan, routes, cap = _plan(512, 8, 64, 1.25, gen)
    grad_buf = torch.randn((64, cap, 256), generator=gen, device="cuda").to(torch.bfloat16)
    grad_out = torch.randn((512, 256), generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.randn((64, cap, 256), generator=gen, device="cuda").to(torch.bfloat16)
    first = _backward_both(grad_buf, grad_out, y, routes)
    again = _backward_both(grad_buf, grad_out, y, routes)
    for i in (0, 2, 4):
        assert torch.equal(first[i], again[i])


def test_a_cuda_input_that_requires_grad_gets_it_through_the_kernels():
    """Replaces the refusal B2 had before its adjoints: under grad the
    entry points take ``MoeFillFn`` and ``MoeCombineFn``, each forward and
    each backward one counted launch, the gradients the plain adjoints'."""
    t, k, e, d = 64, 8, 16, 128
    plan, routes, cap = _plan(t, k, e, 1.25, _gen(6))
    rows = torch.randn((t, d), device="cuda", requires_grad=True)
    gate = routes.gate.clone().requires_grad_(True)
    counters = (md.moe_fill, md.moe_combine, md.moe_fill_bwd, md.moe_combine_bwd)
    before = [c.launches for c in counters]
    buf = ops.fill_expert_slots(rows, routes.dest, routes.kept, cap)
    y = buf * 2.0                           # stands for the experts
    out = ops.combine_expert_rows(y, routes.dest, gate, kept=routes.kept)
    grad_out = torch.randn_like(out)
    out.backward(grad_out)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    dy, dgate = md.moe_combine_bwd_plain(grad_out, y.detach(), routes.dest, routes.gate)
    assert torch.equal(rows.grad, md.moe_fill_bwd_plain(dy * 2.0, routes.dest))
    assert _dgate_close(gate.grad, dgate, grad_out, y.detach(), routes.dest)
    with torch.no_grad():
        ops.fill_expert_slots(rows, routes.dest, routes.kept, cap)
    assert md.moe_fill.launches == before[0] + 2 and md.moe_fill_bwd.launches == before[2] + 1


def test_refusals_on_the_card():
    rows = torch.zeros((4, 8), device="cuda")
    kept = torch.zeros(2, dtype=torch.int32, device="cuda")
    dest = torch.zeros((4, 2), dtype=torch.int32, device="cuda")
    before = (md.moe_fill.launches, md.moe_combine.launches)
    with pytest.raises(TypeError, match="int32"):
        md.moe_fill(rows, dest.long(), kept, 4)
    with pytest.raises(TypeError):
        md.moe_fill(rows.half(), dest, kept, 4)
    with pytest.raises(ValueError, match="contiguous"):
        md.moe_fill(rows, dest.t().contiguous().t(), kept, 4)
    with pytest.raises(ValueError, match="on cuda"):
        md.moe_fill(rows, dest, kept.cpu(), 4)
    wide = torch.zeros((4, 33), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="k must be"):
        md.moe_combine(torch.zeros((2, 3, 8), device="cuda"), wide,
                       torch.zeros((4, 33), device="cuda"))
    with pytest.raises(TypeError, match="float32"):
        md.moe_combine(torch.zeros((2, 3, 8), device="cuda"), dest,
                       torch.zeros((4, 2), device="cuda", dtype=torch.bfloat16))
    assert (md.moe_fill.launches, md.moe_combine.launches) == before


def test_olmoe_smoke_prefill_equal_under_both_routes():
    """The smoke olmoe's prefill on the card: B2's kernels against their
    plain versions swapped into ``ops``, logits equal bit for bit, one fill
    and one combine a layer."""
    from unittest import mock
    cfg = get_smoke_config("olmoe-1b-7b")
    model = init_params(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=_gen(7), device="cuda")
    before = (md.moe_fill.launches, md.moe_combine.launches)
    with torch.inference_mode():
        got = forward_prefill(model, tokens, 65)[0]
        took = (md.moe_fill.launches - before[0], md.moe_combine.launches - before[1])
        with mock.patch.object(ops, "moe_fill", md.moe_fill_plain), \
                mock.patch.object(ops, "moe_combine", md.moe_combine_plain):
            want = forward_prefill(model, tokens, 65)[0]
    n_moe = sum(kind in (ATTN_MOE, SSM_MOE) for kind in layer_kinds(cfg))
    assert n_moe > 0 and took == (n_moe, n_moe)
    assert torch.equal(_bits(got), _bits(want))
