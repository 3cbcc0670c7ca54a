"""B2's kernels (``csrc/moe_dispatch.cu``) on the card.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_moe_dispatch_cuda.py``.
Without a card every case skips.

The fill is a copy and the combine rounds every product and sum as
``moe_combine_plain``'s eager ops do, so both are held to their plain
versions bit for bit (``torch.equal`` on the bits), with no tolerance.
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
# width, an odd width (the scalar route), one token, heavy drops, jamba's k
SHAPES = {
    "olmoe_narrow": (512, 8, 64, 256, 1.25),
    "odd_width": (96, 4, 16, 77, 1.25),
    "one_token": (1, 8, 64, 128, 1.25),
    "drops": (256, 8, 64, 128, 0.5),
    "k2": (300, 2, 16, 136, 1.25),
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
    plan, its sorted gates (f32) and the capacity."""
    scores = torch.rand((t, e), generator=gen, device="cuda")
    gates, idx = torch.topk(scores, k, dim=-1)
    gates = gates.clamp(min=1e-3)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    cap = moe.capacity(t, k, e, cf)
    plan = moe.dispatch_plan(idx, e, cap)
    return plan, gates.reshape(-1)[plan.order].float(), cap


def _bits(a):
    return a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)


def _fill_both(rows, src, fill):
    before = (md.moe_fill.launches, dict(md.moe_fill.launches_by_route))
    got = md.moe_fill(rows, src, fill)
    took = md.moe_fill.launches - before[0]
    routes = {r: md.moe_fill.launches_by_route[r] - before[1][r] for r in md.ROUTES}
    want = md.moe_fill_plain(rows, src, fill)
    torch.cuda.synchronize()
    return got, want, took, routes


def _combine_both(y, plan, gate, k, keep=None):
    keep = plan.keep if keep is None else keep
    before = (md.moe_combine.launches, dict(md.moe_combine.launches_by_route))
    got = md.moe_combine(y, plan.expert, plan.slot, gate, keep, plan.order, k)
    took = md.moe_combine.launches - before[0]
    routes = {r: md.moe_combine.launches_by_route[r] - before[1][r] for r in md.ROUTES}
    want = md.moe_combine_plain(y, plan.expert, plan.slot, gate, keep, plan.order, k)
    torch.cuda.synchronize()
    return got, want, took, routes


def _want_route(d, dtype):
    return "vector" if d * torch.empty((), dtype=dtype).element_size() % 16 == 0 else "scalar"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fill_equals_plain(shape, dtype):
    t, k, e, d, cf = SHAPES[shape]
    gen = _gen(0)
    plan, _, cap = _plan(t, k, e, cf, gen)
    rows = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    src = moe.slot_sources(plan, e, cap, t)
    got, want, took, routes = _fill_both(rows, src, t)
    assert got.is_contiguous() and got.shape == want.shape == (e, cap, d)
    assert torch.equal(_bits(got), _bits(want))
    route = _want_route(d, dtype)
    assert took == 1 and routes == {r: int(r == route) for r in md.ROUTES}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_combine_equals_plain(shape, dtype):
    t, k, e, d, cf = SHAPES[shape]
    gen = _gen(1)
    plan, gate, cap = _plan(t, k, e, cf, gen)
    y = torch.randn((e, cap, d), generator=gen, device="cuda").to(dtype)
    y[:, :, 0] = -0.0                       # sums of signed zeros in one column
    got, want, took, routes = _combine_both(y, plan, gate, k)
    assert got.shape == want.shape == (t, d)
    assert torch.equal(_bits(got), _bits(want))
    route = _want_route(d, dtype)
    assert took == 1 and routes == {r: int(r == route) for r in md.ROUTES}


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
    src = moe.slot_sources(plan, e, cap, t)
    assert bool((src[0] == t).all()) and bool((src[1] != t).all())
    rows = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    got, want, _, _ = _fill_both(rows, src, t)
    assert torch.equal(_bits(got), _bits(want)) and not got[0].any()
    gate = torch.rand(t * k, generator=gen, device="cuda")
    y = torch.randn((e, cap, d), generator=gen, device="cuda").to(dtype)
    got, want, _, _ = _combine_both(y, plan, gate, k)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_sentinels_and_all_dropped(dtype):
    t, e, cap, d, k = 16, 4, 3, 40, 2
    rows = torch.randn((t, d), device="cuda").to(dtype)
    src = torch.full((e, cap), t, dtype=torch.int32, device="cuda")
    got, want, took, _ = _fill_both(rows, src, t)
    assert took == 1 and torch.equal(_bits(got), _bits(want)) and not got.any()
    plan, gate, _ = _plan(t, k, e, 1.0, _gen(3))
    y = torch.randn((e, plan.slot.max().item() + 1, d), device="cuda").to(dtype)
    none = torch.zeros_like(plan.keep)
    got, want, _, _ = _combine_both(y, plan, gate, k, keep=none)
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.signbit(got).any()     # +0.0 throughout


@pytest.mark.parametrize("dtype", DTYPES)
def test_views_off_alignment_take_the_scalar_route(dtype):
    t, k, e, d = 64, 4, 8, 64
    gen = _gen(4)
    plan, gate, cap = _plan(t, k, e, 1.25, gen)
    base = torch.randn(t * d + 1, generator=gen, device="cuda").to(dtype)
    rows = base[1:].view(t, d)              # one element off 16 bytes
    src = moe.slot_sources(plan, e, cap, t)
    got, want, _, routes = _fill_both(rows, src, t)
    assert torch.equal(_bits(got), _bits(want)) and routes["scalar"] == 1
    ybase = torch.randn(e * cap * d + 1, generator=gen, device="cuda").to(dtype)
    y = ybase[1:].view(e, cap, d)
    got, want, _, routes = _combine_both(y, plan, gate, k)
    assert torch.equal(_bits(got), _bits(want)) and routes["scalar"] == 1


def test_f32_rows_over_the_witness_buffer():
    """The f32 witness: x and the buffer f32, the combine over f32 experts'
    output."""
    t, k, e, d = 256, 8, 64, 128
    gen = _gen(5)
    plan, gate, cap = _plan(t, k, e, 1.25, gen)
    rows = torch.randn((t, d), generator=gen, device="cuda")
    got, want, _, _ = _fill_both(rows, moe.slot_sources(plan, e, cap, t), t)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    y = torch.randn((e, cap, d), generator=gen, device="cuda")
    got, want, _, _ = _combine_both(y, plan, gate, k)
    assert got.dtype == torch.float32 and torch.equal(_bits(got), _bits(want))


def test_a_cuda_input_that_requires_grad_raises():
    t, k, e, d = 32, 2, 4, 16
    plan, gate, cap = _plan(t, k, e, 1.25, _gen(6))
    rows = torch.randn((t, d), device="cuda", requires_grad=True)
    src = moe.slot_sources(plan, e, cap, t)
    before = (md.moe_fill.launches, md.moe_combine.launches)
    with pytest.raises(NotImplementedError, match="fill_expert_slots"):
        ops.fill_expert_slots(rows, src, t)
    y = torch.randn((e, cap, d), device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="combine_expert_rows"):
        ops.combine_expert_rows(y, plan.expert, plan.slot, gate, plan.keep, plan.order, k)
    assert (md.moe_fill.launches, md.moe_combine.launches) == before
    with torch.no_grad():
        ops.fill_expert_slots(rows, src, t)
    assert md.moe_fill.launches == before[0] + 1


def test_refusals_on_the_card():
    rows = torch.zeros((4, 8), device="cuda")
    with pytest.raises(TypeError, match="int32"):
        md.moe_fill(rows, torch.zeros((2, 2), dtype=torch.long, device="cuda"), 4)
    with pytest.raises(TypeError):
        md.moe_fill(rows.half(), torch.zeros((2, 2), dtype=torch.int32, device="cuda"), 4)
    n = 2 * 33
    plan = [torch.zeros(n, dtype=torch.long, device="cuda")] * 2
    with pytest.raises(ValueError, match="k must be"):
        md.moe_combine(torch.zeros((2, 3, 8), device="cuda"), *plan,
                       torch.zeros(n, device="cuda"), torch.zeros(n, dtype=torch.bool,
                                                                  device="cuda"),
                       torch.arange(n, device="cuda"), 33)


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
