"""B8's kernels (``csrc/swiglu.cu``) on the card, each against its plain
version on the same inputs.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_swiglu_cuda.py``.
Without a card every case skips.

B8 rounds ``silu(g)``, the product, ``dh·u``, ``dh·silu(g)`` and SiLU's
derivative where ``F.silu(g) * u`` and its autograd round them, with the
same exact ``expf`` and IEEE divisions: its forward is held to
``swiglu_plain`` and its adjoint to ``swiglu_bwd_plain`` (the ops autograd
calls) bit for bit, NaN where they are NaN, at every shape of
``chip_smoke.SWIGLU_CHECKS``, on both routes, and on every bf16 g.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import swiglu as sw

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import SWIGLU_CHECKS, bits, swiglu_sweep  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _randn(shape, gen, dtype, scale=2.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _took(fn, before):
    return {r: fn.launches_by_route[r] - before[r] for r in fn.launches_by_route}


def _same(got, want):
    nan = torch.isnan(want)
    return (bool(torch.equal(torch.isnan(got), nan))
            and bool(torch.equal(bits(got)[~nan], bits(want)[~nan])))


def _inputs(shape, dtype, layout, gen):
    """g, u and dh of ``shape``: contiguous; ``strided``: the columns of
    wider rows (a row stride past the width, 16-byte aligned); ``unaligned``:
    one element past a 16-byte boundary (the scalar route)."""
    def one():
        if layout == "contiguous":
            return _randn(shape, gen, dtype)
        pad = 8 if layout == "strided" else 2
        wide = _randn((*shape[:-1], shape[-1] + pad), gen, dtype)
        return wide[..., :shape[-1]] if layout == "strided" else wide[..., 1:shape[-1] + 1]
    return one(), one(), one()


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", SWIGLU_CHECKS, ids=[c[0] for c in SWIGLU_CHECKS])
def test_kernels_match_their_plain_versions_bit_for_bit(case, dtype):
    """Forward and adjoint at every shape ``chip_smoke.py`` checks, in f32
    and bf16, one launch each on the route the width gives."""
    label, _, shape = case
    gen = _gen(sum(shape))
    g, u, dh = _inputs(shape, dtype, "contiguous", gen)
    route = "vector" if shape[-1] * g.element_size() % 16 == 0 else "scalar"
    one = {r: int(r == route) for r in sw.ROUTES}
    before = dict(sw.swiglu_fwd.launches_by_route)
    h = sw.swiglu_fwd(g, u)
    assert _took(sw.swiglu_fwd, before) == one
    before = dict(sw.swiglu_bwd.launches_by_route)
    dg, du = sw.swiglu_bwd(dh, g, u)
    assert _took(sw.swiglu_bwd, before) == one
    want_dg, want_du = sw.swiglu_bwd_plain(dh, g, u)
    torch.cuda.synchronize()
    assert h.shape == g.shape and h.is_contiguous() and h.dtype == dtype
    assert _same(h, sw.swiglu_plain(g, u)) and _same(dg, want_dg) and _same(du, want_du)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("layout", ["strided", "unaligned"])
@pytest.mark.parametrize("shape", [(4, 64, 1024), (3, 5, 264), (1, 1, 16), (2, 9)])
def test_strided_layouts_take_their_route(shape, layout, dtype):
    """Rows evenly spaced past the width read at their stride (``vector``
    where the width is whole 16-byte units and the stride and pointers
    16-byte aligned, else ``scalar``), the outputs contiguous and equal to
    the plain versions bit for bit."""
    gen = _gen(len(shape) + shape[-1])
    g, u, dh = _inputs(shape, dtype, layout, gen)
    whole = shape[-1] * g.element_size() % 16 == 0
    route = "vector" if layout == "strided" and whole else "scalar"
    before = (dict(sw.swiglu_fwd.launches_by_route), dict(sw.swiglu_bwd.launches_by_route))
    h = sw.swiglu_fwd(g, u)
    dg, du = sw.swiglu_bwd(dh, g, u)
    one = {r: int(r == route) for r in sw.ROUTES}
    assert _took(sw.swiglu_fwd, before[0]) == one and _took(sw.swiglu_bwd, before[1]) == one
    want_dg, want_du = sw.swiglu_bwd_plain(dh, g, u)
    torch.cuda.synchronize()
    assert h.is_contiguous() and dg.is_contiguous() and du.is_contiguous()
    assert _same(h, sw.swiglu_plain(g, u)) and _same(dg, want_dg) and _same(du, want_du)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_every_bf16_g_with_several_gradients(dtype):
    """Every bf16 bit pattern as g (in f32 its f32 value), each beside eight
    dh and u: the forward equal to ``F.silu(g) * u`` and the adjoint to that
    chain's autograd, bit for bit, NaN where they are NaN."""
    result = swiglu_sweep(dtype, _gen(3))
    assert result["ok"], result


def test_function_equals_autograd_of_the_eager_chain():
    """``ops.silu_mul`` under grad (``SwigluFn``: both kernels) against
    autograd through ``F.silu(g) * u``, with a non-contiguous dh."""
    gen = _gen(7)
    gn, un = _randn((4, 33, 256), gen, torch.bfloat16), _randn((4, 33, 256), gen, torch.bfloat16)
    g1, u1 = gn.clone().requires_grad_(True), un.clone().requires_grad_(True)
    g2, u2 = gn.clone().requires_grad_(True), un.clone().requires_grad_(True)
    got = ops.silu_mul(g1, u1)
    assert type(got.grad_fn).__name__ == "SwigluFnBackward"
    want = torch.nn.functional.silu(g2) * u2
    dh = _randn((256, 33, 4), gen, torch.bfloat16).transpose(0, 2)
    got.backward(dh)
    want.backward(dh)
    assert _same(got.detach(), want.detach())
    assert _same(g1.grad, g2.grad) and _same(u1.grad, u2.grad)


def test_refusals_raise_before_any_launch():
    gen = _gen(9)
    g = _randn((4, 64), gen, torch.bfloat16)
    before = (sw.swiglu_fwd.launches, sw.swiglu_bwd.launches)
    for u, msg in ((g.float(), "one dtype"), (g[:, :32], "one shape"),
                   (g.half(), "one dtype"), (g.t().contiguous().t(), "last dim contiguous")):
        with pytest.raises(ValueError, match=msg):
            sw.swiglu_fwd(g, u)
    with pytest.raises(ValueError, match="f32 or bf16"):
        sw.swiglu_fwd(g.half(), g.half())
    assert (sw.swiglu_fwd.launches, sw.swiglu_bwd.launches) == before


def test_attributes_report_registers():
    for dtype in (torch.float32, torch.bfloat16):
        for bwd in (False, True):
            a = sw.attributes(dtype, bwd, torch.cuda.current_device())
            assert 0 < a["registers"] <= 255 and a["local_bytes"] >= 0
