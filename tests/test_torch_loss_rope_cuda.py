"""B6's kernels (``csrc/cross_entropy.cu``) and B7's (``csrc/rope.cu``) on
the card, each against its plain version on the same inputs.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_loss_rope_cuda.py``.
Without a card every case skips.

* B7 rounds the position's conversion, the angle, each product and each
  sum as ``rope_plain``'s eager ops do, with the same precise ``cosf`` and
  ``sinf``: its outputs, and its adjoint's against ``rope_bwd_plain``, are
  held bit for bit.
* B6's forward sums a row's exp in f32 in its own order (by ``ex2.approx``):
  the loss within ``chip_smoke.LOSS_REL_TOL`` (1e-5) of the eager chain's,
  the rows' lse within 1e-5 of ``torch.logsumexp``'s. Its adjoint rounds
  each op as ``cross_entropy_bwd_plain`` does at the same lse: the logits'
  gradient within one ulp of their dtype (bit for bit expected).
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import cross_entropy as ce
from repro_torch.kernels import ops
from repro_torch.kernels import rope

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import LOSS_REL_TOL, ulps_apart  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = (torch.float32, torch.bfloat16)
# B6: (rows, V): phi4-mini's, mamba2's and olmoe's vocabularies at 4 x 1024
# rows, the demo's, the smoke width, odd widths (the scalar route)
LOSS_SHAPES = ((4096, 200064), (4096, 50280), (4096, 50304), (1024, 32768), (16, 512),
               (21, 1001), (5, 7))
# B7: (B, S, Hq, Hk, hd, theta): phi4's training shape, qwen3's prefill,
# kimi-k2's head_dim 112, whisper's encoder, a decode step, the smoke widths
ROPE_SHAPES = ((4, 1024, 24, 8, 128, 1e4), (4, 1024, 40, 8, 128, 1e6),
               (4, 1024, 64, 8, 112, 5e4), (4, 1500, 16, 16, 64, 1e4), (4, 1, 40, 8, 128, 1e6),
               (2, 8, 4, 2, 16, 1e4), (2, 8, 5, 1, 32, 1e4))


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


def _took(fn, before):
    return {r: fn.launches_by_route[r] - before[r] for r in fn.launches_by_route}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LOSS_SHAPES)
def test_loss_kernels_match_their_plain_versions(dtype, shape):
    rows, v = shape
    gen = _gen(rows + v)
    logits = _randn((rows, v), gen, dtype, 3.0)
    labels = torch.randint(0, v, (rows,), generator=gen, device="cuda")
    route = "vector" if v * logits.element_size() % 16 == 0 else "scalar"
    before = dict(ce.cross_entropy_fwd.launches_by_route)
    lse, nll = ce.cross_entropy_fwd(logits, labels)
    assert _took(ce.cross_entropy_fwd, before) == {r: int(r == route) for r in ce.ROUTES}
    want_lse, _ = ce.cross_entropy_fwd_plain(logits, labels)
    loss, want = float(nll.mean()), float(ce.cross_entropy_plain(logits, labels))
    assert abs(loss - want) <= LOSS_REL_TOL * abs(want)
    assert float(((lse - want_lse).abs() / want_lse.abs()).max()) <= 1e-5
    grad = torch.tensor(0.75, device="cuda")
    before = dict(ce.cross_entropy_bwd.launches_by_route)
    dx = ce.cross_entropy_bwd(grad, logits, lse, labels)
    assert _took(ce.cross_entropy_bwd, before) == {r: int(r == route) for r in ce.ROUTES}
    assert dx.dtype == dtype and dx.shape == logits.shape
    assert ulps_apart(dx, ce.cross_entropy_bwd_plain(grad, logits, lse, labels))["max_ulps"] <= 1


def test_loss_function_under_grad_and_rows_at_a_stride():
    """``ops.cross_entropy_loss`` on logits (B, S, V) taken at a row stride
    (the last rows of a wider buffer): ``CrossEntropyFn`` with the adjoint
    kernel, against autograd of the eager chain."""
    gen = _gen(7)
    buf = _randn((2, 9, 1040), gen, torch.bfloat16, 2.0)
    labels = torch.randint(0, 1024, (2, 9), generator=gen, device="cuda")
    a = buf[..., :1024].clone().requires_grad_(True)
    b = buf[..., :1024].detach().requires_grad_(True)
    strided = buf[..., :1024].detach().requires_grad_(True)
    got = ops.cross_entropy_loss(a, labels)
    assert type(got.grad_fn).__name__ == "CrossEntropyFnBackward"
    want = ce.cross_entropy_plain(b, labels)
    got.backward()
    want.backward()
    loss, plain = float(got.detach()), float(want.detach())
    assert abs(loss - plain) <= LOSS_REL_TOL * abs(plain)
    assert float((a.grad.float() - b.grad.float()).norm() / b.grad.float().norm()) <= 1e-2
    lse, nll = ce.cross_entropy_fwd(strided, labels)
    assert torch.equal(nll, ce.cross_entropy_fwd(a.detach(), labels)[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ROPE_SHAPES)
def test_rope_kernel_and_adjoint_equal_their_plain_versions(dtype, shape):
    b, s, hq, hk, hd, theta = shape
    gen = _gen(b * s + hd)
    q, k = _randn((b, s, hq, hd), gen, dtype), _randn((b, s, hk, hd), gen, dtype)
    gq, gk = _randn(q.shape, gen, dtype), _randn(k.shape, gen, dtype)
    pos = (torch.full((b, 1), 1037, device="cuda") if s == 1
           else torch.arange(s, device="cuda").expand(b, s))
    before = dict(rope.rope_qk_fwd.launches_by_route)
    oq, ok = rope.rope_qk_fwd(q, k, pos, theta)
    assert _took(rope.rope_qk_fwd, before) == {"vector": 1, "scalar": 0}
    dq, dk = rope.rope_qk_bwd(gq, gk, pos, theta)
    for got, want in ((oq, rope.rope_plain(q, pos, theta)), (ok, rope.rope_plain(k, pos, theta)),
                      (dq, rope.rope_bwd_plain(gq, pos, theta)),
                      (dk, rope.rope_bwd_plain(gk, pos, theta))):
        assert ulps_apart(got, want)["differing"] == 0


@pytest.mark.parametrize("layout", ["unaligned", "strided_heads", "int32", "rows", "k_absent"])
def test_rope_layouts(layout):
    """q and k read at their strides: one element off 16-byte alignment (the
    scalar route), heads apart in a wider buffer (q after a fused
    projection), int32 positions, random positions a row, and q alone."""
    gen = _gen(11)
    b, s, hd = 2, 33, 128
    if layout == "unaligned":
        q = _randn((b, s, 6, hd + 2), gen, torch.bfloat16)[..., 1:hd + 1]
        k = _randn((b, s, 2, hd + 2), gen, torch.bfloat16)[..., 1:hd + 1]
    else:
        qkv = _randn((b, s, 10, hd), gen, torch.bfloat16)
        q, k = qkv[:, :, :6], qkv[:, :, 6:8]
    pos = torch.arange(s, device="cuda").expand(b, s)
    if layout == "int32":
        pos = pos.int()
    elif layout == "rows":
        pos = torch.randint(0, 8192, (b, s), generator=gen, device="cuda")
    if layout == "k_absent":
        k = None
    route = "scalar" if layout == "unaligned" else "vector"
    before = dict(rope.rope_qk_fwd.launches_by_route)
    oq, ok = rope.rope_qk_fwd(q, k, pos, 1e4)
    assert _took(rope.rope_qk_fwd, before) == {r: int(r == route) for r in rope.ROUTES}
    assert ulps_apart(oq, rope.rope_plain(q, pos, 1e4))["differing"] == 0
    assert (ok is None) == (k is None)
    if k is not None:
        assert ulps_apart(ok, rope.rope_plain(k, pos, 1e4))["differing"] == 0
    dq, _ = rope.rope_qk_bwd(q, k, pos, 1e4)
    assert ulps_apart(dq, rope.rope_bwd_plain(q, pos, 1e4))["differing"] == 0


def test_rope_function_matches_autograd_of_the_plain_chain():
    """``ops.rope_qk`` under grad (``RopeFn``: the kernel, then its adjoint
    mode) against autograd through ``rope_plain``, bit for bit."""
    gen = _gen(13)
    q0, k0 = _randn((2, 64, 8, 128), gen, torch.bfloat16), _randn((2, 64, 2, 128), gen,
                                                                   torch.bfloat16)
    pos = torch.arange(64, device="cuda").expand(2, 64)
    q1, k1, q2, k2 = (t.clone().requires_grad_(True) for t in (q0, k0, q0, k0))
    got = ops.rope_qk(q1, k1, pos, 1e4)
    assert type(got[0].grad_fn).__name__ == "RopeFnBackward"
    want = (rope.rope_plain(q2, pos, 1e4), rope.rope_plain(k2, pos, 1e4))
    gs = [_randn(t.shape, gen, torch.bfloat16) for t in want]
    before = rope.rope_qk_bwd.launches
    torch.autograd.backward(list(got), gs)
    assert rope.rope_qk_bwd.launches == before + 1
    torch.autograd.backward(list(want), gs)
    for a, b in ((got[0], want[0]), (got[1], want[1]), (q1.grad, q2.grad), (k1.grad, k2.grad)):
        assert ulps_apart(a, b)["differing"] == 0


def test_refusals_raise_before_any_launch():
    q = torch.randn(2, 4, 3, 15, device="cuda")
    pos = torch.arange(4, device="cuda").expand(2, 4)
    before = rope.rope_qk_fwd.launches
    with pytest.raises(ValueError, match="hd even"):
        rope.rope_qk_fwd(q, None, pos, 1e4)
    with pytest.raises(ValueError, match="labels int64"):
        ce.cross_entropy_fwd(torch.randn(3, 10, device="cuda"),
                             torch.zeros(3, dtype=torch.int32, device="cuda"))
    assert rope.rope_qk_fwd.launches == before
