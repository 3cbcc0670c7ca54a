"""B6 (the training loss) and B7 (RoPE of q and k) on the CPU: their plain
versions and ``autograd.Function``s against the reference's
``cross_entropy_loss`` and ``apply_rope`` (with ``jax.value_and_grad`` and
``jax.vjp``), the Functions against autograd of the plain forwards, the
meta and ``DTensor`` routes, the layouts the model hands the kernels, and
the launches ``chip_smoke.py`` expects of them against the calls a prefill,
decode steps and a train step make.

The same inputs, made from a seed with numpy, go through both frameworks.
Tolerances:

* f32: the loss within 1e-6 relative (the port's lse - x[label] against
  the reference's -log_softmax[label]: the same f32 arithmetic in another
  order, a few ulps of a value near ln V); gradients within 1e-5 relative
  L2 (f32 exp and sums in another order); RoPE's output within 1e-5
  relative L2 (XLA's and PyTorch's f32 cos and sin may differ by an ulp).
* bf16: the port at bf16 inputs against the reference evaluated in f32 at
  the same bf16 values. RoPE: each element of the output and of the
  gradient within one bf16 ulp of the f32 value (the port rounds the same
  f32 arithmetic once: half an ulp, plus the trigonometry's ulp of f32).
  The loss: within 1e-6 relative (it is f32 arithmetic on the same values;
  the logits' cast to f32 is exact); the logits' gradient within 2^-8
  relative L2 (it is the f32 gradient rounded once to bf16: at most half
  a bf16 ulp, 2^-9 of each element).
* The Functions against autograd of the plain forwards: RoPE bit for bit
  (the plain adjoint is autograd's arithmetic written out); the loss in
  f32 within 1e-6 (loss) and 1e-5 (gradient), its adjoint's exp(x - lse)
  against autograd's softmax.
"""
import re
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro.train.loop import cross_entropy_loss as jax_cross_entropy_loss
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import cross_entropy as ce
from repro_torch.kernels import ops
from repro_torch.kernels import rope
from repro_torch.launch.serve import stub_cross_src
from repro_torch.models import (forward_decode, forward_prefill, forward_train, init_params,
                                layers)
from repro_torch.train import cross_entropy_loss

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _jf32(a: np.ndarray, dtype: str):
    """``a`` rounded to ``dtype``, as an f32 JAX array: the reference
    evaluated in f32 at the values the port takes."""
    return jnp.asarray(a).astype(JNP[dtype]).astype(jnp.float32)


def _within_one_ulp(got: torch.Tensor, want: np.ndarray) -> bool:
    """Each bf16 element of ``got`` within one bf16 ulp of the f32 ``want``."""
    w = torch.from_numpy(np.array(want, dtype=np.float32))
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8).clamp_min(2.0 ** -133)
    return bool(((got.float() - w).abs() <= ulp).all())


# ---------------------------------------------------------------------------
# B6: the loss against the reference
# ---------------------------------------------------------------------------

# jitted once a shape: JAX's eager ops would compile each primitive apart
_LOSS_VG = jax.jit(jax.value_and_grad(jax_cross_entropy_loss))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 33), (3, 4, 512), (1, 7, 1000)])
def test_loss_and_gradient_match_reference_value_and_grad(dtype, shape):
    """``ops.cross_entropy_loss`` and its gradient (``CrossEntropyFn`` over
    the plain forward and adjoint on the CPU) against
    ``jax.value_and_grad`` of the reference's ``cross_entropy_loss``, an odd
    vocabulary included."""
    rng = np.random.default_rng(sum(shape))
    x = _normal(rng, *shape, scale=3.0)
    labels = rng.integers(0, shape[-1], shape[:-1])
    logits = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_(True)
    loss = ops.cross_entropy_loss(logits, torch.from_numpy(labels))
    assert type(loss.grad_fn).__name__ == "CrossEntropyFnBackward"
    loss.backward()
    want, grad = _LOSS_VG(_jf32(x, dtype), jnp.asarray(labels))
    assert abs(float(loss.detach()) - float(want)) <= 1e-6 * abs(float(want))
    assert logits.grad.dtype == TORCH[dtype]
    assert _rel(logits.grad, _np(grad)) <= (1e-5 if dtype == "float32" else 2.0 ** -8)


def test_train_loop_loss_is_b6_and_keeps_its_name():
    """``train.cross_entropy_loss`` (the default ``loss_fn`` of
    ``train_step``) routes through ``ops.cross_entropy_loss``; without grad
    it is the forward's mean, equal to the reference's value."""
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 3, 40)
    labels = rng.integers(0, 40, (2, 3))
    with mock.patch.object(ops, "cross_entropy_loss", wraps=ops.cross_entropy_loss) as spy:
        got = cross_entropy_loss(torch.from_numpy(x), torch.from_numpy(labels))
    assert spy.call_count == 1 and got.dim() == 0
    want = float(jax_cross_entropy_loss(jnp.asarray(x), jnp.asarray(labels)))
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_loss_function_matches_autograd_of_the_plain_chain():
    """``CrossEntropyFn`` against autograd through ``cross_entropy_plain``."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_normal(rng, 4, 6, 77, scale=4.0))
    labels = torch.from_numpy(rng.integers(0, 77, (4, 6)))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got, want = ce.CrossEntropyFn.apply(a, labels), ce.cross_entropy_plain(b, labels)
    (got * 1.5).backward()
    (want * 1.5).backward()
    assert abs(float(got.detach()) - float(want.detach())) <= 1e-6 * abs(float(want.detach()))
    assert float((a.grad - b.grad).norm() / b.grad.norm()) <= 1e-5


def test_loss_plain_adjoint_is_the_stated_arithmetic():
    """``cross_entropy_bwd_plain``: exp(x - lse), minus 1 at the label,
    times g / rows by a tensor division, rounded once; the label's element
    the only one below zero."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_normal(rng, 3, 50)).bfloat16()
    labels = torch.from_numpy(rng.integers(0, 50, (3,)))
    lse, nll = ce.cross_entropy_fwd_plain(x, labels)
    g = torch.tensor(2.0)
    d = ce.cross_entropy_bwd_plain(g, x, lse, labels)
    p = torch.exp(x.float() - lse[:, None])
    p[torch.arange(3), labels] -= 1.0
    assert torch.equal(d, (p * (g / torch.tensor(3.0))).bfloat16())
    assert torch.equal((d < 0).nonzero()[:, 1], labels)
    assert torch.allclose(nll, lse - x.float()[torch.arange(3), labels])


# ---------------------------------------------------------------------------
# B7: RoPE against the reference
# ---------------------------------------------------------------------------

ROPE_CASES = [  # (B, S, Hq, Hk, hd, theta, positions)
    (2, 6, 4, 2, 128, 10_000.0, "arange"),
    (2, 6, 8, 1, 112, 50_000.0, "arange"),
    (2, 9, 4, 4, 64, 10_000.0, "arange"),
    (3, 1, 6, 2, 128, 1_000_000.0, "decode"),
    (2, 5, 3, 3, 16, 10_000.0, "rows"),
]


def _positions(kind: str, b: int, s: int, rng) -> np.ndarray:
    if kind == "arange":                 # the model's arange(S).expand(B, S): batch stride 0
        return np.broadcast_to(np.arange(s), (b, s))
    if kind == "decode":                 # a decode step: one position a row, past the prompt
        return np.full((b, 1), 1037)
    return rng.integers(0, 4000, (b, s))


def _torch_positions(p: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(p))
    if p.strides[0] == 0:
        t = torch.arange(p.shape[1]).expand(p.shape)
        assert t.stride(0) == 0
    return t


def _rope_vjp(q, k, gq, gk, pos, theta: float):
    """The reference's ``apply_rope`` of q and k (one call over their heads
    side by side) and its ``jax.vjp`` at (gq, gk): ((q's output, dq), (k's
    output, dk)). Run op by op, not jitted: under ``jax.jit`` XLA folds the
    frequencies as constants, in other bits than its ops compute them."""
    hq = q.shape[2]
    y, vjp = jax.vjp(lambda a: jax_layers.apply_rope(a, pos, theta),
                     jnp.concatenate([q, k], axis=2))
    (dx,) = vjp(jnp.concatenate([gq, gk], axis=2))
    return (y[:, :, :hq], dx[:, :, :hq]), (y[:, :, hq:], dx[:, :, hq:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ROPE_CASES)
def test_rope_and_its_adjoint_match_reference_apply_rope_and_vjp(dtype, case):
    """``ops.rope_qk`` (``RopeFn`` on the CPU: the plain forward and adjoint)
    against the reference's ``apply_rope`` of q and of k and its
    ``jax.vjp``: head_dim 128, 112 and 64, a decode step at an offset
    position, positions with batch stride 0, random positions."""
    b, s, hq, hk, hd, theta, kind = case
    rng = np.random.default_rng(hd + s)
    qn, kn = _normal(rng, b, s, hq, hd), _normal(rng, b, s, hk, hd)
    gqn, gkn = _normal(rng, b, s, hq, hd), _normal(rng, b, s, hk, hd)
    pos = _positions(kind, b, s, rng)
    q, k = (torch.from_numpy(a).to(TORCH[dtype]).requires_grad_(True) for a in (qn, kn))
    oq, ok = ops.rope_qk(q, k, _torch_positions(pos), theta)
    assert type(oq.grad_fn).__name__ == "RopeFnBackward"
    torch.autograd.backward([oq, ok], [torch.from_numpy(gqn).to(TORCH[dtype]),
                                       torch.from_numpy(gkn).to(TORCH[dtype])])
    wants = _rope_vjp(*(_jf32(a, dtype) for a in (qn, kn, gqn, gkn)), jnp.asarray(pos), theta)
    for got, dgot, (want, dwant) in ((oq, q.grad, wants[0]), (ok, k.grad, wants[1])):
        assert got.dtype == dgot.dtype == TORCH[dtype]
        if dtype == "float32":
            assert _rel(got, _np(want)) <= 1e-5 and _rel(dgot, _np(dwant)) <= 1e-5
        else:
            assert _within_one_ulp(got, _np(want)) and _within_one_ulp(dgot, _np(dwant))


def test_apply_rope_keeps_its_signature_through_b7():
    """``layers.apply_rope`` of one tensor routes through ``ops.rope_qk``
    with no k; ``layers.rope_frequencies`` is the cached frequencies' op."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_normal(rng, 2, 4, 3, 32))
    pos = torch.arange(4).expand(2, 4)
    with mock.patch.object(ops, "rope_qk", wraps=ops.rope_qk) as spy:
        got = layers.apply_rope(x, pos, 10_000.0)
    assert spy.call_count == 1 and spy.call_args.args[1] is None
    assert torch.equal(got, rope.rope_plain(x, pos, 10_000.0))
    assert layers.rope_frequencies is rope.rope_frequencies


def test_rope_function_equals_autograd_of_the_plain_chain_bit_for_bit():
    """``RopeFn``'s backward (``rope_bwd_plain`` on the CPU) equals autograd
    through ``rope_plain`` bit for bit, in f32 and bf16, and k may be
    absent."""
    rng = np.random.default_rng(2)
    pos = torch.arange(7).expand(2, 7)
    for dtype in (torch.float32, torch.bfloat16):
        qn, kn = _normal(rng, 2, 7, 4, 64), _normal(rng, 2, 7, 2, 64)
        q1, k1, q2, k2 = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                          for a in (qn, kn, qn, kn))
        got = rope.RopeFn.apply(q1, k1, pos, 500_000.0)
        want = (rope.rope_plain(q2, pos, 500_000.0), rope.rope_plain(k2, pos, 500_000.0))
        gs = [torch.from_numpy(_normal(rng, *t.shape)).to(dtype) for t in want]
        torch.autograd.backward(list(got), gs)
        torch.autograd.backward(list(want), gs)
        for a, b in ((got[0], want[0]), (got[1], want[1]), (q1.grad, q2.grad), (k1.grad, k2.grad)):
            assert torch.equal(a, b)
        alone, none = rope.RopeFn.apply(q1.detach().requires_grad_(True), None, pos, 500_000.0)
        assert none is None and torch.equal(alone, want[0])


def test_cached_frequencies_are_the_plain_ops_bits_made_once():
    for hd, theta in ((128, 10_000.0), (112, 50_000.0), (64, 1e6)):
        f = rope.cached_frequencies(hd, theta, torch.device("cpu"))
        assert torch.equal(f, rope.rope_frequencies(hd, theta))
        assert rope.cached_frequencies(hd, theta, "cpu") is f
        np.testing.assert_allclose(f.numpy(), np.asarray(jax_layers.rope_frequencies(hd, theta)),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

def test_meta_tensors_keep_the_eager_chains():
    """On meta tensors (the dry run) both entry points run the eager chains:
    the same shapes and dtypes, no Function."""
    x = torch.empty(2, 5, 40, device="meta", dtype=torch.bfloat16, requires_grad=True)
    loss = ops.cross_entropy_loss(x, torch.empty(2, 5, dtype=torch.int64, device="meta"))
    assert loss.is_meta and loss.shape == () and loss.dtype == torch.float32
    assert type(loss.grad_fn).__name__ != "CrossEntropyFnBackward"
    q = torch.empty(2, 5, 4, 16, device="meta", dtype=torch.bfloat16, requires_grad=True)
    k = torch.empty(2, 5, 2, 16, device="meta", dtype=torch.bfloat16)
    pos = torch.arange(5, device="meta").expand(2, 5)
    oq, ok = ops.rope_qk(q, k, pos, 10_000.0)
    assert oq.is_meta and oq.shape == q.shape and ok.shape == k.shape
    assert oq.dtype == torch.bfloat16 and type(oq.grad_fn).__name__ != "RopeFnBackward"
    with mock.patch.object(ops, "rope_plain", wraps=ops.rope_plain) as spy:
        ops.rope_qk(q, k, pos, 10_000.0)
    assert spy.call_count == 2


def test_no_grad_routes_call_the_forward_wrappers():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_normal(rng, 2, 3, 20))
    labels = torch.from_numpy(rng.integers(0, 20, (2, 3)))
    q, k = torch.from_numpy(_normal(rng, 2, 3, 2, 8)), torch.from_numpy(_normal(rng, 2, 3, 1, 8))
    pos = torch.arange(3).expand(2, 3)
    with torch.no_grad(), mock.patch.object(ops, "cross_entropy_fwd",
                                            wraps=ops.cross_entropy_fwd) as fwd, \
            mock.patch.object(ops, "rope_qk_fwd", wraps=ops.rope_qk_fwd) as rfwd:
        loss = ops.cross_entropy_loss(x.requires_grad_(True), labels)
        oq, ok = ops.rope_qk(q, k, pos, 1e4)
    assert fwd.call_count == 1 and rfwd.call_count == 1 and loss.grad_fn is None
    assert torch.allclose(loss, ce.cross_entropy_plain(x.detach(), labels), rtol=1e-6)


def test_rope_runs_dtensors_on_their_shards():
    """A ``DTensor`` q and k (here on the 1×1 CPU mesh) go to the shard path
    with plain positions taken as replicated: the same values and
    gradients as the plain tensors'."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import mesh as mesh_mod
    rng = np.random.default_rng(8)
    qn, kn = _normal(rng, 2, 5, 4, 16), _normal(rng, 2, 5, 2, 16)
    pos = torch.arange(5).expand(2, 5)
    mesh = mesh_mod.make_host_mesh("cpu")
    try:
        placed = [DTensor.from_local(torch.from_numpy(a), mesh, [Replicate()] * 2)
                  .requires_grad_(True) for a in (qn, kn)]
        plain = [torch.from_numpy(a).requires_grad_(True) for a in (qn, kn)]
        with mock.patch.object(ops, "_rope_on_shards", wraps=ops._rope_on_shards) as spy:
            got = ops.rope_qk(*placed, pos, 10_000.0)
        want = ops.rope_qk(*plain, pos, 10_000.0)
        assert spy.call_count == 1 and all(isinstance(t, DTensor) for t in got)
        for a, b in zip(got, want):
            assert torch.equal(a.to_local(), b)
        gs = [torch.from_numpy(_normal(rng, *t.shape)) for t in want]
        torch.autograd.backward(list(got), [DTensor.from_local(g, mesh, [Replicate()] * 2)
                                            for g in gs])
        torch.autograd.backward(list(want), gs)
        for a, b in zip(placed, plain):
            assert torch.equal(a.grad.to_local(), b.grad)
    finally:
        mesh_mod.release()


# ---------------------------------------------------------------------------
# the kernels' checks and plans
# ---------------------------------------------------------------------------

def test_kernel_checks_take_the_layouts_the_model_hands_over():
    """Every condition of the card's checks holds for the model's layouts
    (evaluated on CPU tensors: they read shapes, dtypes, strides and
    devices only): q and k after ``_proj`` and after B4, positions as
    ``arange(S).expand`` and as a decode step's ``full``; the logits."""
    from repro_torch.kernels.build import require
    from repro_torch.kernels.rms_norm import _row_stride
    x = torch.randn(2, 6, 64).bfloat16()
    q = (x @ torch.randn(64, 4 * 16).bfloat16()).unflatten(-1, (4, 16))
    k = ops.rms_norm((x @ torch.randn(64, 2 * 16).bfloat16()).unflatten(-1, (2, 16)),
                     torch.ones(16, dtype=torch.bfloat16))
    for pos in (torch.arange(6).expand(2, 6), torch.full((2, 1), 9)):
        qq, kk = (q, k) if pos.shape[1] == 6 else (q[:, :1], k[:, :1])
        require("rope", rope.rope_checks(qq, kk, pos), qq, kk, pos)
    logits = torch.randn(2, 6, 50).bfloat16()
    labels = torch.randint(0, 50, (2, 6))
    require("loss", ce.loss_checks(logits, labels, _row_stride(logits)), logits, labels)


@pytest.mark.parametrize("case,want", [
    ("hd_odd", "hd even"), ("k_width", "k of q's"), ("pos_float", "positions int64"),
    ("q_3d", "q \\(B, S, Hq, hd\\)"), ("last_strided", "last dims contiguous"),
    ("labels_int32", "labels int64"), ("logits_f16", "logits f32 or bf16")])
def test_kernel_checks_refuse_with_the_failed_condition(case, want):
    from repro_torch.kernels.build import require
    from repro_torch.kernels.rms_norm import _row_stride
    q, k, pos = torch.randn(2, 3, 4, 16), torch.randn(2, 3, 2, 16), torch.arange(3).expand(2, 3)
    logits, labels = torch.randn(2, 3, 10), torch.randint(0, 10, (2, 3))
    rope_args = {"hd_odd": (torch.randn(2, 3, 4, 15), None, pos),
                 "k_width": (q, torch.randn(2, 3, 2, 8), pos),
                 "pos_float": (q, k, pos.float()), "q_3d": (q[0], k, pos),
                 "last_strided": (q.transpose(2, 3), None, pos)}
    with pytest.raises(ValueError, match=want):
        if case in rope_args:
            args = rope_args[case]
            require("rope", rope.rope_checks(*args), *args)
        else:
            lg = logits.half() if case == "logits_f16" else logits
            lb = labels.int() if case == "labels_int32" else labels
            require("loss", ce.loss_checks(lg, lb, _row_stride(lg)), lg, lb)


@pytest.mark.parametrize("heads,units,half", [(32, 8, 64), (48, 8, 64), (72, 7, 56),
                                              (2, 1, 8), (3000, 64, 64), (4, 1, 4000)])
def test_rope_tokens_a_block(heads, units, half):
    """About ``ITEMS`` (head, unit) pairs a block, at least one token, at most
    ``MAX_TB``, the cos and sin within the shared memory the launch takes
    without opting in."""
    tb = rope.tokens_a_block(heads, units, half)
    assert 1 <= tb <= rope.MAX_TB
    assert tb == 1 or tb * heads * units <= rope.ITEMS
    assert 8 * tb * half + 16 * tb <= rope.SMEM or tb == 1


def test_the_cu_constants_match_the_bindings():
    src = (CSRC / "rope.cu").read_text()
    for name, value in (("THREADS", rope.THREADS), ("NI", rope.NI)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    modes = dict(re.findall(r"(MODE_\w+) = (\d+)", src))
    assert (int(modes["MODE_VECTOR"]), int(modes["MODE_DTYPE"]), int(modes["MODE_BWD"]),
            int(modes["MODE_POS32"]), int(modes["MODE_DEVICE_SHIFT"])) == (
        rope._MODE_VECTOR, rope._MODE_DTYPE, rope._MODE_BWD, rope._MODE_POS32,
        rope._MODE_DEVICE_SHIFT)
    src = (CSRC / "cross_entropy.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    unroll = int(re.search(r"constexpr int UNROLL = (\d+);", src).group(1))
    assert threads * unroll == ce._BWD_UNITS
    modes = dict(re.findall(r"(MODE_\w+) = (\d+)", src))
    assert (int(modes["MODE_VECTOR"]), int(modes["MODE_DTYPE"]),
            int(modes["MODE_DEVICE_SHIFT"])) == (ce._MODE_VECTOR, ce._MODE_DTYPE,
                                                 ce._MODE_DEVICE_SHIFT)


# ---------------------------------------------------------------------------
# the launches chip_smoke.py expects, against the calls a forward makes
# ---------------------------------------------------------------------------

WRAPPERS = {"cross_entropy_fwd": ce, "cross_entropy_bwd": ce, "rope_qk_fwd": rope,
            "rope_qk_bwd": rope}


def _counting(calls):
    """Every B6/B7 wrapper, where ``ops`` and the Functions call it, wrapped
    to count its calls into ``calls``."""
    stack = []
    for name, module in WRAPPERS.items():
        real = getattr(module, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        stack.append(mock.patch.object(module, name, counted))
        if hasattr(ops, name):
            stack.append(mock.patch.object(ops, name, counted))
    return stack


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b", "olmoe-1b-7b", "kimi-k2-1t-a32b",
                                  "jamba-1.5-large-398b", "whisper-medium",
                                  "llama-3.2-vision-11b", "phi4-mini-3.8b"])
def test_expected_launches_count_every_rope_and_loss(arch):
    """A prefill and two decode steps, then a train step with remat through
    ``train.cross_entropy_loss``, on the smoke config: each B6/B7 wrapper is
    called as often as ``chip_smoke.expected_launches`` and
    ``train_launches`` say it launches on the card (RoPE once an attention
    layer a prefill and a decode step, an encoder's layers too, no cross
    layer; the loss once a step, its adjoint once)."""
    cfg = get_smoke_config(arch)
    model = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    cross = stub_cross_src(cfg, 2, torch.device("cpu"), getattr(torch, cfg.dtype))
    calls = dict.fromkeys(WRAPPERS, 0)
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
        labels = torch.roll(tokens, -1, dims=1)
        cross_entropy_loss(forward_train(model, tokens, cross, remat=True), labels).backward()
        want = chip_smoke.train_launches(cfg, 1)
        assert calls == {k: want[k] for k in calls}
    finally:
        for p in patches:
            p.stop()
