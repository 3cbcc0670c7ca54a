"""K2's backward on the CPU: ``flash_attention_bwd_plain`` (the arithmetic of
``csrc/flash_attention_bwd.cu``) against autograd through the plain forward
and against ``jax.grad`` of the reference's ``blockwise_attention``.

The same numpy inputs go to both packages, in f32. Tolerances: 2e-5 of the
largest gradient against autograd (the same sums, regrouped: the plain
backward recomputes P from the log-sum-exp where autograd differentiates
the online softmax), 1e-4 against JAX (XLA sums in another order). The case
``dead_rows`` has query rows with no unmasked key, which average V over
all Sk keys; Sk ≤ 256 there, as the reference pads its keys to 256.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blockwise_attention as jax_blockwise_attention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    NEG_INF,
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

# name: (q heads per kv, causal, window, q_offset, Sq, Sk, hd)
CASES = {
    "causal_mha_hd64": (1, True, None, 0, 48, 48, 64),
    "causal_gqa3_hd128": (3, True, None, 0, 40, 40, 128),
    "causal_gqa4_ragged": (4, True, None, 0, 33, 33, 64),
    "cross_sq_ne_sk": (1, False, None, 0, 24, 72, 64),
    "cross_gqa4_long_sk": (4, False, None, 0, 40, 300, 128),
    "window_causal_gqa3": (3, True, 8, 0, 64, 64, 64),
    "window_bidirectional": (1, False, 8, 0, 30, 30, 64),
    "q_offset_continuation": (4, True, None, 20, 24, 44, 64),
    "dead_rows": (1, True, None, -10, 24, 24, 64),
    "dead_rows_window": (3, True, 4, 100, 8, 40, 128),
}
B, KV = 2, 2


def _inputs(case):
    g, causal, window, q_offset, sq, sk, hd = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = rng.standard_normal((B, sq, KV * g, hd)).astype(np.float32)
    k = rng.standard_normal((B, sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, sk, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, sq, KV * g, hd)).astype(np.float32)
    return (q, k, v, do), dict(causal=causal, window=window, q_offset=q_offset), g


def _flat(x, heads):
    """(B, S, H, hd) numpy → (B·H, S, hd) tensor."""
    b, s, h, hd = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, hd)))


def _bshd(t, b):
    bh, s, hd = t.shape
    return t.reshape(b, bh // b, s, hd).transpose(1, 2).numpy()


def _plain_grads(case):
    (q, k, v, do), opts, g = _inputs(case)
    qf, kf, vf, dof = _flat(q, KV * g), _flat(k, KV), _flat(v, KV), _flat(do, KV * g)
    out, lse = flash_attention_plain(qf, kf, vf, q_heads_per_kv=g, return_lse=True, **opts)
    grads = flash_attention_bwd_plain(qf, kf, vf, out, lse, dof, q_heads_per_kv=g, **opts)
    return [_bshd(x, B) for x in grads], lse


def _graph_nodes(fn, depth=4):
    """Names of the autograd nodes within ``depth`` steps of ``fn``."""
    if fn is None or depth == 0:
        return ""
    return type(fn).__name__ + "".join(_graph_nodes(f, depth - 1) for f, _ in fn.next_functions)


def _close(got, want, rel):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(float(np.abs(b).max()), 1e-6))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_through_plain_forward(case):
    (q, k, v, do), opts, g = _inputs(case)
    qf, kf, vf = (_flat(x, h).requires_grad_() for x, h in ((q, KV * g), (k, KV), (v, KV)))
    out = flash_attention_plain(qf, kf, vf, q_heads_per_kv=g, **opts)
    want = torch.autograd.grad(out, (qf, kf, vf), _flat(do, KV * g))
    got, _ = _plain_grads(case)
    _close(got, [_bshd(x, B) for x in want], 2e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_grad_of_reference(case):
    (q, k, v, do), opts, g = _inputs(case)

    def loss(q, k, v):
        out = jax_blockwise_attention(q, k, v, **opts)
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got, _ = _plain_grads(case)
    _close(got, [np.asarray(x) for x in want], 1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_function_through_ops_matches_jax(case):
    """The model path: ``ops.flash_attention_bshd`` with grad on takes
    ``FlashAttentionFn``, whose backward on the CPU is the plain one."""
    (q, k, v, do), opts, g = _inputs(case)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention_bshd(qt, kt, vt, **opts)
    assert "FlashAttentionFn" in _graph_nodes(out.grad_fn)
    out.backward(torch.from_numpy(do))

    def loss(q, k, v):
        return jnp.sum(jax_blockwise_attention(q, k, v, **opts) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close([qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()],
           [np.asarray(x) for x in want], 1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_is_the_masked_logsumexp(case):
    """lse = logsumexp of the masked, scaled scores; NEG_INF exactly for a
    row with no unmasked key (and only there)."""
    (q, k, v, _), opts, g = _inputs(case)
    qf, kf = _flat(q, KV * g), _flat(k, KV)
    _, lse = flash_attention_plain(qf, kf, _flat(v, KV), q_heads_per_kv=g, return_lse=True,
                                   **opts)
    kk = torch.repeat_interleave(kf, g, dim=0)
    s = torch.einsum("bqd,bkd->bqk", qf, kk) * qf.shape[-1] ** -0.5
    qpos = opts["q_offset"] + torch.arange(qf.shape[1])[:, None]
    kpos = torch.arange(kf.shape[1])[None, :]
    mask = torch.ones_like(s[0], dtype=torch.bool)
    if opts["causal"]:
        mask &= qpos >= kpos
    if opts["window"] is not None:
        mask &= qpos - kpos < opts["window"]
    live = mask.any(dim=-1).expand_as(lse)
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    torch.testing.assert_close(lse[live], want[live], rtol=0, atol=1e-5)
    assert bool((lse[~live] == NEG_INF).all())
    assert bool((~live).any()) == case.startswith("dead_rows")


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """A CPU tensor goes to the plain version, in both directions."""
    (q, k, v, do), opts, g = _inputs("causal_gqa3_hd128")
    qf, kf, vf, dof = _flat(q, KV * g), _flat(k, KV), _flat(v, KV), _flat(do, KV * g)
    launches = flash_attention_bwd.launches
    out, lse = flash_attention(qf, kf, vf, q_heads_per_kv=g, return_lse=True, **opts)
    want_out, want_lse = flash_attention_plain(qf, kf, vf, q_heads_per_kv=g, return_lse=True,
                                               **opts)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    got = flash_attention_bwd(qf, kf, vf, out, lse, dof, q_heads_per_kv=g, **opts)
    want = flash_attention_bwd_plain(qf, kf, vf, out, lse, dof, q_heads_per_kv=g, **opts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attention_bwd.launches == launches
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(qf, kf, vf, out, lse[:, :-1], dof, q_heads_per_kv=g, **opts)
    with pytest.raises(ValueError, match="o and do"):
        flash_attention_bwd(qf, kf, vf, out.double(), lse, dof, q_heads_per_kv=g, **opts)


def test_serving_call_records_no_graph():
    """Without grad mode, or with no input requiring it, attention takes the
    plain forward call: no autograd node."""
    (q, k, v, _), opts, _ = _inputs("causal_mha_hd64")
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    assert ops.flash_attention_bshd(qt, kt, vt, **opts).grad_fn is None
    with torch.no_grad():
        out = ops.flash_attention_bshd(qt.requires_grad_(), kt, vt, **opts)
    assert out.grad_fn is None


def test_autograd_function_saves_the_forward_output():
    """``FlashAttentionFn`` gives the forward's output bits, f32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        (q, k, v, _), opts, g = _inputs("causal_gqa4_ragged")
        qf, kf, vf = (_flat(x, h).to(dtype) for x, h in ((q, KV * g), (k, KV), (v, KV)))
        want = flash_attention(qf, kf, vf, q_heads_per_kv=g, **opts)
        got = FlashAttentionFn.apply(qf.requires_grad_(), kf, vf, g, opts["causal"],
                                     opts["window"], opts["q_offset"])
        assert got.dtype == dtype and torch.equal(got.detach(), want)
