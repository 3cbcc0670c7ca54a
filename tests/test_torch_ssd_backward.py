"""K3's backward on the CPU: ``ssd_scan_bwd_plain`` (the arithmetic of
``csrc/ssd_scan_bwd.cu``, written out by hand) and ``SsdScanFn`` against
``jax.grad`` of the reference's ``ssd_chunked`` (``repro.models.ssm``, through
the (B, S, H, P) layout of ``ops.ssd_bshp``) and of its token-by-token
``ssd_ref`` (``repro.kernels.ref``), and against ``torch.autograd.grad`` of
``ssd_scan_plain``.

Inputs come from a numpy seed. Cases: several chunks, chunk 1 and a chunk
that is no power of two, groups read by several heads (dB and dC summed over
them), a given initial state and final-state gradient or neither, and the
model's A of -1 … -16 with dt scaled up, where exp(cum_i - cum_j) overflows
above the diagonal (no NaN may reach a gradient).

Tolerance: 1e-4 of the largest entry of each gradient in f32, since the two
sides sum in other orders (the reverse state pass, the reverse cumulative
sum, XLA's cumsum). bf16 inputs (x, B, C) against the reference in f32 on
the same rounded values: 1e-2 of the largest, since dx, dB and dC are
rounded once to bf16 (2^-8 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_ref
from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (SsdScanFn, bwd_flops_per_chunk, bwd_heads_per_block,
                                          bwd_least_work, ssd_scan_bwd, ssd_scan_bwd_plain,
                                          ssd_scan_plain)

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# (batch, seq, heads, groups, P, N, chunk, initial state and d final, large A·dt)
CASES = [
    (2, 64, 4, 1, 8, 6, 16, True, False),        # four chunks, one group of 4 heads
    (1, 24, 2, 2, 5, 3, 1, False, False),        # chunk 1: every step its own chunk
    (2, 36, 4, 2, 6, 4, 12, True, False),        # chunk 12 (no power of two), 2 groups
    (2, 48, 4, 4, 8, 8, 16, False, False),       # one head a group
    (1, 64, 8, 1, 8, 8, 16, True, True),         # A -1 … -16, dt x4: overflow above diagonal
    (2, 96, 4, 2, 16, 8, 32, False, True),
]


def _arrays(case, seed=0):
    b, s, h, g, p, n, chunk, with_state, large = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    if large:
        dt = dt * 4.0
        A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    else:
        A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state else None
    dfinal = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state else None
    return x, dt, A, Bm, Cm, dy, init, dfinal


def _round_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _jax_chunked_grads(case, arrays):
    """jax.grad of Σ y·dy + Σ final·dfinal through the reference's ssd_chunked."""
    x, dt, A, Bm, Cm, dy, init, dfinal = arrays
    chunk = case[6]

    def loss(x, dt, A, Bm, Cm, init):
        y, final = ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, initial_state=init)
        out = jnp.sum(y * dy)
        return out if dfinal is None else out + jnp.sum(final * dfinal)
    args = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)] + [
        None if init is None else jnp.asarray(init)]
    argnums = (0, 1, 2, 3, 4) + (() if init is None else (5,))
    grads = jax.grad(loss, argnums=argnums)(*args)
    return [np.asarray(gr) for gr in grads]


def _reaches(node, name) -> bool:
    """Whether autograd's graph from ``node`` holds a node of type ``name``."""
    seen, todo = set(), [node]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == name:
            return True
        todo.extend(f for f, _ in fn.next_functions)
    return False


def _decomposed_bwd(x, dt, A, Bm, Cm, dy, dfinal=None, *, chunk, heads_per_group,
                    initial_state=None, heads_per_block):
    """``csrc/ssd_scan_bwd_sm90.cu``'s decomposition of the backward, in f32
    PyTorch, the same inputs and outputs as ``ssd_scan_bwd_plain``: the
    per-chunk state terms of every (row, chunk) at once; the two states
    carried over the chunks by an elementwise pass; dX and ddt per (row,
    chunk) with exp(cum)'s and u's gradients from C·s_in and B·dS_out; dB
    and dC per block of ``heads_per_block`` heads of one group, dG summed over
    the block's heads before its two products, then the blocks of a group
    summed."""
    bh, s, p = x.shape
    n = Bm.shape[-1]
    g, hb, q = heads_per_group, heads_per_block, chunk
    nc = s // q
    xq = x.float().view(bh, nc, q, p)
    dyq = dy.float().view(bh, nc, q, p)
    dtq = dt.float().view(bh, nc, q)
    bq = Bm.float().view(bh // g, nc, q, n).repeat_interleave(g, 0)
    cq = Cm.float().view(bh // g, nc, q, n).repeat_interleave(g, 0)
    a = A.float()[:, None, None]
    cum = torch.cumsum((dtq * a).double(), dim=-1).float()          # (BH, NC, Q)
    total = cum[..., -1:]
    decay = torch.exp(total - cum)
    u, ecum, et = decay * dtq, torch.exp(cum), torch.exp(total[..., 0])
    # 1. the chunks' state terms, B^T diag(u) X and C^T diag(exp(cum)) dY
    sx = bq.transpose(-1, -2) @ (u[..., None] * xq)                # (BH, NC, N, P)
    sy = cq.transpose(-1, -2) @ (ecum[..., None] * dyq)
    # 2. the states pass: s_in forward, dS_out back, sum(dS_out o s_in)
    st = (torch.zeros(bh, n, p) if initial_state is None else initial_state.float())
    s_in = torch.empty_like(sx)
    for c in range(nc):
        s_in[:, c] = st
        st = et[:, c, None, None] * st + sx[:, c]
    d = torch.zeros(bh, n, p) if dfinal is None else dfinal.float()
    ds_out = torch.empty_like(sy)
    for c in reversed(range(nc)):
        ds_out[:, c] = d
        d = et[:, c, None, None] * d + sy[:, c]
    ts = (ds_out * s_in).sum((-1, -2))                             # (BH, NC)
    # 3. dX, ddt and dA per (row, chunk)
    tri = torch.ones(q, q, dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)),
                    0.0)
    G = cq @ bq.transpose(-1, -2)
    W = G * L * dtq[..., None, :]
    dW = dyq @ xq.transpose(-1, -2)
    R = dW * W
    bds = bq @ ds_out                                               # (BH, NC, Q, P)
    v = (xq * bds).sum(-1)
    dx = W.transpose(-1, -2) @ dyq + u[..., None] * bds
    inter = ecum * (dyq * (cq @ s_in)).sum(-1)
    dcum = R.sum(-1) - R.sum(-2) + inter - u * v
    dcum[..., -1] += (u * v).sum(-1) + et * ts
    rc = torch.flip(torch.cumsum(torch.flip(dcum.double(), (-1,)), dim=-1), (-1,))
    ddt = (dW * G * L).sum(-2) + decay * v + a * rc.float()
    dA = (dtq.double() * rc).sum((1, 2)).float()
    # 4. dB and dC per block of hb heads: dG summed over the block first
    blocks = bh // hb
    sdg = (dW * L * dtq[..., None, :]).view(blocks, hb, nc, q, q).sum(1)
    b_blk, c_blk = bq.view(blocks, hb, nc, q, n)[:, 0], cq.view(blocks, hb, nc, q, n)[:, 0]
    dc_part = sdg @ b_blk + ((ecum[..., None] * dyq) @ s_in.transpose(-1, -2)).view(
        blocks, hb, nc, q, n).sum(1)
    db_part = sdg.transpose(-1, -2) @ c_blk + ((u[..., None] * xq) @ ds_out.transpose(
        -1, -2)).view(blocks, hb, nc, q, n).sum(1)
    # 5. a group's blocks summed
    dB = db_part.view(bh // g, g // hb, s, n).sum(1)
    dC = dc_part.view(bh // g, g // hb, s, n).sum(1)
    return (dx.reshape(bh, s, p).to(x.dtype), ddt.reshape(bh, s), dA, dB.to(Bm.dtype),
            dC.to(Cm.dtype), None if initial_state is None else d)


def _port_grads(case, arrays, dtype=torch.float32, through="fn"):
    """The port's gradients in the reference's layout: ``fn`` takes autograd
    through ``ops.ssd_bshp`` (``SsdScanFn`` on the CPU), ``plain`` calls
    ``ssd_scan_bwd_plain`` on the kernels' layout, ``decomposed``
    :func:`_decomposed_bwd` with the ``sm90`` kernel's heads per block."""
    x, dt, A, Bm, Cm, dy, init, dfinal = arrays
    b, s, h, g, p, n, chunk = case[:7]
    t = {k: torch.from_numpy(v) for k, v in zip(("x", "dt", "A", "B", "C", "dy"),
                                                 (x, dt, A, Bm, Cm, dy))}
    for k in ("x", "B", "C", "dy"):
        t[k] = t[k].to(dtype)
    t0 = None if init is None else torch.from_numpy(init)
    if through == "fn":
        leaves = [t[k].clone().requires_grad_() for k in ("x", "dt", "A", "B", "C")]
        init_leaf = None if t0 is None else t0.clone().requires_grad_()
        y, final = ops.ssd_bshp(*leaves, chunk=chunk, initial_state=init_leaf)
        assert _reaches(y.grad_fn, "SsdScanFnBackward")
        out = (y.float() * t["dy"].float()).sum()
        if dfinal is not None:
            out = out + (final * torch.from_numpy(dfinal)).sum()
        out.backward()
        grads = [leaf.grad for leaf in leaves] + ([] if t0 is None else [init_leaf.grad])
        return [gr.float().numpy() for gr in grads]
    xf = t["x"].transpose(1, 2).reshape(b * h, s, p).contiguous()
    dtf = t["dt"].transpose(1, 2).reshape(b * h, s).contiguous()
    Bf = t["B"].transpose(1, 2).reshape(b * g, s, n).contiguous()
    Cf = t["C"].transpose(1, 2).reshape(b * g, s, n).contiguous()
    dyf = t["dy"].transpose(1, 2).reshape(b * h, s, p).contiguous()
    Af = t["A"].repeat(b)
    initf = None if t0 is None else t0.transpose(2, 3).reshape(b * h, n, p).contiguous()
    dff = None if dfinal is None else torch.from_numpy(dfinal).transpose(2, 3).reshape(
        b * h, n, p).contiguous()
    if through == "decomposed":
        dx, ddt, dA, dB, dC, dinit = _decomposed_bwd(
            xf, dtf, Af, Bf, Cf, dyf, dff, chunk=chunk, heads_per_group=h // g,
            initial_state=initf, heads_per_block=bwd_heads_per_block(h // g))
    else:
        dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd_plain(xf, dtf, Af, Bf, Cf, dyf, dff,
                                                        chunk=chunk, heads_per_group=h // g,
                                                        initial_state=initf)
    assert dx.dtype == dtype and dB.dtype == dtype and dC.dtype == dtype
    assert ddt.dtype == dA.dtype == torch.float32 and (dinit is None) == (init is None)
    grads = [dx.reshape(b, h, s, p).transpose(1, 2), ddt.reshape(b, h, s).transpose(1, 2),
             dA.reshape(b, h).sum(0), dB.reshape(b, g, s, n).transpose(1, 2),
             dC.reshape(b, g, s, n).transpose(1, 2)]
    if dinit is not None:
        grads.append(dinit.reshape(b, h, n, p).transpose(2, 3))
    return [gr.float().numpy() for gr in grads]


def _assert_close(got, want, rel):
    assert len(got) == len(want)
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, w, rtol=0, atol=rel * max(float(np.abs(w).max()), 1e-8),
                                   err_msg=name)


@pytest.mark.parametrize("through", ["plain", "fn"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_matches_jax_grad_of_ssd_chunked(case, through):
    arrays = _arrays(case)
    _assert_close(_port_grads(case, arrays, through=through), _jax_chunked_grads(case, arrays),
                  1e-4)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sm90_decomposition_matches_the_plain_backward_and_jax_grad(case):
    """The ``sm90`` backward's algebra, before any card: the chunk states and
    dS by a separate pass, exp(cum)'s and u's gradients from C·s_in and
    B·dS_out, dG summed over a block of a group's heads before its products,
    in f32 within 1e-4 of the largest entry of ``ssd_scan_bwd_plain``'s and of
    ``jax.grad`` of the reference's ``ssd_chunked``."""
    arrays = _arrays(case)
    got = _port_grads(case, arrays, through="decomposed")
    _assert_close(got, _port_grads(case, arrays, through="plain"), 1e-4)
    _assert_close(got, _jax_chunked_grads(case, arrays), 1e-4)


@pytest.mark.parametrize("g,hb", [(1, 1), (2, 2), (3, 1), (4, 4), (6, 2), (12, 4), (64, 8),
                                  (256, 8), (24, 8)])
def test_sm90_heads_per_block_divides_the_group(g, hb):
    assert bwd_heads_per_block(g) == hb and g % hb == 0


@pytest.mark.parametrize("through", ["plain", "fn"])
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4]], ids=str)
def test_bf16_backward_matches_jax_grad_in_f32(case, through):
    arrays = list(_arrays(case))
    for i in (0, 3, 4, 5):               # x, B, C and dy as the bf16 run sees them
        arrays[i] = _round_bf16(arrays[i])
    want = _jax_chunked_grads(case, arrays)
    _assert_close(_port_grads(case, arrays, torch.bfloat16, through), want, 1e-2)


@pytest.mark.parametrize("chunk", [1, 8, 12, 24])
def test_backward_matches_jax_grad_of_the_token_recurrence(chunk):
    """``ssd_ref`` runs token by token (one head a group, zero initial
    state): the chunked backward at any chunk gives its gradient."""
    rng = np.random.default_rng(3)
    bh, s, p, n = 4, 48, 6, 5
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, s)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(bh) * 0.3).astype(np.float32)
    Bm, Cm = ((rng.standard_normal((bh, s, n)) * 0.3).astype(np.float32) for _ in range(2))
    dy = rng.standard_normal((bh, s, p)).astype(np.float32)
    dfinal = rng.standard_normal((bh, n, p)).astype(np.float32)

    def loss(*args):
        y, final = ssd_ref(*args)
        return jnp.sum(y * dy) + jnp.sum(final * dfinal)
    want = [np.asarray(gr) for gr in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))]
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy, dfinal)]
    got = ssd_scan_bwd_plain(*t, chunk=chunk)
    assert got[5] is None
    _assert_close([gr.numpy() for gr in got[:5]], want, 1e-4)


@pytest.mark.parametrize("with_final", [True, False])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_matches_autograd_through_plain(case, with_final):
    """``ssd_scan_bwd_plain`` and ``SsdScanFn`` against autograd of
    ``ssd_scan_plain`` on the kernels' layout, with the final state's
    gradient given or not (None: the state unused)."""
    b, s, h, g, p, n, chunk, with_state, large = case
    rng = np.random.default_rng(7)
    bh = b * h
    x = torch.from_numpy(rng.standard_normal((bh, s, p)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((bh, s)))).astype(np.float32))
    A = torch.from_numpy((-np.linspace(1, 16, bh) if large
                          else -np.exp(rng.standard_normal(bh) * 0.3)).astype(np.float32))
    Bm, Cm = (torch.from_numpy((rng.standard_normal((b * g, s, n)) * 0.3).astype(np.float32))
              for _ in range(2))
    init = torch.from_numpy(rng.standard_normal((bh, n, p)).astype(np.float32)) \
        if with_state else None
    dy = torch.from_numpy(rng.standard_normal((bh, s, p)).astype(np.float32))
    dfinal = torch.from_numpy(rng.standard_normal((bh, n, p)).astype(np.float32)) \
        if with_final else None
    inputs = [x, dt, A, Bm, Cm] + ([init] if with_state else [])
    kw = dict(chunk=chunk, heads_per_group=h // g)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in inputs]
        y, final = fn(*leaves)
        out = (y * dy).sum() + (0 if dfinal is None else (final * dfinal).sum())
        return [gr.numpy() for gr in torch.autograd.grad(out, leaves)]
    want = run(lambda *a: ssd_scan_plain(*a[:5], initial_state=a[5] if with_state else None,
                                         **kw))
    got_fn = run(lambda *a: SsdScanFn.apply(*a[:5], chunk, h // g,
                                            a[5] if with_state else None))
    got = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dfinal, initial_state=init, **kw)
    got = [gr.numpy() for gr in got if gr is not None]
    _assert_close(got, want, 1e-4)
    _assert_close(got_fn, want, 1e-4)


def test_unused_outputs_cost_nothing_and_the_wrapper_takes_the_plain_version_on_the_cpu():
    """Gradients are not materialised: with y alone in the loss, the
    backward gets no final-state gradient, and equals the plain version's
    with ``dfinal=None``; the wrapper on CPU tensors is the plain version."""
    rng = np.random.default_rng(1)
    x, dy = (torch.from_numpy(rng.standard_normal((4, 32, 8)).astype(np.float32))
             for _ in range(2))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((4, 32)))).astype(np.float32))
    A = -torch.rand(4) - 0.5
    Bm, Cm = (torch.from_numpy(rng.standard_normal((2, 32, 4)).astype(np.float32))
              for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, _ = SsdScanFn.apply(*leaves, 8, 2, None)
    (y * dy).sum().backward()
    want = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, None, chunk=8, heads_per_group=2)
    via = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, None, chunk=8, heads_per_group=2)
    for leaf, w, v in zip(leaves, want, via):
        assert torch.equal(leaf.grad, w) and torch.equal(v, w)
    assert want[5] is None and via[5] is None


def test_wrapper_checks_its_gradient_inputs():
    x = torch.zeros(2, 16, 4)
    dt, A, Bm = torch.zeros(2, 16), torch.zeros(2), torch.zeros(2, 16, 3)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(x, dt, A, Bm, Bm, torch.zeros(2, 16, 5), chunk=8)
    with pytest.raises(ValueError, match="dfinal"):
        ssd_scan_bwd(x, dt, A, Bm, Bm, x, torch.zeros(2, 4, 3), chunk=8)


def test_flop_formula_counts_the_kernels_products():
    """2·Q²·(3N + 2P) + 10·Q·N·P per row and chunk: the five Q×Q products
    (C·Bᵀ, dY·Xᵀ, Wᵀ·dY, dG·B, dGᵀ·C) and five of Q·N·P (the state update,
    B·dS, X·dSᵀ, dY·s_inᵀ, Cᵀ·dY), each 2·m·n·k."""
    q, n, p = 128, 128, 64
    products = [(q, q, n), (q, q, p), (q, p, q), (q, n, q), (q, n, q),
                (n, p, q), (q, p, n), (q, n, p), (q, n, p), (n, p, q)]
    assert bwd_flops_per_chunk(q, n, p) == sum(2 * a * b * c for a, b, c in products)
    # mamba2-1.3b's training shape: 256 rows of 8 chunks, ~55.8 GFLOP
    assert 256 * 8 * bwd_flops_per_chunk(q, n, p) == 55_834_574_848


def test_meta_backward_gives_shapes_and_counts_its_flops():
    """On the meta device (the dry run) the backward is the custom op
    ``repro_torch::ssd_scan_bwd``: the gradients' shapes, the initial
    state's only when there is one, and its FLOP formula counted; through
    ``SsdScanFn`` the leaves get gradients of their shapes."""
    from repro_torch.launch.op_analysis import analyze

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    x, dt, a = meta(8, 128, 32), meta(8, 128, dtype=torch.float32), meta(8, dtype=torch.float32)
    bm, cm = meta(4, 128, 16), meta(4, 128, 16)
    for init in (None, meta(8, 16, 32, dtype=torch.float32)):
        grads, stats = analyze(lambda: ssd_scan_bwd(x, dt, a, bm, cm, meta(8, 128, 32), init,
                                                    chunk=64, heads_per_group=2,
                                                    initial_state=init))
        assert [None if t is None else (tuple(t.shape), t.dtype) for t in grads] == [
            ((8, 128, 32), torch.bfloat16), ((8, 128), torch.float32), ((8,), torch.float32),
            ((4, 128, 16), torch.bfloat16), ((4, 128, 16), torch.bfloat16),
            None if init is None else ((8, 16, 32), torch.float32)]
        assert stats.flops == 8 * 2 * bwd_flops_per_chunk(64, 16, 32)
    leaves = [t.requires_grad_() for t in (meta(8, 128, 32), meta(8, 128, dtype=torch.float32),
                                           meta(8, dtype=torch.float32), meta(4, 128, 16),
                                           meta(4, 128, 16))]
    y, _ = SsdScanFn.apply(*leaves, 64, 2, None)
    y.sum().backward()
    assert [tuple(t.grad.shape) for t in leaves] == [tuple(t.shape) for t in leaves]


def test_chip_smoke_bound_counts_the_least_work(monkeypatch):
    """``chip_smoke.py``'s bound for K3's backward comes from
    ``bwd_least_work``: the Q×Q products over the pairs j ≤ i the mask keeps,
    C·Bᵀ and dG's two products once per group row (a group's heads read the
    same B and C, so their dG is summed before the products), five Q·N·P
    products per row and chunk; at mamba2's training shape 26.0 GFLOP
    against 107.0 MB, so the bytes bound it, against the dry run's 55.8
    GFLOP of ``bwd_flops_per_chunk``, which counts every product in full and
    once per head."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.launch.roofline import (H100_HBM_BW, H100_PEAK_FLOPS_BF16,
                                             H100_PEAK_FLOPS_F32)
    monkeypatch.setattr(chip_smoke, "PEAK_BF16_FLOPS", H100_PEAK_FLOPS_BF16)
    monkeypatch.setattr(chip_smoke, "PEAK_F32_FLOPS", H100_PEAK_FLOPS_F32)
    monkeypatch.setattr(chip_smoke, "PEAK_BYTES", H100_HBM_BW)
    for (bh, s, p, n, q, g), want in (((256, 1024, 64, 128, 128, 64), 26_006_257_664),
                                      ((1024, 1024, 64, 128, 128, 256), 103_416_332_288),
                                      ((8, 96, 20, 12, 32, 4), None)):
        ms, by, flops, nbytes = chip_smoke.ssd_bwd_bound_ms("bfloat16", (bh, s, p, n, q, g, False))
        kept = int(torch.tril(torch.ones(q, q)).sum())
        per_row = 2 * kept * (p + p) + 10 * q * n * p              # dW, dX; the state terms
        per_group_row = 2 * kept * (n + n + n)                      # C·Bᵀ, ΣdG·B, ΣdGᵀ·C
        assert flops == (s // q) * (bh * per_row + (bh // g) * per_group_row)
        assert want is None or flops == want
        assert flops < bh * (s // q) * bwd_flops_per_chunk(q, n, p)
        assert ms == max(flops / H100_PEAK_FLOPS_BF16, nbytes / H100_HBM_BW) * 1e3
        assert by == "bytes"


@pytest.mark.parametrize("shape,flops,nbytes,ms", [
    ((256, 1024, 64, 128, 128, 64, False), 26_006_257_664, 106_956_800, 0.0319),
    ((1024, 1024, 64, 128, 128, 256, False), 103_416_332_288, 415_244_288, 0.124)])
def test_least_work_of_the_backward_matches_the_hand_counts(shape, flops, nbytes, ms):
    """``bwd_least_work`` at mamba2-1.3b's and jamba-1.5-large's training
    shapes in bf16: 26.0 GFLOP against 107.0 MB (0.0263 ms at 989 TFLOP/s,
    0.0319 ms at 3.35 TB/s: bound by bytes), 103.4 GFLOP against 415.2 MB
    (0.124 ms by bytes)."""
    from repro_torch.launch.roofline import H100_HBM_BW, H100_PEAK_FLOPS_BF16
    got_flops, got_bytes = bwd_least_work(*shape, 2)
    assert (got_flops, got_bytes) == (flops, nbytes)
    assert round(got_bytes / H100_HBM_BW * 1e3, 4 if ms < 0.1 else 3) == ms
    assert got_flops / H100_PEAK_FLOPS_BF16 < got_bytes / H100_HBM_BW
