"""The MoE layer on a mesh (``repro_torch.models.moe``'s mesh path) on the
CPU, held to the port's ``moe_ffn`` on the whole batch and to the JAX
package's ``repro.models.moe.moe_ffn`` on the same numpy inputs.

- ``moe_device_body`` run rank by rank (``collectives.rank_by_rank``) for
  1×2, 2×1 and 2×2 (batch × experts) layouts: f32 within 1e-5 of the
  largest output, the kept assignments and slots equal, at a capacity that
  drops assignments too; the one-rank layout equal to ``moe_ffn`` bit for
  bit, and ``moe_ffn`` on plain tensors equal bit for bit to the dispatch
  as it was before the mesh path (kept verbatim below);
- an olmoe smoke step on a 2×2 fake mesh: each device's expert products
  are a quarter of the whole step's, times the padded capacity over the
  capacity;
- olmoe's prefill and decode steps through ``make_prefill_step`` and
  ``make_decode_step`` on a real 4-rank gloo group (``tests/_gloo_mesh.py``):
  the MoE layer on the mesh path and, with one kv head, the decode cache's
  sequence sharded over "model", equal to the plain ``forward_prefill`` and
  ``forward_decode`` within f32 rounding, and a train step's gradients
  (olmoe's and jamba's) equal the plain model's; the norms and Mamba2's
  convolution run on the shards, in layouts their kernels take.
"""
import json
import os
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as jax_moe
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import moe
from repro_torch.sharding import collectives as coll

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _gloo_mesh  # noqa: E402

B, S, D, E, K, FF = 4, 24, 32, 8, 2, 40
GLOO_LIMIT_S = 60


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"router": rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5,
              "w_gate": rng.standard_normal((E, D, FF)).astype(np.float32) * E ** -0.5,
              "w_up": rng.standard_normal((E, D, FF)).astype(np.float32) * E ** -0.5,
              "w_down": rng.standard_normal((E, FF, D)).astype(np.float32) * E ** -0.5}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return params, x


def _ranks(tp, x, lay, cf):
    """Every rank's (output, plan, padded capacity) of the layout."""
    t = B * S
    tb, el = t // lay.n_batch, E // lay.n_experts
    x2d = x.reshape(t, D)

    def body(c):
        r = lay.at(c)
        e = slice(r.experts * el, (r.experts + 1) * el)
        return moe.moe_device_body(x2d[r.batch * tb:(r.batch + 1) * tb], tp["router"],
                                   tp["w_gate"][e], tp["w_up"][e], tp["w_down"][e], K, cf, t, r)
    return coll.rank_by_rank(body, lay.sizes)


def _assembled(ranks, lay):
    """The output of the whole batch, from each batch rank's tokens; every
    rank of a batch rank holds the same bits."""
    outs = []
    for b in range(lay.n_batch):
        mine = [r[0] for c, r in sorted(ranks.items()) if c[0] == b]
        assert all(torch.equal(m, mine[0]) for m in mine)
        outs.append(mine[0])
    return torch.cat(outs).reshape(B, S, D)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("layout", [(1, 2, 1), (2, 1, 1), (2, 2, 1)])
def test_mesh_body_rank_by_rank_equals_moe_ffn_and_reference(layout, cf):
    params, x = _inputs()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tx = torch.from_numpy(x)
    lay = moe.MoELayout(*layout)
    ranks = _ranks(tp, tx, lay, cf)
    got = _assembled(ranks, lay)
    want = moe.moe_ffn(tp, tx, E, K, cf)
    ref = np.asarray(jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in params.items()},
                                     jnp.asarray(x), E, K, cf))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-5 * scale
    t = B * S
    idx = moe.router_topk(tx.reshape(t, D), tp["router"], K)[1]
    plan = moe.dispatch_plan(idx, E, moe.capacity(t, K, E, cf))
    for r in ranks.values():
        assert all(torch.equal(a, b) for a, b in zip(r[1], plan))
        assert r[2] == moe.padded_capacity(moe.capacity(t, K, E, cf), lay)
    if cf < 1:
        assert int((~plan.keep).sum()) > 0          # this capacity drops assignments


def test_one_rank_layout_and_plain_path_unchanged_bit_for_bit():
    """The one-rank layout is ``moe_ffn`` bit for bit, and ``moe_ffn`` on
    plain tensors is the dispatch the port had before its mesh path, bit for
    bit, in f32 and bf16, with drops, and the aux loss with it."""
    params, x = _inputs(1)
    for dtype in (torch.float32, torch.bfloat16):
        tp = {k: torch.from_numpy(v).to(dtype if k != "router" else torch.float32)
              for k, v in params.items()}
        tx = torch.from_numpy(x).to(dtype)
        for cf in (1.25, 0.5):
            got, aux = moe.moe_ffn(tp, tx, E, K, cf, return_aux=True)
            want, waux = _moe_ffn_before(tp, tx, E, K, cf)
            assert torch.equal(got, want) and torch.equal(aux, waux)
            one = _ranks(tp, tx, moe.MoELayout(), cf)[(0, 0, 0)][0]
            assert torch.equal(one.reshape(B, S, D), got)


def test_expert_products_on_a_2x2_mesh_are_a_quarter_of_the_step():
    """olmoe's smoke prefill on a 2×2 fake mesh (batch over data, experts
    over model): each device's expert-product FLOPs times 4 are the whole
    step's (the 1×1 mesh's) times the padded capacity over the capacity.
    The expert products are what ``expert_swiglu`` computes: the count less
    the count with ``expert_swiglu`` a product-free stand-in."""
    cfg = get_smoke_config("olmoe-1b-7b")
    shape = InputShape("p", 50, 4, "prefill")            # 200 tokens: capacity 125, odd
    t = shape.global_batch * shape.seq_len
    cap = moe.capacity(t, cfg.experts_per_token, cfg.num_experts, cfg.capacity_factor)
    lay = moe.MoELayout(2, 2, 1)
    capp = moe.padded_capacity(cap, lay)
    assert (cap, capp) == (125, 126)

    def experts_flops(mesh):
        step, args = make_prefill_step(cfg, mesh, shape)
        with_products = analyze(step, *args)[1].flops
        real = moe.expert_swiglu
        moe.expert_swiglu = lambda buf, *w: F.silu(buf)
        try:
            step, args = make_prefill_step(cfg, mesh, shape)
            without = analyze(step, *args)[1].flops
        finally:
            moe.expert_swiglu = real
        return with_products - without
    try:
        per_device = experts_flops(mesh_mod.make_fake_mesh((2, 2), ("data", "model")))
    finally:
        mesh_mod.release()
    whole = experts_flops({"data": 1, "model": 1})
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert whole == cfg.num_layers * 3 * 2 * e * cap * d * f
    assert per_device * 4 * cap == whole * capp


def test_olmoe_steps_on_a_4_rank_gloo_group(tmp_path):
    """Four CPU processes, a gloo group over a ``FileStore``: olmoe's smoke
    prefill step on a 2×2 mesh equals the plain prefill (logits and
    caches), and 3 decode steps with the cache's sequence sharded over
    "model" (one kv head) equal the plain decode within f32 rounding; a
    train step's loss and every gradient (olmoe's and jamba's smoke
    configs) equal the plain model's within f32 rounding (each gradient
    within 1e-4 of its largest); ``collectives.on_mesh`` over both mesh
    dims equals ``rank_by_rank``; B4, B5 and B8 (every norm, jamba's gated
    norm and convolution, its MLP's gate) ran on the mesh's shards, each
    shard in a layout their kernels' checks take. Limited to ``GLOO_LIMIT_S`` seconds."""
    import torch.multiprocessing as mp
    t0 = time.monotonic()
    ctx = mp.start_processes(_gloo_mesh.run, args=(4, str(tmp_path / "store"), str(tmp_path)),
                             nprocs=4, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(1.0, GLOO_LIMIT_S - (time.monotonic() - t0))):
            if time.monotonic() - t0 > GLOO_LIMIT_S:
                pytest.fail(f"the 4-rank group took over {GLOO_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(4)]
    for r in results:
        assert r["collectives"] == 0.0
        assert r["norm_conv"]["refused"] == []
        assert set(r["norm_conv"]["shards"]) == {"_norm_on_shards", "_gated_on_shards",
                                                 "_conv_on_shards", "_silu_on_shards"}
        assert r["cache_placements"] == ["S(0)", "S(1)"]
        assert r["prefill"] <= 1e-5 * r["prefill_scale"] and r["prefill_cache"] <= 1e-5
        assert all(d <= 1e-5 * s for d, s in zip(r["decode"], r["decode_scale"]))
        assert r["n"][0] == r["n"][1] == _gloo_mesh.PROMPT + _gloo_mesh.DECODE
        for arch, t in r["train"].items():
            assert abs(t["train_loss"][1] - t["train_loss"][0]) <= 1e-5 * t["train_loss"][0]
            assert t["train_grad"] <= 1e-4, arch
    assert os.path.exists(tmp_path / "store")


def _moe_ffn_before(params, x, num_experts, k, capacity_factor):
    """``moe_ffn`` as the port had it before its mesh path, verbatim."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, idx, probs = moe.router_topk(x2d, params["router"], k)
    cap = moe.capacity(t, k, num_experts, capacity_factor)
    flat_expert = idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = order // k
    sorted_gate = gates.reshape(-1)[order]
    positions = torch.arange(t * k, device=x.device)
    experts = torch.arange(num_experts, device=x.device, dtype=sorted_expert.dtype)
    seg_start = torch.searchsorted(sorted_expert, experts)
    rank = positions - seg_start[sorted_expert]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap))
    wdt = params["w_gate"].dtype
    buf = torch.zeros((num_experts, cap + 1, d), dtype=wdt, device=x.device)
    buf[sorted_expert, slot] = x2d.to(wdt)[sorted_token]
    y = moe.expert_swiglu(buf[:, :cap], params["w_gate"], params["w_up"], params["w_down"])
    ypad = torch.cat([y, torch.zeros((num_experts, 1, d), dtype=y.dtype, device=y.device)],
                     dim=1)
    contrib = ypad[sorted_expert, slot] * sorted_gate[:, None].to(y.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros((), dtype=y.dtype,
                                                              device=y.device))
    inverse = torch.empty_like(order)
    inverse[order] = positions
    per_token = contrib[inverse.view(t, k).sort(dim=1).values]
    out2d = per_token[:, 0]
    for j in range(1, k):
        out2d = out2d + per_token[:, j]
    return out2d.reshape(b, s, d).to(x.dtype), moe.load_balance_loss(probs, idx, num_experts)
