"""The context-parallel decode softmax (``repro_torch.models.attention``'s
``decode_device_body``) on the CPU.

- A cache cut into sequence pieces, run piece by piece
  (``collectives.rank_by_rank``), equals ``decode_attention`` on the whole
  cache and the JAX package's ``repro.models.attention.decode_attention``
  on the same numpy inputs within f32 rounding: filled, partly filled,
  most pieces empty, a window inside the cache (the reference's clamped
  slice) and R4's ring (a window as long as the cache).
- On a 2×2 fake mesh a decode step whose cache has its sequence sharded
  over "model" no longer gathers the cache: against the same step through
  the gathered path, it all-gathers two cache shards a layer fewer and
  all-reduces the softmax's (B, 1, H) maxima and sums and (B, 1, H, hd)
  partials in their place, byte for byte.
"""
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import attention as jax_attention
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import attention
from repro_torch.sharding import collectives as coll

import torch

B, H, KV, HD, SLOTS = 3, 8, 2, 16, 96


@pytest.mark.parametrize("pieces,cache_len,window", [
    (4, 96, None), (4, 50, None), (8, 3, None), (16, 70, None),
    (4, 80, 32), (8, 20, 32), (6, 96, 96), (4, 17, 96)])
def test_decode_by_pieces_equals_the_whole_cache_and_reference(pieces, cache_len, window):
    rng = np.random.default_rng(cache_len)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, SLOTS, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, SLOTS, KV, HD)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    n = SLOTS // pieces
    got = coll.rank_by_rank(
        lambda c: attention.decode_device_body(tq, tk[:, c["seq"] * n:(c["seq"] + 1) * n],
                                               tv[:, c["seq"] * n:(c["seq"] + 1) * n],
                                               cache_len, window, c["seq"] * n, SLOTS),
        {"seq": pieces})
    want = attention.decode_attention(tq, tk, tv, cache_len, window)
    ref = np.asarray(jax_attention.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                                    jnp.asarray(v), jnp.asarray(cache_len),
                                                    window))
    scale = float(want.abs().max())
    outs = list(got.values())
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert float((outs[0] - want).abs().max()) <= 1e-5 * scale
    assert float(np.abs(outs[0].numpy() - ref).max()) <= 1e-5 * scale


def test_valid_slots_are_decode_attentions_slots():
    """The slots a piece masks in, over all pieces, are those
    ``decode_attention`` reads: the first ``cache_len``, or the window's
    ``min(cache_len, window)`` from its clamped start."""
    for cache_len, window in ((10, None), (90, 32), (20, 32), (96, 96), (5, 64)):
        mask = torch.cat([attention.valid_slots(o, 16, SLOTS, cache_len, window)
                          for o in range(0, SLOTS, 16)])
        pos = torch.nonzero(mask).flatten().tolist()
        if window is None or SLOTS <= window:
            assert pos == list(range(min(cache_len, SLOTS)))
        else:
            start = min(max(cache_len - window, 0), SLOTS - window)
            assert pos == list(range(start, start + min(cache_len, window)))


def test_sequence_sharded_decode_moves_the_partials_not_the_cache():
    cfg = dataclasses.replace(get_smoke_config("phi4-mini-3.8b"), num_kv_heads=1)
    shape = InputShape("d", 64, 4, "decode")

    def gathered(q, k, v, cache_len, window):
        return ops.attention_on_shards(
            lambda q, k, v: attention.decode_attention(q, k, v, cache_len, window), q, k, v)
    try:
        mesh = mesh_mod.make_fake_mesh((2, 2), ("data", "model"))
        step, args = make_decode_step(cfg, mesh, shape)
        assert [str(p) for p in args[2][0]["k"].placements] == ["S(0)", "S(1)"]
        _, cp = analyze(step, *args)
        with mock.patch.object(attention, "_decode_on_mesh", gathered):
            step, args = make_decode_step(cfg, mesh, shape)
            _, whole = analyze(step, *args)
    finally:
        mesh_mod.release()
    layers, b, s = cfg.num_layers, shape.global_batch // 2, shape.seq_len // 2
    shard = b * s * cfg.num_kv_heads * cfg.resolved_head_dim * 4
    partials = (2 * b * cfg.num_heads + b * cfg.num_heads * cfg.resolved_head_dim) * 4
    assert whole.collective_by_op["all-gather"] - cp.collective_by_op["all-gather"] == (
        layers * 2 * shard)
    assert cp.collective_by_op["all-reduce"] - whole.collective_by_op["all-reduce"] == (
        layers * partials)
    assert cp.collective_count["all-reduce"] - whole.collective_count["all-reduce"] == 3 * layers
    assert cp.flops < whole.flops
