"""The mesh steps on a real 4-rank gloo group (CPU processes), for
``tests/test_torch_moe_mesh.py``: imports no jax, so the spawned ranks
start quickly.

Each rank builds the same f32 smoke model, runs the port's plain
``forward_prefill``/``forward_decode`` on the whole batch, then the same
through ``make_prefill_step``/``make_decode_step`` on a 2×2 (data, model)
mesh with the model and its inputs placed by the sharding rules, and
writes the largest differences to ``<out>/rank<r>.json``; then the loss
and every gradient of a train step's forward and backward (olmoe's and
jamba's smoke configs) on the mesh against the plain model's. It also
holds ``collectives.on_mesh`` over a group of both mesh dims to the
``rank_by_rank``, and records how often B4, B5 and B8 (the norms,
Mamba2's gated norm and convolution, SwiGLU's gate) ran on the mesh's
shards and every condition their kernels would refuse in the shards'
layouts.
"""
import dataclasses
import json
import os

import torch
import torch.distributed as dist

from repro_torch.launch.steps import shard_tensor

PROMPT, SLOTS, DECODE = 16, 24, 3


def _collectives(mesh) -> float:
    """gather, all-to-all and reduce over the group ("data", "model") on the
    mesh, against the same requests formed in one process."""
    from repro_torch.sharding import collectives as coll

    def body(x):
        a = yield coll.gather(x, "all")
        b = yield coll.all_to_all(torch.cat([x * (i + 1) for i in range(4)]), "all")
        c = yield coll.reduce(x, "all", op="max")
        return torch.cat([a.flatten(), b.flatten(), c.flatten()])

    def rank_input(r):
        return torch.arange(6.).reshape(2, 3) + 10 * r
    me = mesh.get_local_rank(0) * 2 + mesh.get_local_rank(1)
    got = coll.on_mesh(body(rank_input(me)), mesh, {"all": [0, 1]})
    want = coll.rank_by_rank(lambda c: body(rank_input(c["all"])), {"all": 4})[(me,)]
    return float((got - want).abs().max())


def _watch_norm_conv() -> dict:
    """Counts the entries of B4's, B5's and B8's shard paths (``ops``'
    ``_norm_on_shards``, ``_gated_on_shards``, ``_conv_on_shards``,
    ``_silu_on_shards``) and lists each condition of the kernels' own
    checks (``norm_checks``, ``gated_checks``, ``conv_checks``,
    ``swiglu_checks``, which the card's wrappers apply) that a wrapper's
    inputs fail here on the CPU, where the plain versions run."""
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import ops
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import swiglu as sw
    seen = {"shards": {}, "refused": []}
    checks = {
        (rn, "rms_norm_fwd"): lambda x, s, *_: rn.norm_checks(x, s, rn._row_stride(x)),
        (rn, "rms_norm_bwd"): lambda g, x, s, *_: rn.norm_checks(x, s, rn._row_stride(x)),
        (rn, "gated_rms_norm_fwd"): lambda y, xh, D, z, s, *_: rn.gated_checks(y, xh, D, z, s),
        (rn, "gated_rms_norm_bwd"): lambda g, y, xh, D, z, s, *_: rn.gated_checks(
            y, xh, D, z, s),
        (cc, "causal_conv1d_fwd"): lambda x, w, b, st=None: cc.conv_checks(x, w, b, st),
        (cc, "causal_conv1d_bwd"): lambda g, x, w, b, st=None, *_: cc.conv_checks(x, w, b, st),
        (sw, "swiglu_fwd"): lambda g, u: sw.swiglu_checks(g, u),
        (sw, "swiglu_bwd"): lambda dh, g, u: sw.swiglu_checks(g, u, dh)}
    for (mod, name), check in checks.items():
        def watched(*args, _fn=getattr(mod, name), _name=name, _check=check, **kw):
            seen["refused"] += [[_name, msg] for ok, msg in _check(*args) if not ok]
            return _fn(*args, **kw)
        setattr(mod, name, watched)
        if hasattr(ops, name):
            setattr(ops, name, watched)
    for name in ("_norm_on_shards", "_gated_on_shards", "_conv_on_shards", "_silu_on_shards"):
        def counted(*args, _fn=getattr(ops, name), _name=name):
            seen["shards"][_name] = seen["shards"].get(_name, 0) + 1
            return _fn(*args)
        setattr(ops, name, counted)
    return seen


def _train(model, placed, tokens, mesh, b) -> dict:
    """The loss and every parameter's gradient of one train step's forward
    and backward (remat on, the mesh step's loss) on the mesh, against the
    plain model's: the losses, and the largest gradient difference over the
    parameter's largest gradient."""
    from repro_torch.launch import steps
    from repro_torch.models import forward_train
    from repro_torch.sharding.rules import batch_spec
    from repro_torch.train.loop import cross_entropy_loss
    labels = torch.roll(tokens, -1, dims=1)
    model.requires_grad_(True)
    placed.requires_grad_(True)
    want = cross_entropy_loss(forward_train(model, tokens, remat=True), labels)
    want.backward()
    spec = batch_spec(mesh, b)
    with steps._on_mesh(mesh, ("data",)):
        logits = forward_train(placed, shard_tensor(tokens, mesh, spec), remat=True)
        got = steps.cross_entropy(logits, shard_tensor(labels, mesh, spec))
        got.backward()
    worst = 0.0
    for p, q in zip(model.parameters(), placed.parameters()):
        g = q.grad.full_tensor()
        worst = max(worst, float((g - p.grad).abs().max()) / max(float(p.grad.abs().max()),
                                                                   1e-30))
    return {"train_loss": [float(want), float(got.full_tensor())], "train_grad": worst}


def run(rank: int, world: int, store_path: str, out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import distribute_model, make_decode_step, make_prefill_step
    from repro_torch.models import forward_decode, forward_prefill, init_params
    from repro_torch.sharding.rules import batch_spec, cache_spec

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        result = {"collectives": _collectives(mesh), "norm_conv": _watch_norm_conv()}
        # one kv head: it does not divide "model", so decode's cache has its
        # sequence sharded over "model"
        cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), num_kv_heads=1)
        model = init_params(cfg, seed=0, device="cpu")
        b = 4
        tokens = torch.randint(0, cfg.vocab_size, (b, PROMPT + DECODE),
                               generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            want, caches, n = forward_prefill(model, tokens[:, :PROMPT], SLOTS)
        placed = distribute_model(model, mesh)
        prefill, _ = make_prefill_step(cfg, mesh, InputShape("p", SLOTS, b, "prefill"))
        spec = batch_spec(mesh, b)
        got, mcaches, mn = prefill(placed, shard_tensor(tokens[:, :PROMPT], mesh, spec))
        result["prefill"] = float((got.full_tensor() - want).abs().max())
        result["prefill_scale"] = float(want.abs().max())
        result["prefill_cache"] = max(float((m.full_tensor() - c).abs().max())
                                      for mc, cc in zip(mcaches, caches)
                                      for m, c in zip(mc.values(), cc.values()))
        decode, _ = make_decode_step(cfg, mesh, InputShape("d", SLOTS, b, "decode"))
        mcaches = [{k: shard_tensor(t, mesh, cache_spec(cfg, mesh, k, tuple(t.shape)))
                    for k, t in c.items()} for c in caches]
        result["cache_placements"] = [str(p) for p in mcaches[0]["k"].placements]
        diffs, scales = [], []
        for i in range(PROMPT, PROMPT + DECODE):
            tok = tokens[:, i:i + 1]
            with torch.no_grad():
                want, caches, n = forward_decode(model, tok, caches, n)
            got, mcaches, mn = decode(placed, shard_tensor(tok, mesh, spec), mcaches, mn)
            diffs.append(float((got.full_tensor() - want).abs().max()))
            scales.append(float(want.abs().max()))
        result.update(decode=diffs, decode_scale=scales, n=[n, mn])
        result["train"] = {"olmoe": _train(model, placed, tokens[:, :PROMPT], mesh, b)}
        # jamba's smoke config: the SSD scan and the MoE layer on the mesh
        jcfg = get_smoke_config("jamba-1.5-large-398b")
        jamba = init_params(jcfg, seed=0, device="cpu")
        jtok = torch.randint(0, jcfg.vocab_size, (b, 2 * jcfg.ssm_chunk),
                             generator=torch.Generator().manual_seed(1))
        result["train"]["jamba"] = _train(jamba, distribute_model(jamba, mesh), jtok, mesh, b)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
