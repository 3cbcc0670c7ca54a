"""The port's sharding rules, launch shapes, mesh steps, roofline and
per-device op counts (``repro_torch.sharding``, ``repro_torch.launch``) on
the CPU, held to ``repro.sharding`` and ``repro.launch``.

Counterparts of ``tests/test_sharding_launch.py``'s cases: the rules give
the reference's ``PartitionSpec`` (compared as tuples) for every parameter
of every config on the 16×16 and 2×16×16 meshes, and for every config's
decode caches; ``input_specs`` the reference's shapes and dtypes;
``config_for_shape`` the long-context window, with R4 (the decode ring
forgets the window once it wraps) pinned in both packages; the roofline's
formula with the H100's datasheet terms. The counter replaces the HLO
analyzer: its loop of 8 products and all-reduces, over a 2-rank fake
process group, counts 8× one product's FLOPs and one all-reduce's bytes,
and a small config's prefill on a 2×2 fake mesh counts a quarter of the
whole step's FLOPs, by hand. Last, the three mesh steps on the 1×1 CPU mesh
against the reference's jitted steps on its host mesh, on the same weights
and tokens (f32 smoke configs): the loss to 1e-5 relative, the parameters
after one AdamW step to 1e-4 absolute (two lr-sized steps in the few
entries whose gradient is ~0 and whose sign the ulps decide), the prefill
and decode logits to 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALIASES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import roofline as jax_roofline
from repro.launch import shapes as jax_shapes
from repro.launch import steps as jax_steps
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import init_params as jax_init_params
from repro.models.transformer import params_spec as jax_params_spec
from repro.sharding import rules as jax_rules
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.op_analysis import OpStats, analyze
from repro_torch.launch.roofline import (H100_HBM_BW, H100_NVLINK_BW, H100_PEAK_FLOPS_BF16,
                                         build_report, model_flops)
from repro_torch.launch.shapes import (INPUT_SHAPES, LONG_CONTEXT_WINDOW, InputShape,
                                       config_for_shape, input_specs)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step, make_train_step,
                                      param_shapes)
from repro_torch.models import (forward_decode, forward_prefill, param_leaves, params_from_jax,
                                params_spec, params_to_jax)
from repro_torch.models.convert import param_tree
from repro_torch.sharding import batch_spec, spec_for_shape
from repro_torch.sharding.rules import cache_spec, map_tree
from repro_torch.train import make_optimizer

ARCHS = sorted(ALIASES)
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def _jax_mesh(name):
    sizes = MESHES[name]
    devs = np.array(jax.devices() * 512)[:int(np.prod(list(sizes.values())))]
    return jax.sharding.Mesh(devs.reshape(tuple(sizes.values())), tuple(sizes))


def jax_host_mesh():
    """The reference's 1×1 host mesh with GSPMD's automatic axes (jax's
    ``make_mesh`` now makes explicit ones, under which the reference's
    ``with_sharding_constraint`` asserts instead of constraining)."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _spec_leaves(tree):
    """(path, logical axes) of a spec tree in a fixed order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", a) for k in sorted(tree) for p, a in _spec_leaves(tree[k])]
    if isinstance(tree, tuple) and not all(isinstance(a, (str, type(None))) for a in tree):
        return [(f"{i}/{p}", a) for i, t in enumerate(tree) for p, a in _spec_leaves(t)]
    return [("", tree)]


@pytest.fixture
def fake_group():
    """The process group a test makes, released after it (other test files
    share the worker)."""
    yield mesh_mod
    mesh_mod.release()


# -- logical-axis specs and the sharding rules --------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_spec_equals_reference(arch):
    assert params_spec(get_config(arch)) == jax_params_spec(jax_get_config(arch))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_every_parameter_equals_reference(arch, mesh_name):
    """Every parameter leaf: the port's shape equals the reference's, and its
    spec, as a tuple, the reference's ``P``."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jshapes = jax_steps.param_shapes(jcfg)
    shapes = map_tree(lambda leaf: tuple(leaf.shape), param_tree(param_shapes(cfg)))
    jmesh = _jax_mesh(mesh_name)
    spec = params_spec(cfg)
    pairs = _spec_leaves(spec)
    assert len(pairs) == len(jax.tree.leaves(jshapes))

    def at(tree, path):
        for k in path.split("/")[:-1]:
            tree = tree[int(k)] if isinstance(tree, (tuple, list)) else tree[k]
        return tree
    for path, axes in pairs:
        shape = at(shapes, path)
        assert shape == tuple(at(jshapes, path).shape), path
        want = jax_rules.spec_for_shape(axes, shape, jmesh)
        assert tuple(spec_for_shape(axes, shape, MESHES[mesh_name])) == tuple(want), path


@pytest.mark.parametrize("case", [
    (("embed", "ffn"), (4096, 27648)),
    (("embed", "heads", "head_dim"), (8192, 64, 128)),
    (("embed", "heads", "head_dim"), (5120, 40, 128)),     # no head_dim fallback
    (("vocab", "embed"), (50280, 2048)),
    (("layers", "experts", "embed", "ffn"), (61, 384, 7168, 2048)),
])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_for_shape_cases_equal_reference(case, mesh_name):
    axes, shape = case
    want = jax_rules.spec_for_shape(axes, shape, _jax_mesh(mesh_name))
    assert tuple(spec_for_shape(axes, shape, MESHES[mesh_name])) == tuple(want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_spec_equals_reference(mesh_name):
    jmesh = _jax_mesh(mesh_name)
    for batch in (1, 2, 13, 16, 32, 128, 256, 512):
        got = batch_spec(MESHES[mesh_name], batch)
        assert tuple(got) == tuple(jax_rules.batch_spec(jmesh, batch)), batch


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, mesh_name, shape_name):
    """Each of the port's per-layer caches takes the reference's spec of its
    stacked cache without the leading layers axis."""
    shape = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(get_config(arch), shape)
    jcfg = jax_shapes.config_for_shape(jax_get_config(arch), jax_shapes.INPUT_SHAPES[shape_name])
    jcaches = jax_shapes.input_specs(jcfg, jax_shapes.INPUT_SHAPES[shape_name])["caches"]
    jsh = jax_rules.cache_shardings(jcfg, _jax_mesh(mesh_name), jcaches)
    caches = input_specs(cfg, shape)["caches"]
    period = len(cfg.layout_pattern)
    for layer, c in enumerate(caches):
        assert set(c) == set(jsh[layer % period])
        for key, t in c.items():
            want = tuple(jsh[layer % period][key].spec)[1:]
            got = tuple(cache_spec(cfg, MESHES[mesh_name], key, tuple(t.shape)))
            assert got + (None,) * (len(want) - len(got)) == want, (layer, key)


# -- input shapes ---------------------------------------------------------------

def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    """Every input of every shape: the reference's shape and dtype (a cache
    per layer, the reference's stacked one without its layers axis)."""
    for name, shape in INPUT_SHAPES.items():
        jshape = jax_shapes.INPUT_SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == (
            jshape.seq_len, jshape.global_batch, jshape.kind)
        got = input_specs(get_config(arch), shape)
        want = jax_shapes.input_specs(jax_get_config(arch), jshape)
        assert set(got) == set(want), name
        for key in set(got) - {"caches"}:
            assert tuple(got[key].shape) == tuple(want[key].shape), (name, key)
            assert got[key].device.type == "meta"
            assert _dtype_name(got[key].dtype) == str(want[key].dtype), (name, key)
        if "caches" in got:
            period = len(get_config(arch).layout_pattern)
            for layer, c in enumerate(got["caches"]):
                for key, t in c.items():
                    w = want["caches"][layer % period][key]
                    assert tuple(t.shape) == tuple(w.shape[1:]), (name, layer, key)
                    assert _dtype_name(t.dtype) == str(w.dtype), (name, layer, key)


def test_long_context_window_and_r4_ring_pinned():
    """``config_for_shape`` sets the reference's window at long_500k only for
    attention archs; the windowed decode cache is a ring of the window; and
    R4: past the window both packages attend to ``cache_len % slots + 1``
    slots, the same logits step for step."""
    for arch in ("qwen3-14b", "mamba2-1.3b", "jamba-1.5-large-398b"):
        got = config_for_shape(get_config(arch), INPUT_SHAPES["long_500k"]).sliding_window
        want = jax_shapes.config_for_shape(jax_get_config(arch),
                                           jax_shapes.INPUT_SHAPES["long_500k"]).sliding_window
        assert got == want
    assert config_for_shape(get_config("qwen3-14b"), INPUT_SHAPES["long_500k"]
                            ).sliding_window == LONG_CONTEXT_WINDOW
    adj = config_for_shape(get_config("qwen3-14b"), INPUT_SHAPES["long_500k"])
    kv = [t for c in input_specs(adj, INPUT_SHAPES["long_500k"])["caches"] for t in c.values()]
    assert kv and all(t.shape[1] == LONG_CONTEXT_WINDOW for t in kv)

    window, prompt, steps = 4, 4, 4
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), sliding_window=window)
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-14b"), sliding_window=window)
    np_params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    model = params_from_jax(np_params, cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, prompt + steps),
                                               dtype=np.int32)
    with torch.no_grad():
        _, caches, n = forward_prefill(model, torch.from_numpy(tokens[:, :prompt]).long(), window)
    _, jcaches, jn = jax_forward_prefill(jparams, jcfg, jnp.asarray(tokens[:, :prompt]), window)
    from repro_torch.models import transformer
    seen = []
    real = transformer.decode_attention

    def spy(q, k, v, cache_len, window=None):
        seen.append(cache_len)
        return real(q, k, v, cache_len, window)
    transformer.decode_attention = spy
    try:
        for i in range(prompt, prompt + steps):
            with torch.no_grad():
                logits, caches, n = forward_decode(
                    model, torch.from_numpy(tokens[:, i:i + 1]).long(), caches, n)
            jlogits, jcaches, jn = jax_forward_decode(jparams, jcfg, jnp.asarray(tokens[:, i:i + 1]),
                                                      jcaches, jn)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
    finally:
        transformer.decode_attention = real
    # one valid length per layer and step: the ring wrapped, and only the
    # written slots up to the write position count (R4)
    per_step = [seen[i * cfg.num_layers] for i in range(steps)]
    assert per_step == [1, 2, 3, 4]


# -- roofline ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        got = model_flops(config_for_shape(get_config(arch), shape), shape)
        jshape = jax_shapes.INPUT_SHAPES[name]
        want = jax_roofline.model_flops(
            jax_shapes.config_for_shape(jax_get_config(arch), jshape), jshape)
        assert got == want, name


def test_build_report_uses_the_h100_terms():
    stats = OpStats(flops=3e15, traffic_bytes=5e12, collective_bytes=9e10,
                    collective_by_op={"all-gather": 6e10, "all-reduce": 3e10},
                    collective_count={"all-gather": 4, "all-reduce": 2})
    cfg, shape = get_config("qwen3-14b"), INPUT_SHAPES["train_4k"]
    rep = build_report("qwen3-14b", shape, "single", 256, stats, cfg, 6e10)
    assert rep.t_compute == pytest.approx(3e15 / 989e12)
    assert rep.t_memory == pytest.approx(5e12 / 3.35e12)
    assert rep.t_collective == pytest.approx(9e10 / 450e9)
    assert (H100_PEAK_FLOPS_BF16, H100_HBM_BW, H100_NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert rep.bottleneck == "compute" and rep.t_max == rep.t_compute
    assert rep.useful_ratio == pytest.approx(model_flops(cfg, shape) / (3e15 * 256))
    assert rep.fits_hbm is True
    assert build_report("x", shape, "single", 256, stats, cfg, 81e9).fits_hbm is False


# -- the counter (the HLO analyzer's counterpart) --------------------------------

def test_counter_multiplies_a_loop_of_products_and_all_reduces(fake_group):
    """8 × (a (128, 256) · (256, 256) product, then an all-reduce of its
    output) over a 2-rank fake group: 8× the FLOPs, the traffic and the
    collective bytes of one iteration."""
    import torch.distributed._functional_collectives as funcol
    mesh = fake_group.make_fake_mesh((2,), ("model",))
    w = torch.empty(256, 256, device="meta")

    def loop(x):
        for _ in range(8):
            x = funcol.wait_tensor(funcol.all_reduce(x @ w, "sum", mesh))
        return x
    _, stats = analyze(loop, torch.empty(128, 256, device="meta"))
    assert stats.flops == 8 * 2 * 128 * 256 * 256
    assert stats.collective_bytes == 8 * 128 * 256 * 4
    assert stats.collective_by_op == {"all-reduce": 8 * 128 * 256 * 4}
    assert stats.collective_count == {"all-reduce": 8}
    assert stats.traffic_bytes == 8 * (128 * 256 + 256 * 256 + 128 * 256) * 4


def test_dry_run_on_a_2x2_mesh_counts_a_quarter_of_the_step(fake_group):
    """A small dense config's prefill on a 2×2 fake mesh, batch over data and
    heads, ffn and vocab over model: each device does a quarter of the
    step's FLOPs, counted by hand (projections, MLP, K2's attended pairs,
    the last token's logits), and every product's weight comes by
    all-gather (FSDP), every row-parallel output by all-reduce."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), num_heads=4, num_kv_heads=2,
                              d_model=128, d_ff=256, qk_norm=False)
    b, s = 4, 64
    mesh = fake_group.make_fake_mesh((2, 2), ("data", "model"))
    step, args = make_prefill_step(cfg, mesh, InputShape("p", s, b, "prefill"))
    (logits, caches, n), stats = analyze(step, *args)
    d, h, kv, hd, f, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                          cfg.d_ff, cfg.vocab_size)
    per_layer = (2 * b * s * d * (h + 2 * kv) * hd + 2 * b * s * h * hd * d
                 + 3 * 2 * b * s * d * f + 4 * hd * b * h * s * (s + 1) // 2)
    assert stats.flops == (cfg.num_layers * per_layer + 2 * b * d * v) / 4
    assert set(stats.collective_count) == {"all-gather", "all-reduce"}
    assert tuple(logits.shape) == (b, 1, v) and n == s
    assert tuple(logits.to_local().shape) == (b // 2, 1, v // 2)


def test_run_one_records_a_failure_with_its_error(fake_group, tmp_path, monkeypatch):
    """A combination that fails is a record with ``ok: false`` and its error
    (a Mamba2 prefill on the 16×16 mesh whose prompt, over one chunk, is no
    multiple of it: the reference raises there too), never dropped; an MoE
    train step on the 16×16 mesh is ``ok`` (the MoE layer's mesh path); a
    host-mesh run is a record with the three terms."""
    import repro_torch.launch.dryrun as dryrun
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    cfg = get_smoke_config("mamba2-1.3b")
    rec = run_one("mamba2-1.3b", InputShape("p", 200, 16, "prefill"), "single", cfg=cfg,
                  verbose=False)
    assert rec["ok"] is False and "multiple of chunk 16" in rec["error"]
    assert (tmp_path / "mamba2-1.3b__p__single.json").exists()
    rec = run_one("olmoe-1b-7b", InputShape("t", 128, 16, "train"), "single",
                  cfg=get_smoke_config("olmoe-1b-7b"), verbose=False)
    assert rec["ok"], rec.get("error")
    assert rec["collective_by_op"]["all-to-all"] > 0
    rec = run_one("mamba2-1.3b", InputShape("p", 128, 2, "prefill"), "host", cfg=cfg,
                  verbose=False)
    assert rec["ok"] and rec["per_device_flops"] > 0 and rec["memory_note"]
    assert rec["bottleneck"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("mesh_name", ["host", "single"])
def test_mamba2_train_step_runs_with_the_ssd_backward_counted(fake_group, mesh_name,
                                                              monkeypatch):
    """mamba2's train step is ``ok`` on the 1×1 and the 16×16 mesh, K3's
    backward counted by its FLOP formula: the record with the formula less
    the one without it is one backward a layer, hand counted (chunk 16,
    B·H rows of S/16 chunks, on one device's shard of the batch and the
    heads)."""
    import importlib
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
    cfg = get_smoke_config("mamba2-1.3b")
    shape = InputShape("t", 128, 32, "train")
    rec = run_one("mamba2-1.3b", shape, mesh_name, cfg=cfg, save=False, verbose=False)
    assert rec["ok"], rec.get("error")
    monkeypatch.setattr(ssd, "bwd_flops_per_chunk", lambda q, n, p: 0)
    without = run_one("mamba2-1.3b", shape, mesh_name, cfg=cfg, save=False, verbose=False)
    # 16×16: the batch over "data"; the heads, which reach the scan replicated
    # over "model", split over it (16 heads)
    rows = shape.global_batch * cfg.ssm_heads // (1 if mesh_name == "host" else 16 * 16)
    per_chunk = (2 * 16 * 16 * (3 * cfg.ssm_state + 2 * cfg.ssm_head_dim)
                 + 10 * 16 * cfg.ssm_state * cfg.ssm_head_dim)
    assert rec["per_device_flops"] - without["per_device_flops"] == (
        cfg.num_layers * rows * (128 // 16) * per_chunk)


def test_a_real_step_on_a_fake_mesh_raises(fake_group):
    cfg = get_smoke_config("qwen3-14b")
    mesh = fake_group.make_fake_mesh((2, 2), ("data", "model"))
    step, _ = make_prefill_step(cfg, mesh, InputShape("p", 16, 4, "prefill"))
    model = params_from_jax(jax.tree.map(np.asarray, jax_init_params(
        jax_smoke_config("qwen3-14b"), jax.random.PRNGKey(0))), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="dry run only"):
        step(model, torch.zeros((4, 16), dtype=torch.long))


# -- the mesh steps on the 1×1 CPU mesh against the reference's jitted steps ---------

def _pair(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    np_params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    return cfg, jcfg, np_params


def test_train_step_equals_reference_jitted_step(fake_group):
    cfg, jcfg, np_params = _pair("phi4-mini-3.8b")
    shape = InputShape("train_small", 32, 4, "train")
    jstep, _ = jax_steps.make_train_step(jcfg, jax_host_mesh(), jax_shapes.InputShape(
        "train_small", 32, 4, "train"))
    init, _ = jax_make_optimizer("adamw")
    jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
    with jax.set_mesh(jax_host_mesh()):
        jnew, _, jloss = jstep(jparams, init(jparams), jnp.asarray(tokens), jnp.asarray(labels))

    step, args = make_train_step(cfg, fake_group.make_host_mesh("cpu"), shape)
    assert args[2].device.type == "meta" and args[2].dtype == torch.int32
    model = params_from_jax(np_params, cfg, device="cpu")
    model.requires_grad_(True)
    state = make_optimizer("adamw")[0](param_leaves(model))
    model, state, loss = step(model, state, torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want = params_to_jax(model), jax.tree.map(np.asarray, jnew)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_cross_entropy_equals_reference_on_plain_and_dtensor_logits(fake_group):
    """``steps.cross_entropy``: the gather on plain logits, the reference's
    one-hot contraction on a ``DTensor`` (here on the 1×1 CPU mesh), both
    equal to the reference's loss on the same logits and labels."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.steps import cross_entropy
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 50), dtype=np.float32)
    labels = rng.integers(0, 50, (2, 8), dtype=np.int32)
    want = float(jax_steps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    plain = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    mesh = fake_group.make_host_mesh("cpu")
    onehot = cross_entropy(*(DTensor.from_local(torch.from_numpy(a), mesh, [Replicate()] * 2)
                             for a in (logits, labels)))
    assert isinstance(onehot, DTensor) and type(plain) is torch.Tensor
    np.testing.assert_allclose(float(plain), want, rtol=1e-6)
    np.testing.assert_allclose(float(onehot.to_local()), want, rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b"])
def test_prefill_and_decode_steps_equal_reference_jitted_steps(fake_group, arch):
    cfg, jcfg, np_params = _pair(arch)
    b, s, cache = 2, 16, 24
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
    jmesh, mesh = jax_host_mesh(), fake_group.make_host_mesh("cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = params_from_jax(np_params, cfg, device="cpu")

    jprefill, _ = jax_steps.make_prefill_step(jcfg, jmesh, jax_shapes.InputShape(
        "p", cache, b, "prefill"))
    with jax.set_mesh(jmesh):
        jlogits, jcaches, jn = jprefill(jparams, jnp.asarray(tokens[:, :s]))
    prefill, args = make_prefill_step(cfg, mesh, InputShape("p", cache, b, "prefill"))
    assert tuple(args[1].shape) == (b, cache)
    logits, caches, n = prefill(model, torch.from_numpy(tokens[:, :s]))
    assert n == int(jn) == s
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)

    jdecode, _ = jax_steps.make_decode_step(jcfg, jmesh, jax_shapes.InputShape(
        "d", cache, b, "decode"))
    with jax.set_mesh(jmesh):
        jlogits, _, jn = jdecode(jparams, jnp.asarray(tokens[:, s:]), jcaches, jn)
    decode, args = make_decode_step(cfg, mesh, InputShape("d", cache, b, "decode"))
    assert args[3] == cache - 1
    logits, _, n = decode(model, torch.from_numpy(tokens[:, s:]), caches, n)
    assert n == int(jn) == s + 1
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)


def test_kernel_ops_on_meta_count_their_work_without_running():
    """K2 (forward and backward) and K3 on meta tensors take their custom
    ops' fake kernels: outputs of the right shapes, no launch, and each
    call counted by its FLOP formula (K2's attended pairs, K3's chunks)."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    q, k, v = meta(8, 64, 32), meta(4, 64, 32), meta(4, 64, 32)
    launches = fa.flash_attention.launches
    (out, lse), stats = analyze(lambda: fa.flash_attention(q, k, v, q_heads_per_kv=2,
                                                           window=16, return_lse=True))
    assert tuple(out.shape) == (8, 64, 32) and tuple(lse.shape) == (8, 64)
    assert out.device.type == "meta" and lse.dtype == torch.float32
    assert stats.flops == 8 * 4 * 32 * fa.attended_pairs(64, 64, True, 16, 0)
    assert fa.attended_pairs(64, 64, True, 16, 0) == sum(min(i + 1, 16) for i in range(64))
    (dq, dk, dv), stats = analyze(lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, meta(8, 64, 32), q_heads_per_kv=2, window=16))
    assert [tuple(t.shape) for t in (dq, dk, dv)] == [(8, 64, 32), (4, 64, 32), (4, 64, 32)]
    assert stats.flops == 8 * 10 * 32 * fa.attended_pairs(64, 64, True, 16, 0)
    assert fa.flash_attention.launches == launches and stats.collective_count == {}

    x, dt, a = meta(8, 128, 32), meta(8, 128, dtype=torch.float32), meta(8, dtype=torch.float32)
    bm, cm = meta(4, 128, 16), meta(4, 128, 16)
    (y, state), stats = analyze(lambda: ssd.ssd_scan(x, dt, a, bm, cm, chunk=64,
                                                     heads_per_group=2))
    assert tuple(y.shape) == (8, 128, 32) and tuple(state.shape) == (8, 16, 32)
    assert state.dtype == torch.float32
    assert stats.flops == 8 * 2 * (2 * 64 * 64 * (16 + 32) + 4 * 64 * 16 * 32)
