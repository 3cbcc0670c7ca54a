"""The port's training substrate (``repro_torch.train``) on the CPU, held to
``repro.train`` on the same numpy inputs.

Counterparts of the nine cases of ``tests/test_train.py`` come first, then
parity with the reference: the optimizers step for step, each step from the
reference's weights and state of the step before, on identical gradients
(to a few ulps: ``b ** t``, ``rsqrt`` and XLA's reductions round their last
bit differently); the Markov data bit for bit; ``params_to_jax`` inverting
``params_from_jax`` bit for bit on every smoke config; the msgpack
codec byte for byte; checkpoints in both directions bit for bit; five train
steps of phi4's smoke config on converted weights (losses to 1e-5 relative:
the gradients agree to ~1e-6, which Adam's normalisation carries into the
weights), and of mamba2's over four SSD chunks through ``SsdScanFn``; remat
on and off giving the same bits.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import ALIASES
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.train import checkpoint as jax_checkpoint
from repro.train import data as jax_data
from repro.train import optimizer as jax_optimizer
from repro.train.loop import cross_entropy_loss as jax_cross_entropy_loss
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import param_leaves, params_from_jax, params_to_jax
from repro_torch.models.convert import flatten, to_numpy, tree_leaves
from repro_torch.train import (
    DataConfig,
    MarkovDataset,
    TrainConfig,
    adafactor,
    adamw,
    make_optimizer,
    optimizer_for_config,
    restore_checkpoint,
    save_checkpoint,
    train,
    train_step,
)
from repro_torch.train import _msgpack


# -- optimizers -------------------------------------------------------------

def _quadratic_params():
    return {"w": torch.tensor([3.0, -2.0, 1.0]), "b": torch.tensor(5.0)}


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(opt_name):
    init, update = make_optimizer(opt_name, lr=0.1)
    params = tree_leaves(_quadratic_params())
    state = init(params)

    def loss(p):
        return float(sum((leaf.tensors[0] ** 2).sum() for leaf in p))

    for _ in range(200):
        grads = [[2.0 * leaf.tensors[0]] for leaf in params]
        params, state = update(grads, state, params)
    assert loss(params) < 0.05


def test_adamw_step_counts_and_shapes():
    init, update = adamw()
    params = tree_leaves({"a": torch.ones((4, 8)), "b": torch.zeros((3,))})
    state = init(params)
    grads = [[torch.ones_like(t) for t in leaf.tensors] for leaf in params]
    new_params, new_state = update(grads, state, params)
    assert int(new_state.step) == 1
    assert [leaf.shape for leaf in new_params] == [(4, 8), (3,)]
    assert new_params[0].tensors[0].shape == (4, 8)


def test_adafactor_factored_state_is_small():
    init, _ = adafactor()
    params = tree_leaves({"w": torch.ones((512, 256))})
    state = init(params)
    leaf = state.inner[0]
    assert "vr" in leaf and "vc" in leaf and "v" not in leaf
    assert leaf["vr"].shape == (512,)
    assert leaf["vc"].shape == (256,)
    # factored state is ~2 orders smaller than the full second moment
    assert leaf["vr"].numel() + leaf["vc"].numel() < 512 * 256 / 100


def test_optimizer_for_config_picks_adafactor_for_1t():
    assert optimizer_for_config(get_config("kimi-k2-1t-a32b")) == "adafactor"
    assert optimizer_for_config(get_config("phi4-mini-3.8b")) == "adamw"


# -- data -----------------------------------------------------------------

def test_markov_dataset_deterministic_and_shaped():
    cfg = DataConfig(vocab_size=64, seq_len=16, batch_size=4, seed=3)
    d1, d2 = MarkovDataset(cfg), MarkovDataset(cfg)
    b1 = next(d1.batches())
    b2 = next(d2.batches())
    np.testing.assert_array_equal(b1[0], b2[0])
    tokens, labels = b1
    assert tokens.shape == (4, 16) and labels.shape == (4, 16)
    np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])  # shifted
    assert 0 < d1.entropy() < np.log(64)


@settings(max_examples=20, deadline=None)
@given(st.integers(8, 128), st.integers(0, 100))
def test_markov_tokens_in_range(vocab, seed):
    cfg = DataConfig(vocab_size=vocab, seq_len=8, batch_size=2, seed=seed)
    tokens, labels = next(MarkovDataset(cfg).batches())
    assert tokens.min() >= 0 and tokens.max() < vocab


# -- checkpointing ------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    params = {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
              "b": torch.ones((2,), dtype=torch.float32)}
    opt = {"m": {k: torch.zeros_like(v) for k, v in params.items()}}
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, params, opt, step=42, meta={"note": "x"})
    like = {k: torch.full_like(v, 7) for k, v in params.items()}
    opt_like = {"m": {k: torch.full_like(v, 7) for k, v in params.items()}}
    p2, o2, step, meta = restore_checkpoint(path, like, opt_like)
    assert step == 42 and meta["note"] == "x"
    for a, b in zip(flatten(params), flatten(p2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(bool((t == 0).all()) for t in flatten(o2))


# -- end-to-end: the model learns the chain ---------------------------------

def test_training_reduces_loss():
    cfg = get_smoke_config("phi4-mini-3.8b")
    res = train(cfg, TrainConfig(steps=60, batch_size=8, seq_len=32,
                                 lr=3e-3, log_every=0), device="cpu")
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    assert last < first - 0.5, (first, last)
    assert last > res.loss_floor - 0.05  # can't beat the entropy floor


def test_training_checkpoint_resume(tmp_path):
    cfg = get_smoke_config("mamba2-1.3b")
    path = str(tmp_path / "ck.msgpack")
    train(cfg, TrainConfig(steps=20, batch_size=4, seq_len=32, lr=1e-3,
                           log_every=0, checkpoint_path=path,
                           checkpoint_every=20), device="cpu")
    assert os.path.exists(path)
    r2 = train(cfg, TrainConfig(steps=30, batch_size=4, seq_len=32, lr=1e-3,
                                log_every=0, checkpoint_path=path,
                                checkpoint_every=100), device="cpu")
    assert len(r2.losses) == 10  # resumed from step 20


# -- parity with the reference ------------------------------------------------

def _reference_tree(dtype, arch="phi4-mini-3.8b"):
    """A smoke config's weights (two layers stacked) as a numpy tree of ``dtype``."""
    cfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    return cfg, jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))


def _port_model(np_params, dtype, arch="phi4-mini-3.8b"):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    return params_from_jax(np_params, cfg, device="cpu")


def _grads_for(np_params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.3).astype(np.float32).astype(p.dtype),
        np_params)


def _to_port_grads(leaves, np_grads):
    out = []
    for leaf, g in zip(leaves, jax.tree.leaves(np_grads)):
        t = torch.from_numpy(np.asarray(g, np.float32)).to(leaf.dtype)
        out.append(list(t) if leaf.stacked else [t])
    return out


def _bf16_bits_to_f32(a):
    return (a.astype(np.uint32) << 16).view(np.float32)


def _f32(x):
    """A port leaf (tensor or Leaf) as a float32 numpy array."""
    t = x.value() if hasattr(x, "value") else x
    a = to_numpy(t)
    return _bf16_bits_to_f32(a) if t.dtype == torch.bfloat16 else a.astype(np.float32)


def _leaf_ulps(got, want, dtype):
    """max |got - want| in ulps of the leaf's largest magnitude, in ``dtype``."""
    scale = float(np.abs(want).max())
    if scale == 0.0:
        return float(np.abs(got).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - (7 if dtype == "bfloat16" else 23))
    return float(np.abs(got - want).max() / ulp)


def _load_reference_into(port_tree, ref_tree):
    for x, w in zip(flatten(port_tree), jax.tree.leaves(ref_tree)):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            value = torch.from_numpy(w.view(np.int16).copy()).view(torch.bfloat16)
        else:
            value = torch.from_numpy(w.copy())
        if hasattr(x, "assign"):
            x.assign(value)
        else:
            x.copy_(value.reshape(x.shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_step_for_step(opt_name, dtype):
    """Steps 1-3, each from the reference's weights and state of the step
    before, on the same gradients: every parameter and state leaf within 4
    ulps of the leaf's largest magnitude (bf16 leaves: 1 bf16 ulp, as a few
    f32 ulps can move the rounding of Adafactor's bf16 moment)."""
    _, np_params = _reference_tree(dtype)
    j_init, j_update = jax_optimizer.make_optimizer(opt_name, lr=1e-2)
    j_params = jax.tree.map(jnp.asarray, np_params)
    j_state = j_init(j_params)
    model = _port_model(np_params, dtype)
    leaves = param_leaves(model)
    init, update = make_optimizer(opt_name, lr=1e-2)
    state = init(leaves)
    for step in range(3):
        _load_reference_into((leaves, state), (j_params, j_state))
        np_grads = _grads_for(np_params, step)
        j_params, j_state = j_update(jax.tree.map(jnp.asarray, np_grads), j_state, j_params)
        leaves, state = update(_to_port_grads(leaves, np_grads), state, leaves)
        want = [np.asarray(x) for x in jax.tree.leaves((j_params, j_state))]
        got = [_f32(x) for x in flatten((leaves, state))]
        assert len(got) == len(want)
        assert int(flatten(state)[0]) == int(j_state.step) == step + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape
            d = w.dtype.name
            limit = 1 if d == "bfloat16" else 4
            assert _leaf_ulps(g, w.astype(np.float32), d) <= limit, (step, d, g.shape)


@pytest.mark.parametrize("vocab,seq,batch,seed,branching",
                         [(64, 16, 4, 3, 4), (1000, 33, 3, 7, 4), (257, 8, 2, 0, 2),
                          (200064, 12, 2, 5, 4)])
def test_markov_batches_and_entropy_bit_equal(vocab, seq, batch, seed, branching):
    kw = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed, branching=branching)
    ours = MarkovDataset(DataConfig(**kw))
    ref = jax_data.MarkovDataset(jax_data.DataConfig(**kw))
    assert ours.entropy() == ref.entropy()
    for start in (0, 11):
        for (t1, l1), (t2, l2), _ in zip(ours.batches(start), ref.batches(start), range(3)):
            assert t1.dtype == t2.dtype
            np.testing.assert_array_equal(t1, t2)
            np.testing.assert_array_equal(l1, l2)


PAYLOADS = {
    "checkpoint_like": {"step": 42, "meta": {"note": "x", "lr": 0.001, "flag": True,
                                             "none": None, "off": False},
                        "treedef_params": "PyTreeDef({'b': *, 'w': *})",
                        "params": [{"dtype": "<f4", "shape": [2, 3], "data": b"\x00" * 24},
                                   {"dtype": "bfloat16", "shape": [], "data": b"\x80\x3f"}]},
    "widths": {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                        2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                        -2 ** 31, -2 ** 31 - 1, -2 ** 63],
               "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
               "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536],
               "floats": [0.0, -1.5, 1e300, float("inf")],
               "lists": [list(range(15)), list(range(16)), list(range(70000))],
               "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
                        {str(i): i for i in range(70000)}]},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_msgpack_codec_round_trips_and_matches_msgpack(name):
    payload = PAYLOADS[name]
    ours = _msgpack.packb(payload)
    assert ours == msgpack.packb(payload, use_bin_type=True)
    assert _msgpack.unpackb(ours) == payload
    assert msgpack.unpackb(ours, raw=False) == payload


def _stepped_reference(dtype, opt_name, np_params):
    """The reference's weights and optimizer state after one update."""
    init, update = jax_optimizer.make_optimizer(opt_name, lr=1e-2)
    params = jax.tree.map(jnp.asarray, np_params)
    return update(jax.tree.map(jnp.asarray, _grads_for(np_params, 0)), init(params), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_reference_checkpoint_restores_bit_for_bit(tmp_path, opt_name, dtype):
    _, np_params = _reference_tree(dtype)
    j_params, j_state = _stepped_reference(dtype, opt_name, np_params)
    path = str(tmp_path / "ref.msgpack")
    jax_checkpoint.save_checkpoint(path, j_params, j_state, step=7, meta={"note": "x"})
    # a model of other weights and a fresh state take the file's values
    other = jax.tree.map(lambda a: np.zeros_like(a), np_params)
    model = _port_model(other, dtype)
    state = make_optimizer(opt_name)[0](param_leaves(model))
    model, state, step, meta = restore_checkpoint(path, model, state)
    assert step == 7 and meta == {"note": "x"}
    want = [np.asarray(x) for x in jax.tree.leaves((j_params, j_state))]
    got = [to_numpy(x.value() if hasattr(x, "value") else x)
           for x in flatten((param_leaves(model), state))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_port_checkpoint_restores_in_reference_bit_for_bit(tmp_path, opt_name, dtype):
    _, np_params = _reference_tree(dtype)
    model = _port_model(np_params, dtype)
    leaves = param_leaves(model)
    init, update = make_optimizer(opt_name, lr=1e-2)
    leaves, state = update(_to_port_grads(leaves, _grads_for(np_params, 0)), init(leaves),
                           leaves)
    path = str(tmp_path / "port.msgpack")
    save_checkpoint(path, model, state, step=9, meta={"note": "y"})
    j_like = jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)), np_params)
    j_init, _ = jax_optimizer.make_optimizer(opt_name)
    j_params, j_state, step, meta = jax_checkpoint.restore_checkpoint(path, j_like,
                                                                      j_init(j_like))
    assert step == 9 and meta == {"note": "y"}
    want = [to_numpy(x.value() if hasattr(x, "value") else x) for x in flatten((leaves, state))]
    got = [np.asarray(x) for x in jax.tree.leaves((j_params, j_state))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.view(np.uint16) if g.dtype.name == "bfloat16" else g
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _steps_beside_jitted_reference(arch, seq_len, batch_size):
    """Five AdamW steps of ``arch``'s smoke config (f32) on converted weights
    and the reference's Markov batches, through ``train_step`` and the
    reference's jitted step: (the port's losses, the reference's)."""
    jcfg, np_params = _reference_tree("float32", arch)
    init, update = jax_optimizer.make_optimizer("adamw", lr=3e-3)

    @jax.jit
    def step_fn(params, opt_state, tokens, labels):
        def loss_fn(p):
            return jax_cross_entropy_loss(jax_forward_train(p, jcfg, tokens, None, remat=False),
                                          labels)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        new_params, new_opt = update(grads, opt_state, params)
        return new_params, new_opt, loss

    j_params = jax.tree.map(jnp.asarray, np_params)
    j_state = init(j_params)
    model = _port_model(np_params, "float32", arch)
    model.requires_grad_(True)
    opt = make_optimizer("adamw", lr=3e-3)
    state = opt[0](param_leaves(model))
    data = MarkovDataset(DataConfig(vocab_size=jcfg.vocab_size, seq_len=seq_len,
                                    batch_size=batch_size))
    want, got = [], []
    for _, (tokens, labels) in zip(range(5), data.batches()):
        j_params, j_state, loss = step_fn(j_params, j_state, jnp.asarray(tokens),
                                          jnp.asarray(labels))
        want.append(float(loss))
        state, loss = train_step(model, opt, state, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(labels).long(), None)
        got.append(float(loss))
    return got, want


def test_train_steps_match_reference_jitted_step():
    """Five AdamW steps of phi4's smoke config on converted weights and the
    reference's Markov batches: the loss of every step to 1e-5 relative."""
    got, want = _steps_beside_jitted_reference("phi4-mini-3.8b", 32, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_mamba2_train_steps_match_reference_jitted_step(monkeypatch):
    """The same for mamba2's smoke config (two ``ssm`` layers) at 64 tokens,
    four chunks of 16: the SSD scan's gradient goes through ``SsdScanFn``
    (its plain backward on the CPU), once per layer and step."""
    import importlib
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
    calls = []
    backward = ssd.SsdScanFn.backward
    monkeypatch.setattr(ssd.SsdScanFn, "backward",
                        staticmethod(lambda ctx, *g: calls.append(1) or backward(ctx, *g)))
    got, want = _steps_beside_jitted_reference("mamba2-1.3b", 64, 2)
    assert len(calls) == 5 * get_smoke_config("mamba2-1.3b").num_layers
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_remat_on_and_off_give_the_same_bits():
    cfg = get_smoke_config("phi4-mini-3.8b")
    results = []
    for remat in (False, True):
        res = train(cfg, TrainConfig(steps=4, batch_size=4, seq_len=32, lr=3e-3, log_every=0,
                                     remat=remat), device="cpu")
        results.append(res.losses)
    assert results[0] == results[1]


def test_launcher_trains_the_smoke_config_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import train as launcher
    monkeypatch.setattr(sys, "argv", ["train", "--device", "cpu", "--steps", "3",
                                      "--batch", "2", "--seq", "16"])
    launcher.main()
    out = capsys.readouterr().out
    assert "arch=phi4-smoke" in out and "remat=False" in out and "[train] loss" in out


def test_launcher_remat_switch_turns_remat_on_for_the_smoke_config(monkeypatch, capsys):
    from repro_torch.launch import train as launcher
    monkeypatch.setattr(sys, "argv", ["train", "--device", "cpu", "--steps", "2",
                                      "--batch", "2", "--seq", "16", "--remat"])
    launcher.main()
    out = capsys.readouterr().out
    assert "arch=phi4-smoke" in out and "remat=True" in out and "[train] loss" in out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_params_to_jax_inverts_params_from_jax(arch, dtype):
    """The reference's tree, through the port's model and back, bit for bit:
    the same structure, shapes, dtypes and values, blocks restacked per
    pattern position (and an encoder's over its layers)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    np_params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(3)))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    back = params_to_jax(params_from_jax(np_params, cfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        # bf16 leaves come back as their uint16 bits
        assert a.dtype == (np.uint16 if b.dtype == jnp.bfloat16 else b.dtype)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
