"""The mesh steps on the card's 1×1 mesh (``repro_torch.launch.steps`` on
``make_host_mesh()``), each held to the direct path it wraps at a smoke
config in bf16, with the kernels' launches by route.

Imports no JAX: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_steps_cuda.py``. Without a card every case skips.

On the 1×1 mesh every tensor is local, so a step runs the very kernels the
direct path runs, in the same order: the prefill and decode logits are
equal bit for bit; the train step's losses are ``train_step``'s (within
``chip_smoke.py``'s 1e-3 relative), its parameters after two steps differ
from ``train_step``'s by at most a tenth of the distance that
``train_step`` moved them (norms, per parameter: a skipped or botched
update differs by about the whole distance), and its launches are K2's
forward twice per layer (remat) and its backward once, all ``sm90``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models import forward_decode, forward_prefill, init_params, param_leaves
from repro_torch.train import make_optimizer, train_step

pytestmark = pytest.mark.cuda
B, S = 2, 64


@pytest.fixture
def host_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield mesh_mod.make_host_mesh()
    mesh_mod.release()


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")


def _tokens(cfg, n=S):
    gen = torch.Generator(device="cuda").manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (B, n), generator=gen, device="cuda")


def _routes(fn):
    return dict(fn.launches_by_route)


def _took(before, fn):
    return {r: n - before[r] for r, n in fn.launches_by_route.items()}


def test_train_step_on_the_host_mesh_equals_train_step(host_mesh):
    cfg = _cfg("qwen3-14b")
    tokens, labels = _tokens(cfg), _tokens(cfg).roll(1, dims=1)
    losses, params = {}, {}
    for path in ("direct", "step"):
        model = init_params(cfg, seed=0, device="cuda")
        model.requires_grad_(True)
        params["initial"] = {k: p.detach().clone() for k, p in model.named_parameters()}
        opt = make_optimizer("adamw")
        state = opt[0](param_leaves(model))
        fwd, bwd = _routes(flash_attention), _routes(flash_attention_bwd)
        losses[path] = []
        if path == "direct":
            for _ in range(2):
                state, loss = train_step(model, opt, state, tokens, labels, None, remat=True)
                losses[path].append(float(loss))
        else:
            step, args = make_train_step(cfg, host_mesh, InputShape("t", S, B, "train"))
            assert args[2].device.type == "meta"
            for _ in range(2):
                model, state, loss = step(model, state, tokens, labels)
                losses[path].append(float(loss))
            assert _took(fwd, flash_attention) == {"sm90": 2 * 2 * cfg.num_layers, "simt": 0}
            assert _took(bwd, flash_attention_bwd) == {"sm90": 2 * cfg.num_layers, "simt": 0}
        params[path] = {k: p.detach().float() for k, p in model.named_parameters()}
    assert losses["step"] == pytest.approx(losses["direct"], rel=1e-3)
    for k, want in params["direct"].items():
        moved = (want - params["initial"][k].float()).norm()
        assert (params["step"][k] - want).norm() <= 0.1 * moved, k


def test_prefill_and_decode_steps_equal_the_direct_path(host_mesh):
    cfg = _cfg("qwen3-14b")
    model = init_params(cfg, seed=0, device="cuda")
    tokens = _tokens(cfg, S + 1)
    cache = S + 4
    with torch.no_grad():
        want, wcaches, n = forward_prefill(model, tokens[:, :S], cache)
        wdec, _, _ = forward_decode(model, tokens[:, S:], wcaches, n)
    prefill, _ = make_prefill_step(cfg, host_mesh, InputShape("p", cache, B, "prefill"))
    decode, args = make_decode_step(cfg, host_mesh, InputShape("d", cache, B, "decode"))
    before = _routes(flash_attention)
    logits, caches, n = prefill(model, tokens[:, :S])
    assert _took(before, flash_attention) == {"sm90": cfg.num_layers, "simt": 0}
    assert torch.equal(logits, want)
    before = _routes(flash_attention)
    dec, _, n2 = decode(model, tokens[:, S:], caches, n)
    assert _took(before, flash_attention) == {"sm90": 0, "simt": 0}
    assert torch.equal(dec, wdec) and n2 == S + 1


def test_mamba2_prefill_step_runs_k3_sm90(host_mesh):
    cfg = _cfg("mamba2-1.3b")
    model = init_params(cfg, seed=0, device="cuda")
    tokens = _tokens(cfg, 128)
    with torch.no_grad():
        want, _, _ = forward_prefill(model, tokens, 129)
    prefill, _ = make_prefill_step(cfg, host_mesh, InputShape("p", 129, B, "prefill"))
    before = _routes(ssd_scan)
    logits, _, _ = prefill(model, tokens)
    assert _took(before, ssd_scan) == {"sm90": cfg.num_layers, "simt": 0}
    assert torch.equal(logits, want)


def test_a_step_on_the_cpu_mesh_does_not_launch(host_mesh):
    """The host mesh is on the card; on the CPU (asked for) the same step takes
    the kernels' plain versions and launches nothing."""
    mesh_mod.release()
    cpu_mesh = mesh_mod.make_host_mesh("cpu")
    cfg = get_smoke_config("qwen3-14b")
    model = init_params(cfg, seed=0, device="cpu")
    prefill, _ = make_prefill_step(cfg, cpu_mesh, InputShape("p", 20, B, "prefill"))
    before = flash_attention.launches
    logits, _, _ = prefill(model, torch.zeros((B, 16), dtype=torch.long))
    assert flash_attention.launches == before and logits.device.type == "cpu"
