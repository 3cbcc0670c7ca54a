"""AdamW's update kernel (``csrc/adamw.cu``) on the card.

Imports no JAX, so it runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_adamw_cuda.py``.
Without a card every case skips.

The kernel rounds every step as PyTorch's eager ops do in
``adamw_update_plain``, so p, m and v are held to it bit for bit
(``torch.equal``), with no tolerance.
"""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import adamw as ka
from repro_torch.models import init_params, param_leaves
from repro_torch.train import AdamWConfig, adamw, train_step

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")]

DTYPES = (torch.float32, torch.bfloat16)
SIZES = (0, 1, 3, 7, 8, 9, 31, 1000, 8191, 8193, 1 << 20, (1 << 22) + 5)


def _state(sizes, dtype, seed):
    """p, g, m, v on the card: g from 1e-30 to 1e4 in magnitude, zeros in
    places; m and v as after a few steps."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = [[], [], [], []]
    for n in sizes:
        def randn():
            return torch.randn(n, generator=gen, device="cuda")
        sign = torch.where(randn() < 0, -1.0, 1.0)
        g = sign * 10.0 ** (torch.rand(n, generator=gen, device="cuda") * 34 - 30)
        g[torch.rand(n, generator=gen, device="cuda") < 0.1] = 0.0
        out[0].append(randn().to(dtype))
        out[1].append(g.to(dtype))
        out[2].append(randn() * 1e-2)
        out[3].append(randn().abs() * 1e-4)
    return out


def _bias(step, cfg):
    t = torch.tensor(step, dtype=torch.int32, device="cuda").float()
    return 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t


def _clone(lists):
    return [[t.clone() for t in ts] for ts in lists]


def _run_both(lists, cfg, steps=(1, 2, 3)):
    """Kernel on ``lists``, plain on a copy, step by step: the kernel's
    launches, and whether p, m and v agree bit for bit after every step."""
    plain = _clone(lists)
    before, equal = ka.adamw_update.launches, []
    for step in steps:
        bc1, bc2 = _bias(step, cfg)
        ka.adamw_update(*lists, bc1, bc2, cfg)
        ka.adamw_update_plain(*plain, bc1, bc2, cfg)
        torch.cuda.synchronize()
        equal.append(all(torch.equal(a, b) for a, b in zip(sum(lists, []), sum(plain, []))))
    return ka.adamw_update.launches - before, equal


@pytest.mark.parametrize("cfg", [AdamWConfig(), AdamWConfig(lr=1e-3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_equals_plain_bit_for_bit(dtype, cfg):
    lists = _state(SIZES, dtype, 0)
    launches, equal = _run_both(lists, cfg)
    assert equal == [True, True, True]
    assert launches == 3 * len(ka.plan_launches([(p.numel(), p.dtype) for p in lists[0]]))


def test_more_tensors_than_one_launch_and_both_dtypes():
    n = ka.MAX_TENSORS + 37
    bf = _state([(i * 37) % 300 for i in range(n)], torch.bfloat16, 1)
    f32 = _state((5, 4096, 0, 77), torch.float32, 2)
    lists = [a + b for a, b in zip(bf, f32)]
    launches, equal = _run_both(lists, AdamWConfig(), steps=(1, 3))
    assert equal == [True, True]
    assert launches == 2 * 3                 # two bf16 launches and one f32, twice


@pytest.mark.parametrize("dtype", DTYPES)
def test_unaligned_tensors_take_the_element_path(dtype):
    """Views one element into a buffer: not 16-byte aligned, still exact."""
    cfg = AdamWConfig()
    base = _state((1025, 70001), dtype, 3)
    lists = [[t.new_empty(t.numel() + 1)[1:].copy_(t) for t in ts] for ts in base]
    assert all(t.data_ptr() % 16 for ts in lists for t in ts)
    launches, equal = _run_both(lists, cfg)
    assert equal == [True, True, True] and launches == 3


def test_same_bits_twice():
    cfg = AdamWConfig()
    a = _state(SIZES, torch.bfloat16, 4)
    b = _clone(a)
    for lists in (a, b):
        for step in (1, 2):
            ka.adamw_update(*lists, *_bias(step, cfg), cfg)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(sum(a, []), sum(b, [])))


def test_refusals_on_the_card_launch_nothing():
    cfg = AdamWConfig()
    bc1, bc2 = _bias(1, cfg)
    before = ka.adamw_update.launches
    strided = _state((64,), torch.bfloat16, 5)
    strided = [[t.reshape(8, 8).T for t in ts] for ts in strided]
    mixed = _state((64, 64), torch.bfloat16, 6)
    mixed[2][1] = mixed[2][1].cpu()
    for lists in (strided, mixed):
        with pytest.raises(ValueError):
            ka.adamw_update(*lists, bc1, bc2, cfg)
    with pytest.raises(ValueError):
        ka.adamw_update(*_state((8,), torch.float32, 7), bc1.cpu(), bc2, cfg)
    assert ka.adamw_update.launches == before


def test_optimizer_on_the_card_launches_the_kernel_and_equals_plain(monkeypatch):
    """Two smoke-config steps of phi4 and mamba2 (64 tokens): the
    optimizer's update goes to the kernel, the planner's launches a step,
    and the weights equal those of the same steps with the plain update."""
    from repro_torch.train import optimizer as opt_mod
    for arch in ("phi4-mini-3.8b", "mamba2-1.3b"):
        cfg = get_smoke_config(arch)
        tokens = torch.randint(0, cfg.vocab_size, (2, 65), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(0))
        weights = {}
        for route in ("kernel", "plain"):
            if route == "plain":
                monkeypatch.setattr(opt_mod, "adamw_update", ka.adamw_update_plain)
            model = init_params(cfg, seed=0, device="cuda")
            model.requires_grad_(True)
            opt = adamw(AdamWConfig(lr=3e-3))
            state = opt[0](param_leaves(model))
            before = ka.adamw_update.launches
            for _ in range(2):
                state, _ = train_step(model, opt, state, tokens[:, :-1], tokens[:, 1:])
            torch.cuda.synchronize()
            launched = ka.adamw_update.launches - before
            per_step = len(ka.plan_launches([(t.numel(), t.dtype) for leaf in param_leaves(model)
                                             for t in leaf.tensors]))
            assert launched == (2 * per_step if route == "kernel" else 0)
            weights[route] = [p.detach().clone() for p in model.parameters()]
        monkeypatch.undo()
        assert all(torch.equal(a, b) for a, b in zip(weights["kernel"], weights["plain"]))
