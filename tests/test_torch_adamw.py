"""AdamW's update (``repro_torch.kernels.adamw``) without a card.

On the CPU the wrapper takes its plain version and launches nothing; these
cases hold that route to the reference's ``adamw`` step for step, the
launch planner's cover of every tensor, the f32 constants to what PyTorch
makes of a Python scalar, the refusals before any launch, and the kernel's
layout constants in ``csrc/adamw.cu`` to the binding's. The kernel itself
is held to the plain version bit for bit on the card, in
``test_torch_adamw_cuda.py``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.train import optimizer as jax_optimizer
from repro_torch.kernels import adamw as ka
from repro_torch.models.convert import tree_leaves
from repro_torch.train import AdamWConfig, adamw

CU = (Path(ka.__file__).resolve().parent / "csrc" / "adamw.cu").read_text()
DTYPES = (torch.float32, torch.bfloat16)
# sizes around the vector widths (4 f32, 8 bf16) and a bf16 work unit (8192)
SIZES = (0, 1, 3, 7, 8, 9, 31, 1000, 8191, 8193)


def _state(sizes, dtype, seed):
    """p, g, m, v for tensors of ``sizes``: g spans 1e-30 to 1e4 in
    magnitude with zeros in places; m and v as after a few steps."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        g = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-30, 4, n)
        g[rng.random(n) < 0.1] = 0.0
        p = rng.standard_normal(n)
        m = rng.standard_normal(n) * 1e-2
        v = np.abs(rng.standard_normal(n)) * 1e-4
        out.append((torch.tensor(p, dtype=torch.float32).to(dtype),
                    torch.tensor(g, dtype=torch.float32).to(dtype),
                    torch.tensor(m, dtype=torch.float32), torch.tensor(v, dtype=torch.float32)))
    return [list(x) for x in zip(*out)] if out else [[], [], [], []]


def _bias(step, cfg):
    t = torch.tensor(step, dtype=torch.int32).float()
    return 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t


def _clone(lists):
    return [[t.clone() for t in ts] for ts in lists]


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_route_launches_nothing_and_is_the_plain_version(dtype):
    cfg = AdamWConfig(lr=1e-2)
    before = ka.adamw_update.launches
    got, want = _state(SIZES, dtype, 0), None
    want = _clone(got)
    for step in (1, 2, 3):
        bc1, bc2 = _bias(step, cfg)
        ka.adamw_update(*got, bc1, bc2, cfg)
        ka.adamw_update_plain(*want, bc1, bc2, cfg)
    assert ka.adamw_update.launches == before
    for a, b in zip(sum(got, []), sum(want, [])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_slices_change_no_value(dtype, monkeypatch):
    """The plain version's ``CHUNK`` slices bound its temporaries only."""
    cfg = AdamWConfig()
    whole = _state((1000, 8193, 5), dtype, 1)
    sliced = _clone(whole)
    bc1, bc2 = _bias(2, cfg)
    ka.adamw_update_plain(*whole, bc1, bc2, cfg)
    monkeypatch.setattr(ka, "CHUNK", 7)
    ka.adamw_update_plain(*sliced, bc1, bc2, cfg)
    for a, b in zip(sum(whole, []), sum(sliced, [])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_on_ragged_and_empty_tensors_matches_reference(dtype):
    """``adamw``'s update through the wrapper over tensors of ragged and zero
    size, steps 1-3 from the same state, against the reference's within 4
    f32 ulps of each leaf's largest magnitude (1 bf16 ulp for bf16 p), as
    ``test_optimizer_matches_reference_step_for_step`` holds it."""
    rng = np.random.default_rng(3)
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    np_params = {f"t{i:02d}": rng.standard_normal(n).astype(np.float32).astype(np_dt)
                 for i, n in enumerate(SIZES)}
    j_init, j_update = jax_optimizer.adamw(jax_optimizer.AdamWConfig(lr=1e-2))
    j_params = jax.tree.map(jnp.asarray, np_params)
    j_state = j_init(j_params)
    leaves = tree_leaves({k: torch.from_numpy(np.asarray(v, np.float32)).to(getattr(torch, dtype))
                          for k, v in np_params.items()})
    init, update = adamw(AdamWConfig(lr=1e-2))
    state = init(leaves)
    for step in range(3):
        np_grads = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32).astype(np_dt)
                    for k, v in np_params.items()}
        j_params, j_state = j_update(jax.tree.map(jnp.asarray, np_grads), j_state, j_params)
        grads = [[torch.from_numpy(np.asarray(np_grads[k], np.float32)).to(getattr(torch, dtype))]
                 for k in sorted(np_grads)]
        leaves, state = update(grads, state, leaves)
        for name, got in zip(sorted(np_params), leaves):
            for g, w, d in ((got.tensors[0], j_params[name], dtype),
                            (state.inner["m"][sorted(np_params).index(name)].tensors[0],
                             j_state.inner["m"][name], "float32"),
                            (state.inner["v"][sorted(np_params).index(name)].tensors[0],
                             j_state.inner["v"][name], "float32")):
                w = np.asarray(w, np.float32)
                g = g.float().numpy()
                assert g.shape == w.shape
                if not w.size:
                    continue
                scale = float(np.abs(w).max())
                ulp = 2.0 ** (np.floor(np.log2(scale)) - (7 if d == "bfloat16" else 23))
                assert np.abs(g - w).max() <= (1 if d == "bfloat16" else 4) * ulp, (step, name)


@st.composite
def _tensor_lists(draw):
    k = draw(st.integers(0, 40))
    sizes = [draw(st.integers(0, 3)) and draw(st.integers(1, 70000)) for _ in range(k)]
    dtypes = [DTYPES[draw(st.integers(0, 1))] for _ in range(k)]
    return list(zip(sizes, dtypes)), draw(st.integers(1, 9))


@settings(max_examples=60, deadline=None)
@given(_tensor_lists())
def test_planner_covers_every_element_once(case):
    tensors, max_tensors = case
    launches = ka.plan_launches(tensors, max_tensors)
    seen = [i for launch in launches for i in launch.index]
    # every non-empty tensor once, empty ones never
    assert sorted(seen) == [i for i, (n, _) in enumerate(tensors) if n]
    for launch in launches:
        assert 1 <= len(launch.index) <= max_tensors
        assert all(tensors[i][1] == launch.dtype for i in launch.index)
        assert launch.unit_start[0] == 0 and len(launch.unit_start) == len(launch.index) + 1
        unit = ka.UNIT[launch.dtype]
        for j, i in enumerate(launch.index):
            # the units of tensor i cover [0, n) exactly: the last one ragged
            units = launch.unit_start[j + 1] - launch.unit_start[j]
            n = tensors[i][0]
            assert (units - 1) * unit < n <= units * unit
    # one dtype's launches are full but the last
    for dtype in DTYPES:
        sizes = [len(l.index) for l in launches if l.dtype == dtype]
        assert all(s == max_tensors for s in sizes[:-1])
    assert ka.LIST_BYTES <= ka.PARAM_LIMIT


def test_planner_splits_past_the_limit_and_groups_by_dtype():
    tensors = [(5, torch.bfloat16)] * (2 * ka.MAX_TENSORS + 3) + [(9, torch.float32), (0, torch.float32)]
    launches = ka.plan_launches(tensors)
    assert [(l.dtype, len(l.index)) for l in launches] == [
        (torch.bfloat16, ka.MAX_TENSORS), (torch.bfloat16, ka.MAX_TENSORS),
        (torch.bfloat16, 3), (torch.float32, 1)]
    assert launches[-1].index == [2 * ka.MAX_TENSORS + 3]


def test_layout_constants_match_the_source():
    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name, CU).group(1))
    assert (const("NTHREADS"), const("ILP"), const("MAX_TENSORS")) == (
        ka.NTHREADS, ka.ILP, ka.MAX_TENSORS)
    size = int(re.search(r"static_assert\(sizeof\(TensorList\) == (\d+)", CU).group(1))
    assert size == ka.LIST_BYTES <= ka.PARAM_LIMIT
    assert ka.UNIT == {torch.float32: 256 * 4 * 4, torch.bfloat16: 256 * 4 * 8}


@pytest.mark.parametrize("cfg", [AdamWConfig(), AdamWConfig(lr=1e-3), AdamWConfig(lr=1e-2),
                                 AdamWConfig(lr=3e-3, b1=0.8, b2=0.999, eps=1e-6,
                                             weight_decay=0.0)])
def test_constants_are_what_torch_multiplies_by(cfg):
    """Each constant is the f32 that ``python_float * f32_tensor`` uses."""
    t = torch.tensor(np.random.default_rng(0).standard_normal(4096), dtype=torch.float32)
    values = (cfg.lr, cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps, cfg.weight_decay)
    for x, c in zip(values, ka.constants(cfg)):
        assert c == float(np.float32(x))
        assert (torch.ones((), dtype=torch.float32) * x).item() == c
        assert torch.equal(t * x, t * torch.tensor(c, dtype=torch.float32))
    assert ka.constants(AdamWConfig())[2] == float(np.float32(0.1))


def _bad_cases():
    def base():
        return _state((16, 5), torch.bfloat16, 2)

    def shape(l):
        l[1][1] = l[1][1][:4].clone()

    def g_dtype(l):
        l[1][0] = l[1][0].float()

    def m_dtype(l):
        l[2][1] = l[2][1].bfloat16()

    def p_dtype(l):
        l[0][0], l[1][0] = l[0][0].half(), l[1][0].half()

    def device(l):
        l[3][1] = l[3][1].to("meta")

    def strided(l):
        p, g, m, v = (ts[0] for ts in l)
        l[0][0], l[1][0], l[2][0], l[3][0] = (t.reshape(4, 4).T for t in (p, g, m, v))

    def length(l):
        l[3].pop()
    return {f.__name__: (base, f) for f in (shape, g_dtype, m_dtype, p_dtype, device, strided,
                                            length)}


@pytest.mark.parametrize("fault", sorted(_bad_cases()))
def test_mismatches_raise_before_any_update(fault):
    base, spoil = _bad_cases()[fault]
    lists = base()
    spoil(lists)
    kept = _clone([[t for t in ts if t.device.type == "cpu"] for ts in lists])
    cfg = AdamWConfig()
    bc1, bc2 = _bias(1, cfg)
    before = ka.adamw_update.launches
    with pytest.raises((TypeError, ValueError)):
        ka.adamw_update(*lists, bc1, bc2, cfg)
    assert ka.adamw_update.launches == before
    now = [[t for t in ts if t.device.type == "cpu"] for ts in lists]
    assert all(torch.equal(a, b) for a, b in zip(sum(now, []), sum(kept, [])))


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_bias_corrections_must_be_0_dim_f32_on_the_device(bad):
    lists = _state((16,), torch.float32, 4)
    bc1, bc2 = _bias(1, AdamWConfig())
    bc2 = {"shape": bc2.reshape(1), "dtype": bc2.double(), "device": bc2.to("meta")}[bad]
    with pytest.raises(ValueError):
        ka.adamw_update(*lists, bc1, bc2, AdamWConfig())


def test_meta_tensors_take_the_plain_version():
    """The dry run's train step updates meta tensors: the plain ops, which
    its op counter reads, and no launch."""
    lists = [[t.to("meta") for t in ts] for ts in _state((16, 9), torch.bfloat16, 5)]
    bc1, bc2 = (b.to("meta") for b in _bias(1, AdamWConfig()))
    before = ka.adamw_update.launches
    ka.adamw_update(*lists, bc1, bc2, AdamWConfig())
    assert ka.adamw_update.launches == before


def test_chip_smoke_counts_the_bytes_and_launches_of_an_update():
    """``chip_smoke.py``'s bound for B3 moves 22 bytes a bf16 value and 28 a
    f32 one, and its expected launches a step come from the planner: one
    for phi4-mini-3.8b (291 bf16 tensors), two for mamba2-1.3b (its f32
    SSM scalars beside the bf16 weights)."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import get_config
    tensors = [torch.empty(7, dtype=torch.bfloat16), torch.empty(5, dtype=torch.float32)]
    assert chip_smoke.adamw_bytes(tensors) == 7 * 22 + 5 * 28
    assert chip_smoke.adamw_per_step(get_config("phi4-mini-3.8b")) == 1
    assert chip_smoke.adamw_per_step(get_config("mamba2-1.3b")) == 2
