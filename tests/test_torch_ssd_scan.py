"""The port's SSD chunk scan on the CPU (its plain version) against the JAX
Pallas kernel in interpret mode, the JAX token recurrence and the JAX
model's ``ssd_chunked``. The CUDA kernel's own test is
``test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_bshp as jax_ssd_bshp
from repro.kernels import ssd_ref as jax_ssd_ref
from repro.kernels import ssd_scan as jax_ssd_scan
from repro.models import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ssd_bshp, ssd_ref, ssd_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import ssd_chunked

# (bh, s, p, n, chunk): the shapes of tests/test_kernels.py
SHAPES = [
    (2, 64, 32, 16, 16),
    (4, 128, 64, 32, 32),
    (2, 128, 64, 128, 64),
]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32 = dict(rtol=2e-4, atol=2e-4)


def _tol(name):
    return dict(rtol=3e-2, atol=3e-2) if name == "bfloat16" else F32


def _softplus(a):
    return np.log1p(np.exp(a)).astype(np.float32)


def _scan_inputs(bh, s, p, n, seed=0, groups=None):
    """x, dt, A, B, C as numpy f32; B and C have ``groups`` rows (default bh)."""
    rng = np.random.default_rng(seed)
    g = groups or bh
    x = rng.standard_normal((bh, s, p), dtype=np.float32)
    dt = _softplus(rng.standard_normal((bh, s)))
    A = -np.exp(rng.standard_normal(bh) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((g, s, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((g, s, n)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _model_inputs(b, s, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = _softplus(rng.standard_normal((b, s, h)))
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _torch(x, dt, A, Bm, Cm, dtype=torch.float32):
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(dt), torch.from_numpy(A),
            torch.from_numpy(Bm).to(dtype), torch.from_numpy(Cm).to(dtype))


def _jax(x, dt, A, Bm, Cm, dtype=jnp.float32):
    return (jnp.asarray(x).astype(dtype), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm).astype(dtype), jnp.asarray(Cm).astype(dtype))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bh,s,p,n,chunk", SHAPES)
def test_scan_matches_jax_kernel_and_recurrence(bh, s, p, n, chunk, dtype):
    tdt, jdt = DTYPES[dtype]
    arrs = _scan_inputs(bh, s, p, n)
    y, st = ssd_scan(*_torch(*arrs, dtype=tdt), chunk=chunk)
    jy, jst = jax_ssd_scan(*_jax(*arrs, dtype=jdt), chunk=chunk, interpret=True)
    ry, rst = jax_ssd_ref(*_jax(*arrs, dtype=jdt))
    assert y.dtype == tdt and y.shape == (bh, s, p)
    assert st.dtype == torch.float32 and st.shape == (bh, n, p)
    for want_y, want_st in ((jy, jst), (ry, rst)):
        np.testing.assert_allclose(_np(y), _np(want_y), **_tol(dtype))
        np.testing.assert_allclose(_np(st), _np(want_st), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_ref_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    arrs = _scan_inputs(3, 40, 16, 8, seed=1)
    y, st = ssd_ref(*_torch(*arrs, dtype=tdt))
    jy, jst = jax_ssd_ref(*_jax(*arrs, dtype=jdt))
    assert y.dtype == tdt
    np.testing.assert_allclose(_np(y), _np(jy), **_tol(dtype))
    np.testing.assert_allclose(_np(st), _np(jst), **F32)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 4, 16, 1, 16, 16),
    (2, 64, 4, 16, 2, 16, 16),           # heads_per_group 2
    (1, 48, 6, 8, 3, 12, 24),
])
def test_bshp_matches_jax_wrapper_and_model_scan(b, s, h, p, g, n, chunk):
    arrs = _model_inputs(b, s, h, p, g, n)
    y, st = ssd_bshp(*_torch(*arrs), chunk=chunk)
    jy, jst = jax_ssd_bshp(*_jax(*arrs), chunk=chunk)
    my, mst = jax_ssd_chunked(*_jax(*arrs), chunk=chunk)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    for want_y, want_st in ((jy, jst), (my, mst)):
        np.testing.assert_allclose(_np(y), _np(want_y), **F32)
        np.testing.assert_allclose(_np(st), _np(want_st), **F32)


def test_model_ssd_chunked_matches_jax():
    arrs = _model_inputs(2, 64, 4, 16, 2, 16, seed=2)
    y, st = ssd_chunked(*_torch(*arrs), chunk=16)
    jy, jst = jax_ssd_chunked(*_jax(*arrs), chunk=16)
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(st), _np(jst), **F32)


def test_initial_state_matches_jax_chunked():
    b, s, h, p, g, n = 2, 32, 4, 8, 2, 16
    arrs = _model_inputs(b, s, h, p, g, n, seed=3)
    init = np.random.default_rng(4).standard_normal((b, h, p, n)).astype(np.float32)
    y, st = ssd_bshp(*_torch(*arrs), chunk=16, initial_state=torch.from_numpy(init))
    jy, jst = jax_ssd_chunked(*_jax(*arrs), chunk=16, initial_state=jnp.asarray(init))
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(st), _np(jst), **F32)


def test_initial_state_continues_the_scan():
    """Scanning two halves, the second from the first's state, is one scan."""
    x, dt, A, Bm, Cm = _torch(*_scan_inputs(3, 64, 16, 16, seed=5))
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    y1, st1 = ssd_scan(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], chunk=16)
    y2, st2 = ssd_scan(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], chunk=16,
                       initial_state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), **F32)
    np.testing.assert_allclose(st2.numpy(), st.numpy(), **F32)


@pytest.mark.parametrize("s", [16, 100])
def test_chunk_equal_to_seq(s):
    arrs = _scan_inputs(2, s, 16, 16, seed=6)
    y, st = ssd_scan(*_torch(*arrs), chunk=s)
    jy, jst = jax_ssd_scan(*_jax(*arrs), chunk=s, interpret=True)
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(st), _np(jst), **F32)


def test_seq_not_a_multiple_of_chunk_raises_in_both():
    arrs = _scan_inputs(2, 48, 8, 8)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(*_torch(*arrs), chunk=32)
    with pytest.raises(AssertionError):
        jax_ssd_scan(*_jax(*arrs), chunk=32, interpret=True)
    with pytest.raises(ValueError, match="chunk"):
        ssd_chunked(*_torch(*_model_inputs(1, 48, 2, 4, 1, 4)), chunk=32)


def test_heads_per_group_reads_group_rows():
    """B/C given per group equal B/C broadcast to every head."""
    x, dt, A, Bm, Cm = _torch(*_scan_inputs(8, 32, 16, 16, seed=7, groups=2))
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=16, heads_per_group=4)
    Bh, Ch = (torch.repeat_interleave(t, 4, dim=0) for t in (Bm, Cm))
    y1, st1 = ssd_scan(x, dt, A, Bh, Ch, chunk=16)
    np.testing.assert_array_equal(y.numpy(), y1.numpy())
    np.testing.assert_array_equal(st.numpy(), st1.numpy())


def test_bad_arguments_raise():
    x, dt, A, Bm, Cm = _torch(*_scan_inputs(4, 32, 8, 8))
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), A, Bm, Cm, chunk=16)
    with pytest.raises(TypeError):
        ssd_scan(x, dt, A, Bm.bfloat16(), Cm, chunk=16)
    with pytest.raises(ValueError, match="heads_per_group"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=16, heads_per_group=3)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=16, initial_state=torch.zeros(4, 8, 9))


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    arrs = _torch(*_scan_inputs(2, 32, 8, 8))
    before = ssd_scan.launches
    y, st = ssd_scan(*arrs, chunk=16)
    py, pst = ssd_scan_plain(*arrs, chunk=16)
    assert ssd_scan.launches == before
    np.testing.assert_array_equal(y.numpy(), py.numpy())
    np.testing.assert_array_equal(st.numpy(), pst.numpy())


def test_masked_half_never_makes_nan():
    """Large |dt·A| overflows exp(cum_i - cum_j) above the diagonal; the
    plain version selects 0 there instead of multiplying a mask."""
    x, dt, A, Bm, Cm = _torch(*_scan_inputs(2, 128, 8, 8, seed=8))
    A = torch.full_like(A, -16.0)
    y, st = ssd_scan(x, dt * 50, A, Bm, Cm, chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
