"""Port parity: repro_torch.core.types vs repro.core.types.

Inputs are numpy arrays from a seed; both packages compute on them and
must agree within the kernel suite's TOL (f64 rtol=1e-9, atol=1e-10; f32
rtol=2e-4, atol=2e-5 — rounding order differs between the frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jt
from repro_torch.core import types as tt
from _torch_jax import release_jax_caches  # noqa: F401

TOL = {np.float32: dict(rtol=2e-4, atol=2e-5),
       np.float64: dict(rtol=1e-9, atol=1e-10)}
TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}
DTYPES = [np.float32, np.float64]


def _spd(rng, shape, nx):
    a = rng.standard_normal(shape + (nx, nx))
    return a @ np.swapaxes(a, -1, -2) / nx + 0.5 * np.eye(nx)


def _both(x, dtype):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(t, j, dtype):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx", [1, 3, 5, 8, 16])
def test_gauss_jordan_inverse(nx, dtype):
    rng = np.random.default_rng(nx)
    W = _spd(rng, (7,), nx) + np.einsum(
        "bij,bjk->bik", _spd(rng, (7,), nx), _spd(rng, (7,), nx))
    Wj, Wt = _both(W, dtype)
    _close(tt.gauss_jordan_inverse(Wt), jt.gauss_jordan_inverse(Wj), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bmm_bmv_symmetrize(dtype):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((4, 3, 5, 2))
    B = rng.standard_normal((4, 3, 2, 6))
    x = rng.standard_normal((4, 3, 2))
    M = rng.standard_normal((4, 5, 5))
    (Aj, At), (Bj, Bt), (xj, xt), (Mj, Mt) = (
        _both(a, dtype) for a in (A, B, x, M))
    _close(tt.bmm(At, Bt), jt.bmm(Aj, Bj), dtype)
    _close(tt.bmv(At, xt), jt.bmv(Aj, xj), dtype)
    _close(tt.symmetrize(Mt), jt.symmetrize(Mj), dtype)
    assert tt.bmm(At, Bt).dtype == TORCH_DTYPE[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_mvn_logpdf(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 9, 3))
    m = rng.standard_normal((6, 9, 3))
    S = _spd(rng, (6, 9), 3)
    (xj, xt), (mj, mt), (Sj, St) = (_both(a, dtype) for a in (x, m, S))
    _close(tt.mvn_logpdf(xt, mt, St), jt.mvn_logpdf(xj, mj, Sj), dtype)


def test_mvn_logpdf_not_positive_definite_is_nan():
    """Like jnp.linalg.cholesky, a non-PD covariance gives NaN (no raise,
    no device synchronization)."""
    cov = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]], dtype=torch.float64)
    out = tt.mvn_logpdf(torch.zeros(1, 2, dtype=torch.float64),
                        torch.zeros(1, 2, dtype=torch.float64), cov)
    assert torch.isnan(out).all()
    want = jt.mvn_logpdf(jnp.zeros((1, 2)), jnp.zeros((1, 2)),
                         jnp.asarray(cov.numpy()))
    assert np.isnan(np.asarray(want)).all()


def test_broadcast_helpers():
    Q = np.eye(3) * 0.2
    Qt = torch.from_numpy(Q)
    np.testing.assert_array_equal(tt.broadcast_noise(Qt, 4).numpy(),
                                  np.asarray(jt.broadcast_noise(Q, 4)))
    m0 = np.arange(3.0)
    np.testing.assert_array_equal(
        tt.bcast_prior(torch.from_numpy(m0), 5, 1).numpy(),
        np.asarray(jt.bcast_prior(m0, 5, 1)))
    with pytest.raises(ValueError):
        tt.broadcast_noise(torch.zeros(3, 2, 2), 4)
