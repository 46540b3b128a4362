"""Port parity: the sigma-point schemes of statistical linear regression.

The three schemes' unit points and weights (built in numpy by both
packages) must be equal, and `SigmaScheme.points` — batched over leading
axes in the port, one Gaussian at a time in the JAX package — must give
the JAX points at the suite's f64 TOL, with NaN where the covariance is
not positive definite (no raise), and jitter handled the same way.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import sigma_points as tsp
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-10)
SCHEMES = ("cubature", "unscented", "gauss_hermite")


@functools.lru_cache(maxsize=None)
def jax_points():
    import jax

    from repro.core import sigma_points as jsp

    def points(name, nx, jitter):
        scheme = jsp.get_scheme(name, nx)
        return jax.jit(jax.vmap(lambda m, P: scheme.points(m, P, jitter)))
    return jsp, points


def random_gaussians(rng, B, nx):
    m = rng.standard_normal((B, nx))
    a = rng.standard_normal((B, nx, nx))
    P = a @ np.swapaxes(a, -1, -2) / nx + 0.1 * np.eye(nx)
    return m, P


@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("nx", [1, 2, 3, 4, 5])
def test_scheme_points_and_weights_equal_jax(name, nx):
    jsp, _ = jax_points()
    want = jsp.get_scheme(name, nx)
    got = tsp.get_scheme(name, nx)
    assert got.num_points == want.num_points
    for field in ("xi", "wm", "wc"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    np.testing.assert_allclose(got.wm.sum(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("nx", [1, 3, 5])
def test_batched_points_match_jax(name, nx):
    _, points = jax_points()
    m, P = random_gaussians(np.random.default_rng(nx), 6, nx)
    want_pts, want_wm, want_wc = points(name, nx, 0.0)(m, P)
    scheme = tsp.get_scheme(name, nx)
    pts, wm, wc = scheme.points(torch.tensor(m).reshape(2, 3, nx),
                                torch.tensor(P).reshape(2, 3, nx, nx))
    assert pts.shape == (2, 3, scheme.num_points, nx)
    assert wm.dtype == torch.float64 and wm.shape == (scheme.num_points,)
    np.testing.assert_allclose(pts.reshape(6, -1, nx).numpy(),
                               np.asarray(want_pts), **TOL)
    np.testing.assert_allclose(wm.numpy(), np.asarray(want_wm[0]), **TOL)
    np.testing.assert_allclose(wc.numpy(), np.asarray(want_wc[0]), **TOL)
    # Weighted points reproduce the mean (every scheme is exact for it).
    mean = torch.einsum("s,...sx->...x", wm, pts)
    np.testing.assert_allclose(mean.reshape(6, nx).numpy(), m, **TOL)


def test_jitter_and_single_gaussian_match_jax():
    _, points = jax_points()
    m, P = random_gaussians(np.random.default_rng(7), 1, 4)
    want = points("cubature", 4, 1e-3)(m, P)[0]
    got = tsp.cubature(4).points(torch.tensor(m[0]), torch.tensor(P[0]),
                                 1e-3)[0]
    assert got.shape == (8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), **TOL)


def test_not_positive_definite_gives_nan_like_jax():
    """Jitter 0 on a singular covariance: NaN points, silently, in both
    packages (no jitter is added that the spec did not ask for)."""
    _, points = jax_points()
    m = np.zeros((2, 2))
    P = np.stack([np.eye(2), -np.eye(2)])
    want = np.asarray(points("cubature", 2, 0.0)(m, P)[0])
    got = tsp.cubature(2).points(torch.tensor(m), torch.tensor(P))[0]
    assert np.isfinite(want[0]).all() and np.isnan(want[1]).all()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="unknown sigma-point scheme"):
        tsp.get_scheme("bogus", 2)
