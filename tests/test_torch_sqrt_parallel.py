"""Port parity: the square-root (Cholesky-factor) parallel smoother.

Factors are unique only up to orthogonal right-multiplication, and
``torch.linalg.qr`` and XLA's QR may pick other signs for R's diagonal,
so factors are compared through their products (``T Tᵀ``, ``U Uᵀ``,
``Z Zᵀ``, ``D Dᵀ``), the rest directly. Inputs are seeded numpy arrays
fed to both packages. Tolerances: the suite's f64 TOL against the JAX
square-root form; rtol=1e-7, atol=1e-8 against the covariance form (the
JAX suite's bound for that comparison). The `cuda` test holds the
square-root path on the card against the standard-form kernel path and
skips here; JAX is imported lazily so it also runs where JAX is absent.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import api as tapi
from repro_torch.core import sqrt_parallel as tsq
from repro_torch.core.types import LinearizedSSM as TLin
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-10)
FORM_TOL = dict(rtol=1e-7, atol=1e-8)


def _close(got, want, tol):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), **tol)


def _prod(F):
    return F @ np.swapaxes(F, -1, -2)


@functools.lru_cache(maxsize=None)
def jax_env():
    import jax
    import jax.numpy as jnp

    from repro.core import parallel as jpar
    from repro.core import sqrt_parallel as jsq
    from repro.core.types import LinearizedSSM

    return jax, jnp, jsq, jpar, LinearizedSSM


def random_ssm(seed, B, n, nx, ny):
    """A batched random linear SSM ``[B, n]`` (numpy, f64) with shared
    prior, as the JAX suite's ``random_linear_ssm`` builds one."""
    rng = np.random.default_rng(seed)

    def psd(*shape):
        a = rng.standard_normal(shape)
        return 0.5 * a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(shape[-1])

    F = 0.6 * rng.standard_normal((B, n, nx, nx)) / np.sqrt(nx) \
        + 0.3 * np.eye(nx)
    lin = (F, rng.standard_normal((B, n, nx)), psd(B, n, nx, nx),
           rng.standard_normal((B, n, ny, nx)) / np.sqrt(nx),
           rng.standard_normal((B, n, ny)), psd(B, n, ny, ny))
    ys = rng.standard_normal((B, n, ny))
    return lin, ys, np.zeros(nx), np.eye(nx)


def as_torch(lin, ys, m0, P0, dtype=torch.float64, device="cpu"):
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                               device=device)
    return TLin(*(t(x) for x in lin)), t(ys), t(m0), t(P0)


def as_jax(lin, ys, m0, P0, dtype=np.float64):
    _, jnp, _, _, JLin = jax_env()
    j = lambda a: jnp.asarray(np.asarray(a, dtype))  # noqa: E731
    return JLin(*(j(x) for x in lin)), j(ys), j(m0), j(P0)


@pytest.mark.parametrize("shape", [(4, 9), (5, 2), (3, 3, 6)])
def test_tria_matches_jax_by_product(shape):
    jax, jnp, jsq, _, _ = jax_env()
    M = np.random.default_rng(len(shape)).standard_normal(shape)
    T = tsq.tria(torch.tensor(M))
    want = np.asarray(jax.jit(jsq.tria)(jnp.asarray(M)))
    k = min(shape[-2:])
    assert T.shape == shape[:-1] + (k,)
    assert np.allclose(np.triu(T.numpy(), 1), 0.0)
    _close(T @ T.mT, _prod(want), TOL)
    _close(T @ T.mT, M @ np.swapaxes(M, -1, -2), TOL)


def _canon_filtering(e):
    A, b, U, eta, Z = (np.asarray(x) for x in e)
    return A, b, _prod(U), eta, _prod(Z)


@pytest.mark.parametrize("nx,ny", [(4, 2), (3, 3), (2, 5)])
def test_sqrt_filtering_elements_match_jax(nx, ny):
    """ny < nx pads Z with zeros, ny > nx (the LM-augmented case)
    re-triangularizes it; row 0 is the k=1 predict-update element."""
    jax, _, jsq, _, _ = jax_env()
    args = random_ssm(nx + 10 * ny, 2, 7, nx, ny)
    got = tsq.sqrt_filtering_elements_batched(*as_torch(*args))
    want = jax.jit(jsq.sqrt_filtering_elements_batched)(*as_jax(*args))
    for g, w in zip(_canon_filtering(got), _canon_filtering(want)):
        np.testing.assert_allclose(g, w, **TOL)


def _low(rng, B, nx):
    return np.tril(rng.standard_normal((B, nx, nx))) / nx + 0.3 * np.eye(nx)


def rand_filtering(rng, B, nx):
    return (rng.standard_normal((B, nx, nx)) / np.sqrt(nx),
            rng.standard_normal((B, nx)), _low(rng, B, nx),
            rng.standard_normal((B, nx)), _low(rng, B, nx))


def rand_smoothing(rng, B, nx):
    return (rng.standard_normal((B, nx, nx)) / np.sqrt(nx),
            rng.standard_normal((B, nx)), _low(rng, B, nx))


@pytest.mark.parametrize("nx", [1, 3, 5])
def test_sqrt_combines_match_jax_by_products(nx):
    jax, jnp, jsq, _, _ = jax_env()
    rng = np.random.default_rng(nx)
    fi, fj = rand_filtering(rng, 6, nx), rand_filtering(rng, 6, nx)
    jf = lambda f: jsq.SqrtFilteringElement(*map(jnp.asarray, f))  # noqa
    tf = lambda f: tsq.SqrtFilteringElement(*map(torch.tensor, f))  # noqa
    want = jax.jit(jax.vmap(jsq.sqrt_filtering_combine))(jf(fi), jf(fj))
    got = tsq.sqrt_filtering_combine(tf(fi), tf(fj))
    for g, w in zip(_canon_filtering(got), _canon_filtering(want)):
        np.testing.assert_allclose(g, w, **TOL)

    si, sj = rand_smoothing(rng, 6, nx), rand_smoothing(rng, 6, nx)
    js = lambda f: jsq.SqrtSmoothingElement(*map(jnp.asarray, f))  # noqa
    ts = lambda f: tsq.SqrtSmoothingElement(*map(torch.tensor, f))  # noqa
    want = jax.jit(jax.vmap(jsq.sqrt_smoothing_combine))(js(si), js(sj))
    got = tsq.sqrt_smoothing_combine(ts(si), ts(sj))
    _close(got.E, want.E, TOL)
    _close(got.g, want.g, TOL)
    _close(got.D @ got.D.mT, _prod(np.asarray(want.D)), TOL)


def test_sqrt_identities_are_neutral():
    rng = np.random.default_rng(4)
    a = tsq.SqrtFilteringElement(*(torch.tensor(x[0]) for x in
                                   rand_filtering(rng, 1, 3)))
    e = tsq.sqrt_filtering_identity(3, torch.float64)
    for got in (tsq.sqrt_filtering_combine(e, a),
                tsq.sqrt_filtering_combine(a, e)):
        for g, w in zip(_canon_filtering(got), _canon_filtering(a)):
            np.testing.assert_allclose(g, w, **TOL)
    s = tsq.SqrtSmoothingElement(*(torch.tensor(x[0]) for x in
                                   rand_smoothing(rng, 1, 3)))
    es = tsq.sqrt_smoothing_identity(3, torch.float64)
    for got in (tsq.sqrt_smoothing_combine(es, s),
                tsq.sqrt_smoothing_combine(s, es)):
        _close(got.E, s.E.numpy(), TOL)
        _close(got.g, s.g.numpy(), TOL)
        _close(got.D @ got.D.mT, (s.D @ s.D.mT).numpy(), TOL)


@pytest.mark.parametrize("B,n,nx,ny", [(2, 1, 2, 1), (3, 33, 4, 2),
                                       (2, 64, 5, 7)])
def test_batched_sqrt_filter_smoother_matches_jax(B, n, nx, ny):
    """Against the JAX square-root form (TOL) and the JAX covariance form
    (FORM_TOL); ny = 7 > nx is the LM-augmented shape."""
    jax, _, jsq, jpar, _ = jax_env()
    args = random_ssm(n, B, n, nx, ny)
    filt, smth = tsq._sqrt_parallel_filter_smoother_batched(*as_torch(*args))
    jf, js = jax.jit(jsq._sqrt_parallel_filter_smoother_batched)(
        *as_jax(*args))
    sf, ss = jax.jit(jpar._parallel_filter_smoother_batched)(*as_jax(*args))
    assert filt.mean.shape == (B, n, nx) and smth.mean.shape == (B, n + 1, nx)
    for got, sq, std in ((filt, jf, sf), (smth, js, ss)):
        _close(got.mean, sq.mean, TOL)
        _close(got.cov, sq.cov, TOL)
        _close(got.mean, std.mean, FORM_TOL)
        _close(got.cov, std.cov, FORM_TOL)


def test_smoother_api_dispatches_sqrt_form():
    args = as_torch(*random_ssm(9, 2, 17, 3, 2))
    smoother = tapi.build_smoother(form="sqrt", device="cpu")
    filt = smoother.filter(*args)
    want_f, want_s = tsq._sqrt_parallel_filter_smoother_batched(*args)
    assert torch.equal(filt.mean, want_f.mean)
    _, smth = smoother.smooth(*args)
    assert torch.equal(smth.cov, want_s.cov)
    lin, ys, m0, P0 = args
    one = smoother.smooth(type(lin)(*(x[1] for x in lin)), ys[1], m0, P0)[1]
    _close(one.mean, want_s.mean[1].numpy(), TOL)
    with pytest.raises(ValueError, match="sqrt"):
        tapi.build_smoother(form="sqrt", mode="sequential", device="cpu")


def test_float32_sqrt_filter_stays_finite_where_jax_does():
    """The JAX suite's f32 stability case (n=512, nx=5, ny=2): the
    square-root form stays PSD and within 1e-2 of the f64 truth on the
    filtered covariance diagonal, finite exactly where JAX's is."""
    jax, _, jsq, jpar, _ = jax_env()
    args = random_ssm(11, 1, 512, 5, 2)
    truth = jax.jit(jpar.parallel_filter_batched)(*as_jax(*args))
    j32 = jax.jit(jsq.sqrt_parallel_filter_batched)(
        *as_jax(*args, dtype=np.float32))
    t32 = tsq.sqrt_parallel_filter_batched(*as_torch(*args,
                                                     dtype=torch.float32))
    assert t32.cov.dtype == torch.float32
    np.testing.assert_array_equal(np.isfinite(t32.cov.numpy()),
                                  np.isfinite(np.asarray(j32.cov)))
    assert np.isfinite(t32.cov.numpy()).all()
    diag = np.diagonal(t32.cov.numpy(), axis1=-2, axis2=-1)
    true = np.diagonal(np.asarray(truth.cov), axis1=-2, axis2=-1)
    assert diag.min() >= 0.0
    assert np.max(np.abs(diag - true) / (true + 1e-9)) < 1e-2


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sqrt_form_on_card_matches_standard_kernel_path(cuda):
    """One linearized pass on the card, 16 lanes x n=512 (LM-augmented
    ny=7 > nx=5), f64: the square-root form (no kernel) against the
    standard form through the combine kernels."""
    from repro_torch.kernels.kalman_combine import kalman_combine as kc

    args = as_torch(*random_ssm(5, 16, 512, 5, 7), device=cuda)
    kc.reset_launch_counts()
    _, sq = tapi.build_smoother(form="sqrt", device=cuda).smooth(*args)
    torch.cuda.synchronize()
    assert not any(kc.LAUNCHES.values())
    _, std = tapi.build_smoother(device=cuda).smooth(*args)
    assert kc.LAUNCHES["filtering_combine"] > 0
    _close(sq.mean, std.mean.cpu().numpy(), FORM_TOL)
    _close(sq.cov, std.cov.cpu().numpy(), FORM_TOL)


@pytest.mark.cuda
def test_float32_sqrt_filter_on_card_stays_psd(cuda):
    """The f32 stability case of the CPU test, on the card: PSD filtered
    covariances within 1e-2 of the f64 truth on the diagonal."""
    raw = random_ssm(11, 1, 512, 5, 2)
    truth = tsq.sqrt_parallel_filter_batched(*as_torch(*raw, device=cuda))
    got = tsq.sqrt_parallel_filter_batched(
        *as_torch(*raw, dtype=torch.float32, device=cuda))
    diag = torch.diagonal(got.cov, dim1=-2, dim2=-1).double()
    true = torch.diagonal(truth.cov, dim1=-2, dim2=-1)
    assert bool(torch.isfinite(got.cov).all()) and float(diag.min()) >= 0.0
    assert float(((diag - true).abs() / (true + 1e-9)).max()) < 1e-2
