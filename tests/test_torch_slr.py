"""Port parity: sigma-point SLR (IPLS) — linearization, GN cost,
log-likelihood and the whole iterated smoother.

Inputs are made by the JAX package (its simulator, numpy across) and fed
to both packages on the CPU. Tolerances: the suite's f64 TOL for
single-level algebra (linearization, cost, per-step log-likelihood);
rtol=1e-7, atol=1e-8 for whole iterated paths, where rounding differences
compound over Gauss-Newton passes. The `cuda` tests hold the SLR path on
the card against its plain run and skip here; JAX is imported lazily so
they also run where JAX is absent.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import api as tapi
from repro_torch.core import cost as tcost
from repro_torch.core import linearization as tlin
from repro_torch.core.sigma_points import get_scheme
from repro_torch.core.types import Gaussian as TG
from repro_torch.kernels.kalman_combine import kalman_combine as kc
from repro_torch.scenarios import get_scenario as t_scenario
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-10)
PATH_TOL = dict(rtol=1e-7, atol=1e-8)
SCHEMES = ("cubature", "unscented", "gauss_hermite")


def _close(got, want, tol):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), **tol)


@functools.lru_cache(maxsize=None)
def jax_env():
    import jax
    import jax.numpy as jnp

    import repro.core as jcore
    from repro.core import linearization as jlin
    from repro.core.sigma_points import get_scheme as jscheme
    from repro.scenarios import get_scenario

    return jax, jnp, jcore, jlin, jscheme, get_scenario


@functools.lru_cache(maxsize=None)
def jax_model():
    _, jnp, *_, get_scenario = jax_env()
    return get_scenario("coordinated_turn").make_model(jnp.float64)


def torch_model(device="cpu"):
    return t_scenario("coordinated_turn").make_model(torch.float64, device)


@functools.lru_cache(maxsize=None)
def fleet(B=3, n=24):
    """JAX-simulated states and measurements ``[B, n+1, 5]``, ``[B, n, 2]``
    and a smoothed-looking Gaussian around the states."""
    jax, _, _, _, _, get_scenario = jax_env()
    sc = get_scenario("coordinated_turn")
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    model = jax_model()    # built outside the trace: it is cached
    xs, ys = jax.jit(jax.vmap(lambda k: sc.simulate(model, n, k)))(keys)
    rng = np.random.default_rng(5)
    means = np.asarray(xs) + 0.05 * rng.standard_normal(xs.shape)
    a = 0.1 * rng.standard_normal(xs.shape + (5,))
    covs = a @ np.swapaxes(a, -1, -2) + 1e-3 * np.eye(5)
    return means, covs, np.asarray(ys)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("which", ["f", "h"])
def test_linearize_slr_matches_jax(which, scheme):
    jax, jnp, _, jlin, jscheme, _ = jax_env()
    means, covs, _ = fleet()
    m, P = means[0, :4], covs[0, :4]
    jm = jax_model()
    jphi = getattr(jm, which)
    want = jax.jit(jax.vmap(lambda a, b: jlin.linearize_slr(
        jphi, a, b, jscheme(scheme, 5))))(jnp.asarray(m), jnp.asarray(P))
    got = tlin.linearize_slr(getattr(torch_model(), which), torch.tensor(m),
                             torch.tensor(P), get_scheme(scheme, 5))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, TOL)


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_model_slr_batched_with_per_row_noise_matches_jax(jitter):
    """Serving's per-lane, per-step R stack ``[B, n, ny, ny]``: the SLR
    residual covariances are added row by row."""
    jax, jnp, _, jlin, jscheme, _ = jax_env()
    means, covs, _ = fleet()
    B, np1 = means.shape[:2]
    R = np.broadcast_to(np.asarray(jax_model().R), (B, np1 - 1, 2, 2)).copy()
    R[:, -5:] *= 1e8                           # padded steps
    jm = dataclasses.replace(jax_model(), R=jnp.asarray(R))
    want = jax.jit(lambda m, P: jlin.linearize_model_slr_batched(
        jm, jcore_gaussian(m, P), jscheme("cubature", 5), jitter))(
            jnp.asarray(means), jnp.asarray(covs))
    tm = dataclasses.replace(torch_model(), R=torch.tensor(R))
    got = tlin.linearize_model_slr_batched(
        tm, TG(torch.tensor(means), torch.tensor(covs)),
        get_scheme("cubature", 5), jitter)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert g.shape[:2] == (B, np1 - 1)
        _close(g, w, TOL)


def jcore_gaussian(m, P):
    return jax_env()[2].Gaussian(mean=m, cov=P)


@pytest.mark.parametrize("scheme", [None, "unscented", "scheme object"])
def test_gn_cost_slr_matches_jax(scheme):
    """The cost at a smoothed trajectory (the JAX SLR iterate's), where a
    GN loop evaluates it."""
    _, jnp, jcore, _, jscheme, _ = jax_env()
    traj, _, _ = jax_iterate("spec")
    _, _, ys = fleet()
    jarg = jscheme("gauss_hermite", 5) if scheme == "scheme object" \
        else scheme
    targ = get_scheme("gauss_hermite", 5) if scheme == "scheme object" \
        else scheme
    want = jcore.gn_cost(jax_model(), jnp.asarray(ys), traj, "slr", jarg)
    got = tcost.gn_cost(torch_model(), torch.tensor(ys),
                        TG(*(torch.tensor(np.asarray(x)) for x in traj)),
                        "slr", targ)
    assert got.shape == (3,)
    _close(got, want, TOL)


def test_gn_cost_rejects_unknown_method():
    means, covs, ys = fleet()
    with pytest.raises(ValueError, match="unknown method"):
        tcost.gn_cost(torch_model(), torch.tensor(ys),
                      TG(torch.tensor(means), torch.tensor(covs)), "ukf")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_slr_log_likelihood_per_step_matches_jax(scheme):
    _, jnp, jcore, *_ = jax_env()
    means, covs, ys = fleet()
    spec = dict(linearization="slr", sigma_scheme=scheme)
    want = jcore.build_smoother(**spec).log_likelihood(
        jax_model(), jnp.asarray(ys),
        jcore_gaussian(jnp.asarray(means), jnp.asarray(covs)), per_step=True)
    got = tapi.build_smoother(**spec, device="cpu").log_likelihood(
        torch_model(), torch.tensor(ys),
        TG(torch.tensor(means), torch.tensor(covs)), per_step=True)
    assert got.shape == (3, 24)
    _close(got, want, TOL)


ITER_CASES = {
    "spec": dict(linearization="slr", n_iter=3, lm_lambda=1.0, tol=1e-6),
    "unscented_early_stop": dict(linearization="slr",
                                 sigma_scheme="unscented", n_iter=10,
                                 tol=1e-4),
    "sequential": dict(linearization="slr", n_iter=3, lm_lambda=1.0,
                       mode="sequential"),
}


@functools.lru_cache(maxsize=None)
def jax_iterate(case):
    _, jnp, jcore, *_ = jax_env()
    _, _, ys = fleet()
    smoother = jcore.build_smoother(jcore.SmootherSpec(**ITER_CASES[case]))
    return smoother.iterate(jax_model(), jnp.asarray(ys), return_info=True,
                            return_history=True)


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_slr_iterate_matches_jax(case):
    want, want_hist, want_info = jax_iterate(case)
    _, _, ys = fleet()
    smoother = tapi.build_smoother(**ITER_CASES[case], device="cpu")
    got, hist, info = smoother.iterate(torch_model(), torch.tensor(ys),
                                       return_history=True, return_info=True)
    _close(got.mean, want.mean, PATH_TOL)
    _close(got.cov, want.cov, PATH_TOL)
    assert hist.shape == want_hist.shape
    _close(hist, want_hist, PATH_TOL)
    np.testing.assert_array_equal(info.iterations.numpy(),
                                  np.asarray(want_info.iterations))
    np.testing.assert_array_equal(info.code.numpy(),
                                  np.asarray(want_info.code))
    _close(info.final_cost, want_info.final_cost, PATH_TOL)


def test_slr_early_stop_freezes_lanes():
    """The unscented case stops its lanes at different passes, so the
    per-lane freeze and the history's repeated rows are exercised."""
    _, hist, info = jax_iterate("unscented_early_stop")
    its = np.asarray(info.iterations)
    assert its.max() < 10 and len(set(its.tolist())) >= 2
    assert (np.asarray(info.code) == 0).all()      # LANE_CONVERGED
    np.testing.assert_array_equal(np.asarray(hist[-1]),
                                  np.asarray(hist[its.max() - 1]))


def test_single_trajectory_history_and_info():
    _, _, ys = fleet()
    smoother = tapi.build_smoother(**ITER_CASES["spec"], device="cpu")
    batched, bhist = smoother.iterate(torch_model(), torch.tensor(ys),
                                      return_history=True)
    single, hist, info = smoother.iterate(
        torch_model(), torch.tensor(ys[2]), return_history=True,
        return_info=True)
    assert single.mean.shape == (25, 5) and hist.shape == (3, 25, 5)
    assert info.code.shape == ()
    _close(single.mean, batched.mean[2].numpy(), PATH_TOL)
    _close(hist, bhist[:, 2].numpy(), PATH_TOL)


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["cubature", "unscented"])
def test_slr_iterate_through_kernels_matches_plain_on_card(cuda, scheme):
    """IPLS on the card through both combine kernels against the same
    run with the plain combines (``backend="jnp"``), 16 lanes x n=256."""
    sc = t_scenario("coordinated_turn")
    model = sc.make_model(torch.float64, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    from repro_torch.scenarios import simulate_trajectory
    _, ys = simulate_trajectory(model, 256, gen, batch=(16,))
    spec = sc.default_spec(linearization="slr", sigma_scheme=scheme,
                           n_iter=10, tol=1e-6)
    kc.reset_launch_counts()
    got, info = tapi.build_smoother(spec, device=cuda).iterate(
        model, ys, return_info=True)
    torch.cuda.synchronize()
    launches = dict(kc.LAUNCHES)
    assert launches["filtering_combine"] > 0
    assert launches["filtering_combine"] == launches["smoothing_combine"]
    want, winfo = tapi.build_smoother(spec, backend="jnp", device=cuda
                                      ).iterate(model, ys, return_info=True)
    assert kc.LAUNCHES == launches
    _close(got.mean, want.mean.cpu().numpy(), PATH_TOL)
    _close(got.cov, want.cov.cpu().numpy(), PATH_TOL)
    assert torch.equal(info.code, winfo.code)
    assert torch.equal(info.iterations, winfo.iterations)
