"""Port parity: per-lane adaptive Levenberg-Marquardt damping.

Four coordinated-turn lanes simulated by the JAX package (numpy across),
two of them seeded to exercise the per-lane verdicts: lane 1 carries a
NaN observation (NaN initial cost: diverged up front, zero passes, the
initial trajectory returned), lane 2 a burst of 3-radian outliers that
makes weakly damped Gauss-Newton steps raise the cost (rejected, damping
raised, later accepted). Every lane's code, pass count, final cost, final
delta, means and history must equal the JAX driver's (``jnp.where``
chain) within rtol=1e-7, atol=1e-8 (rounding compounds over passes). The
`cuda` test holds the adaptive loop on the card against its plain run and
skips here; JAX is imported lazily so it also runs where JAX is absent.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import api as tapi
from repro_torch.core import iterated as tit
from repro_torch.core.types import LinearizedSSM as TLin
from repro_torch.scenarios import get_scenario as t_scenario
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-10)
PATH_TOL = dict(rtol=1e-7, atol=1e-8)
NAN_LANE, REJECT_LANE = 1, 2

CASES = {
    "taylor": dict(damping="adaptive", lm_lambda=1e-3, n_iter=8, tol=1e-4),
    "slr": dict(damping="adaptive", linearization="slr", lm_lambda=1e-3,
                n_iter=8, tol=1e-4),
    "sqrt_default_lambda": dict(damping="adaptive", form="sqrt", n_iter=4),
    "sequential": dict(damping="adaptive", mode="sequential",
                       lm_lambda=1e-3, n_iter=5, tol=1e-4),
}


def _close(got, want, tol):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), **tol)


@functools.lru_cache(maxsize=None)
def jax_env():
    import jax
    import jax.numpy as jnp

    import repro.core as jcore
    from repro.core import iterated as jit_
    from repro.scenarios import get_scenario

    sc = get_scenario("coordinated_turn")
    return jax, jnp, jcore, jit_, sc, sc.make_model(jnp.float64)


@functools.lru_cache(maxsize=None)
def measurements(B=4, n=32):
    jax, _, _, _, sc, model = jax_env()
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    ys = np.stack([np.asarray(sc.simulate(model, n, k)[1]) for k in keys])
    ys[NAN_LANE, 5, 0] = np.nan
    ys[REJECT_LANE, 10:14] += 3.0
    return ys


def torch_model():
    return t_scenario("coordinated_turn").make_model(torch.float64, "cpu")


@functools.lru_cache(maxsize=None)
def jax_iterate(case):
    _, jnp, jcore, _, _, model = jax_env()
    smoother = jcore.build_smoother(jcore.SmootherSpec(**CASES[case]))
    return smoother.iterate(model, jnp.asarray(measurements()),
                            return_history=True, return_info=True)


def torch_iterate(case):
    smoother = tapi.build_smoother(**CASES[case], device="cpu")
    return smoother.iterate(torch_model(), torch.tensor(measurements()),
                            return_history=True, return_info=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adaptive_iterate_matches_jax(case):
    want, want_hist, want_info = jax_iterate(case)
    got, hist, info = torch_iterate(case)
    np.testing.assert_array_equal(info.code.numpy(),
                                  np.asarray(want_info.code))
    np.testing.assert_array_equal(info.iterations.numpy(),
                                  np.asarray(want_info.iterations))
    _close(info.final_cost, want_info.final_cost, PATH_TOL)   # NaN == NaN
    _close(info.final_delta, want_info.final_delta, dict(rtol=1e-5,
                                                         atol=1e-8))
    _close(got.mean, want.mean, PATH_TOL)
    _close(got.cov, want.cov, PATH_TOL)
    _close(hist, want_hist, PATH_TOL)


@pytest.mark.parametrize("case", ["taylor", "slr"])
def test_lane_verdicts_are_exercised(case):
    """The seeded lanes hit the branches the test is for: the NaN lane is
    diverged with zero passes and returns the (finite) prior; the outlier
    lane rejects steps (repeated history rows while still active) and
    still accepts later ones; no NaN reaches any returned mean."""
    got, hist, info = torch_iterate(case)
    model = torch_model()
    assert info.code[NAN_LANE] == tit.LANE_DIVERGED
    assert info.iterations[NAN_LANE] == 0
    assert torch.equal(got.mean[NAN_LANE],
                       model.m0.expand_as(got.mean[NAN_LANE]))
    assert torch.isfinite(got.mean).all() and torch.isfinite(got.cov).all()
    rows = hist[:, REJECT_LANE]
    steps = int(info.iterations[REJECT_LANE])
    moved = [not torch.equal(rows[k], rows[k - 1]) for k in range(1, steps)]
    assert not all(moved) and any(moved)
    assert info.code[0] != tit.LANE_DIVERGED


@pytest.mark.parametrize("lam", [0.5, "per-lane"])
def test_augment_lm_matches_jax(lam):
    """LM augmentation with a scalar (fixed damping) or a per-lane
    ``[B]`` damping broadcast into the pseudo-measurement covariance."""
    jax, jnp, _, jit_, _, _ = jax_env()
    from repro.core.types import LinearizedSSM as JLin

    rng = np.random.default_rng(3)
    B, n, nx, ny = 3, 6, 4, 2
    lin = [rng.standard_normal(s) for s in (
        (B, n, nx, nx), (B, n, nx), (B, n, nx, nx), (B, n, ny, nx),
        (B, n, ny), (B, n, ny, ny))]
    prev = rng.standard_normal((B, n, nx))
    lam_np = np.array([1e-3, 1.0, 1e4]) if lam == "per-lane" else lam
    want, wpseudo = jax.jit(jit_._augment_lm)(
        JLin(*map(jnp.asarray, lin)), jnp.asarray(prev),
        jnp.asarray(lam_np))
    lam_t = torch.tensor(lam_np) if lam == "per-lane" else lam
    got, pseudo = tit._augment_lm(TLin(*map(torch.tensor, lin)),
                                  torch.tensor(prev), lam_t)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, TOL)
    _close(pseudo, wpseudo, TOL)


def test_lm_schedule_constants_equal_jax():
    _, _, _, jit_, _, _ = jax_env()
    for name in ("LM_NU", "LM_LAMBDA_INIT", "LM_LAMBDA_MIN",
                 "LM_LAMBDA_MAX", "LM_MAX_BAD", "LANE_CONVERGED",
                 "LANE_MAX_ITERS", "LANE_DIVERGED"):
        assert getattr(tit, name) == getattr(jit_, name), name


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("linearization", ["taylor", "slr"])
def test_adaptive_through_kernels_matches_plain_on_card(cuda, linearization):
    """Adaptive damping on the card through both combine kernels, 16 lanes
    x n=128 (one lane with a NaN observation), against the same run with
    the plain combines: equal codes and passes, or — for a lane whose
    accept test met a rounding tie — equal costs (rtol 1e-9) and means
    within the smoother's tol, never a diverged verdict on one side."""
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.scenarios import simulate_trajectory

    model = t_scenario("coordinated_turn").make_model(torch.float64, cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    _, ys = simulate_trajectory(model, 128, gen, batch=(16,))
    ys[3, 7, 1] = float("nan")
    spec = tapi.SmootherSpec(linearization=linearization, damping="adaptive",
                             n_iter=10, tol=1e-6, lm_lambda=1.0)
    kc.reset_launch_counts()
    got, info = tapi.build_smoother(spec, device=cuda).iterate(
        model, ys, return_info=True)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["filtering_combine"] > 0
    want, winfo = tapi.build_smoother(spec, backend="jnp", device=cuda
                                      ).iterate(model, ys, return_info=True)
    assert int(info.code[3]) == tit.LANE_DIVERGED == int(winfo.code[3])
    assert torch.isfinite(got.mean).all()
    for lane in range(16):
        if (info.code[lane] == winfo.code[lane]
                and info.iterations[lane] == winfo.iterations[lane]):
            _close(got.mean[lane], want.mean[lane].cpu().numpy(), PATH_TOL)
            continue
        assert tit.LANE_DIVERGED not in (int(info.code[lane]),
                                         int(winfo.code[lane]))
        _close(info.final_cost[lane], winfo.final_cost[lane].cpu().numpy(),
               dict(rtol=1e-9, atol=0.0))
        assert float((got.mean[lane] - want.mean[lane]).abs().max()) <= 1e-6
