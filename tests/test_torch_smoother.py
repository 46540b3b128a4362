"""Port parity: linearization, the iterated smoother, the API identity
and the coordinated_turn scenario.

Measurements come from the JAX package's simulator (numpy across); the
model crosses through `repro_torch.convert`. Tolerances: the suite's f64
TOL for single-level algebra (linearization, per-step log-likelihood);
rtol=1e-7, atol=1e-8 for the whole iterated path, where rounding
differences compound over Gauss-Newton passes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.linearization import linearize_model_taylor_batched as j_lin
from repro.scenarios import get_scenario as j_scenario
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core.linearization import (
    linearize_model_taylor_batched as t_lin)
from repro_torch.core.types import Gaussian as TG
from repro_torch.scenarios import get_scenario as t_scenario
from repro_torch.scenarios import rollout, simulate_trajectory
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-10)
PATH_TOL = dict(rtol=1e-7, atol=1e-8)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@functools.lru_cache(maxsize=None)
def jax_model():
    return j_scenario("coordinated_turn").make_model(jnp.float64)


def torch_model():
    m = jax_model()
    return convert.state_space_model(
        "coordinated_turn", np.asarray(m.Q), np.asarray(m.R),
        np.asarray(m.m0), np.asarray(m.P0), device="cpu",
        dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def measurements(B=3, n=32):
    sc = j_scenario("coordinated_turn")
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    xs, ys = jax.jit(jax.vmap(lambda k: sc.simulate(jax_model(), n, k)))(keys)
    return np.asarray(xs), np.asarray(ys)


def test_convert_carries_the_model():
    jm, tm = jax_model(), torch_model()
    for name in ("Q", "R", "m0", "P0"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    x = np.random.default_rng(0).standard_normal((6, 5))
    x[0, 4] = 0.0            # omega = 0: the small-turn-rate branch
    for i in range(len(x)):
        _close(tm.f(torch.tensor(x[i])), jm.f(jnp.asarray(x[i])), TOL)
        _close(tm.h(torch.tensor(x[i])), jm.h(jnp.asarray(x[i])), TOL)


def test_taylor_linearization_matches_jax():
    xs, _ = measurements()
    means = xs + 0.05 * np.random.default_rng(1).standard_normal(xs.shape)
    means[:, ::3, 4] = 0.0   # exercise the omega -> 0 guards under AD
    want = jax.jit(lambda m: j_lin(jax_model(), m))(jnp.asarray(means))
    got = t_lin(torch_model(), torch.tensor(means))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, TOL)


ITER_CASES = {
    "spec": dict(n_iter=3, lm_lambda=1.0, tol=1e-6),
    "early_stop": dict(n_iter=10, lm_lambda=0.0, tol=1e-4),
    "fixed_m": dict(n_iter=3, lm_lambda=0.0, tol=0.0),
    "sequential": dict(n_iter=3, lm_lambda=1.0, tol=1e-6, mode="sequential"),
}


@functools.lru_cache(maxsize=None)
def jax_iterate(case):
    _, ys = measurements()
    smoother = jcore.build_smoother(jcore.SmootherSpec(**ITER_CASES[case]))
    traj, info = smoother.iterate(jax_model(), jnp.asarray(ys),
                                  return_info=True)
    ll = smoother.log_likelihood(jax_model(), jnp.asarray(ys), traj,
                                 per_step=True)
    return traj, info, ll


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_iterate_matches_jax(case):
    want, want_info, _ = jax_iterate(case)
    _, ys = measurements()
    smoother = tapi.build_smoother(tapi.SmootherSpec(**ITER_CASES[case]),
                                   device="cpu")
    got, info = smoother.iterate(torch_model(), torch.tensor(ys),
                                 return_info=True)
    _close(got.mean, want.mean, PATH_TOL)
    _close(got.cov, want.cov, PATH_TOL)
    np.testing.assert_array_equal(info.iterations.numpy(),
                                  np.asarray(want_info.iterations))
    np.testing.assert_array_equal(info.code.numpy(),
                                  np.asarray(want_info.code))
    _close(info.final_cost, want_info.final_cost, PATH_TOL)
    finite = np.isfinite(np.asarray(want_info.final_delta))
    _close(info.final_delta[finite], np.asarray(want_info.final_delta)[finite],
           dict(rtol=1e-5, atol=1e-8))


def test_early_stop_freezes_lanes_like_jax():
    """The early-stop case converges its lanes at different passes, so
    the per-lane freeze is exercised (counts equal to JAX's above)."""
    _, info, _ = jax_iterate("early_stop")
    its = np.asarray(info.iterations)
    assert its.max() < 10 and len(set(its.tolist())) >= 2
    assert (np.asarray(info.code) == 0).all()   # LANE_CONVERGED


def test_log_likelihood_per_step_matches_jax():
    traj, _, want = jax_iterate("spec")
    _, ys = measurements()
    smoother = tapi.build_smoother(**ITER_CASES["spec"], device="cpu")
    t_traj = TG(*(torch.tensor(np.asarray(x)) for x in traj))
    got = smoother.log_likelihood(torch_model(), torch.tensor(ys), t_traj,
                                  per_step=True)
    _close(got, want, TOL)
    total = smoother.log_likelihood(torch_model(), torch.tensor(ys), t_traj)
    _close(total, np.asarray(want).sum(-1), TOL)
    cost = smoother.cost(torch_model(), torch.tensor(ys), t_traj)
    want_cost = jcore.build_smoother(**ITER_CASES["spec"]).cost(
        jax_model(), jnp.asarray(ys), traj)
    _close(cost, want_cost, TOL)


def test_single_trajectory_runs_as_one_lane():
    _, ys = measurements()
    smoother = tapi.build_smoother(**ITER_CASES["spec"], device="cpu")
    model = torch_model()
    batched = smoother.iterate(model, torch.tensor(ys))
    single, info = smoother.iterate(model, torch.tensor(ys[1]),
                                    return_info=True)
    assert single.mean.shape == (33, 5) and info.code.shape == ()
    _close(single.mean, batched.mean[1].numpy(), PATH_TOL)


SPECS = [
    {},
    dict(n_iter=3, tol=1e-6, lm_lambda=1.0),
    dict(mode="sequential", backend="jnp"),
    dict(combine_impl="pallas", backend="gpu"),
    dict(linearization="slr", sigma_scheme="unscented", jitter=1e-9),
    dict(form="sqrt", damping="adaptive"),
    dict(backend="tpu", combine_impl="fused"),
]


@pytest.mark.parametrize("fields", SPECS, ids=str)
def test_spec_id_equals_jax(fields):
    want = jcore.SmootherSpec(**fields).spec_id
    assert tapi.SmootherSpec(**fields).spec_id == want
    sc_j, sc_t = j_scenario("coordinated_turn"), t_scenario("coordinated_turn")
    assert sc_t.default_spec(**fields).spec_id == \
        sc_j.default_spec(**fields).spec_id


def test_spec_validation_matches_jax():
    for bad in (dict(mode="nope"), dict(n_iter=0), dict(tol=-1.0),
                dict(combine_impl="pallas", backend="jnp"),
                dict(form="sqrt", mode="sequential"),
                dict(sigma_scheme="bogus")):
        with pytest.raises(ValueError):
            jcore.SmootherSpec(**bad)
        with pytest.raises(ValueError):
            tapi.SmootherSpec(**bad)


@pytest.mark.parametrize("fields,exc", [
    (dict(backend="tpu"), ValueError),
])
def test_unported_axes_raise_at_build(fields, exc):
    with pytest.raises(exc):
        tapi.build_smoother(**fields, device="cpu")


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
@pytest.mark.parametrize("form", ["standard", "sqrt"])
@pytest.mark.parametrize("damping", ["fixed", "adaptive"])
@pytest.mark.parametrize("lin_scheme", [
    ("taylor", "cubature"), ("slr", "cubature"), ("slr", "unscented"),
    ("slr", "gauss_hermite")])
def test_every_spec_axis_builds_and_runs(lin_scheme, damping, form, mode):
    """Every axis combination the JAX package accepts builds a smoother
    that runs on the CPU; square-root with sequential raises as in JAX."""
    linearization, scheme = lin_scheme
    fields = dict(linearization=linearization, sigma_scheme=scheme,
                  damping=damping, form=form, mode=mode, n_iter=2,
                  lm_lambda=1.0)
    if form == "sqrt" and mode == "sequential":
        with pytest.raises(ValueError, match="sqrt"):
            jcore.SmootherSpec(**fields)
        with pytest.raises(ValueError, match="sqrt"):
            tapi.build_smoother(**fields, device="cpu")
        return
    _, ys = measurements()
    traj, info = tapi.build_smoother(**fields, device="cpu").iterate(
        torch_model(), torch.tensor(ys[:2, :8]), return_info=True)
    assert traj.mean.shape == (2, 9, 5) and traj.cov.shape == (2, 9, 5, 5)
    assert torch.isfinite(traj.mean).all() and (info.code != 2).all()


def test_inputs_on_another_device_raise():
    smoother = tapi.build_smoother(device="cpu")
    with pytest.raises(ValueError, match="runs on"):
        smoother._check_device(torch.empty(2, 2, device="meta"))


def test_scenario_identity_matches_jax():
    sc_j, sc_t = j_scenario("coordinated_turn"), t_scenario("coordinated_turn")
    assert sc_t.model_id == sc_j.model_id
    assert (sc_t.nx, sc_t.ny, sc_t.default_method, sc_t.lm_lambda) == (
        sc_j.nx, sc_j.ny, sc_j.default_method, sc_j.lm_lambda)
    assert sc_t.params == sc_j.params


def jax_rollout(model, x0, qs, rs):
    """The JAX simulator's rollout body, fed given noise."""
    def step(x, noise):
        q, r = noise
        x_next = model.f(x) + q
        return x_next, (x_next, model.h(x_next) + r)
    _, (xs, ys) = jax.lax.scan(step, x0, (qs, rs))
    return jnp.concatenate([x0[None], xs], axis=0), ys


def test_rollout_fed_numpy_noise_matches_jax():
    rng = np.random.default_rng(3)
    B, n = 2, 40
    x0 = np.asarray(jax_model().m0) + 0.1 * rng.standard_normal((B, 5))
    qs = 0.03 * rng.standard_normal((B, n, 5))
    rs = 0.05 * rng.standard_normal((B, n, 2))
    xs, ys = rollout(torch_model(), torch.tensor(x0), torch.tensor(qs),
                     torch.tensor(rs))
    assert xs.shape == (B, n + 1, 5) and ys.shape == (B, n, 2)
    run = jax.jit(functools.partial(jax_rollout, jax_model()))
    for b in range(B):
        want_x, want_y = run(*map(jnp.asarray, (x0[b], qs[b], rs[b])))
        _close(xs[b], want_x, TOL)
        _close(ys[b], want_y, TOL)
        one_x, _ = rollout(torch_model(), torch.tensor(x0[b]),
                           torch.tensor(qs[b]), torch.tensor(rs[b]))
        _close(one_x, want_x, TOL)


def test_simulate_trajectory_is_seeded():
    model = torch_model()
    a = simulate_trajectory(model, 16, torch.Generator().manual_seed(5))
    b = simulate_trajectory(model, 16, torch.Generator().manual_seed(5))
    c = simulate_trajectory(model, 16, torch.Generator().manual_seed(6))
    assert a[0].shape == (17, 5) and a[1].shape == (16, 2)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert torch.isfinite(a[1]).all()
