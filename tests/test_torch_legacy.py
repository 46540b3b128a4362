"""Port parity: the legacy entry points and the single-trajectory cells
of `Smoother`.

The shims (`ieks`, `ipls`, `iterated_smoother_batched` and the three
``*_filter_smoother_batched``) warn once per process, naming
`build_smoother`, and return the spec surface's result bit for bit; the
warn-once record is cleared in process with `reset_for_tests`. Every
(mode, form) cell of `Smoother.filter`/`smooth`/`iterate` on one
trajectory is its single-trajectory driver, bit for bit, and agrees with
the batched cell lane by lane and with JAX's `Smoother` (the suite's f64
TOL for one pass; rtol=1e-7, atol=1e-8 for the iterated path).
"""
import functools
import warnings

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch import convert
from repro_torch.core import _deprecation
from repro_torch.core.types import LinearizedSSM as TLin
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-10)
PATH_TOL = dict(rtol=1e-7, atol=1e-8)


@functools.lru_cache(maxsize=None)
def jax_env():
    import jax
    import jax.numpy as jnp

    import repro.core as jcore
    from repro.scenarios import get_scenario

    return jax, jnp, jcore, get_scenario


@functools.lru_cache(maxsize=None)
def ct_problem(n=8):
    """coordinated_turn (f64): JAX's model and measurements at
    ``PRNGKey(0)`` (numpy), and the port's model."""
    jax, jnp, _, get_scenario = jax_env()
    model = get_scenario("coordinated_turn").make_model(jnp.float64)
    _, ys = jax.jit(functools.partial(
        get_scenario("coordinated_turn").simulate, model, n))(
            jax.random.PRNGKey(0))
    tm = convert.state_space_model(
        "coordinated_turn", np.asarray(model.Q), np.asarray(model.R),
        np.asarray(model.m0), np.asarray(model.P0), device="cpu",
        dtype=torch.float64)
    return model, tm, np.asarray(ys)


def linear_problem(seed=3, n=14, nx=3, ny=2):
    """A random linear SSM (numpy, f64) and its measurements."""
    rng = np.random.default_rng(seed)

    def psd(*shape):
        a = rng.standard_normal(shape)
        return 0.5 * a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(shape[-1])

    F = 0.6 * rng.standard_normal((n, nx, nx)) / np.sqrt(nx) + 0.3 * np.eye(nx)
    lin = (F, rng.standard_normal((n, nx)), psd(n, nx, nx),
           rng.standard_normal((n, ny, nx)) / np.sqrt(nx),
           rng.standard_normal((n, ny)), psd(n, ny, ny))
    return lin, rng.standard_normal((n, ny)), np.zeros(nx), np.eye(nx)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _gaussians(x):
    """A Gaussian is itself a NamedTuple; a ``smooth`` result is a plain
    tuple of Gaussians."""
    return (x,) if hasattr(x, "_fields") else tuple(x)


def _equal(got, want):
    for g, w in zip(_gaussians(got), _gaussians(want)):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The shims: one DeprecationWarning per process, the spec surface's result
# ---------------------------------------------------------------------------

def _bucket():
    """The batched inputs of the pass shims: two copies of one trajectory
    linearized at the prior."""
    _, tm, ys = ct_problem()
    bys = _t(np.stack([ys, ys]))
    lin = tcore.linearize_model_taylor_batched(
        tm, tm.m0.expand(2, len(ys) + 1, tm.nx))
    return tm, bys, lin


def _shim_case(name):
    """``(shim call, spec-surface call)`` for one legacy entry point."""
    _, tm, ys = ct_problem()
    ys = _t(ys)
    spec = tcore.SmootherSpec(n_iter=2)
    build = functools.partial(tcore.build_smoother, device="cpu")
    if name == "ieks":
        return (lambda: tcore.ieks(tm, ys, n_iter=2),
                lambda: build(spec).iterate(tm, ys))
    if name == "ipls":
        return (lambda: tcore.ipls(tm, ys, n_iter=2),
                lambda: build(spec, linearization="slr").iterate(tm, ys))
    tm, bys, lin = _bucket()
    if name == "iterated_smoother_batched":
        cfg = tcore.IteratedConfig(n_iter=2)
        return (lambda: tcore.iterated_smoother_batched(tm, bys, cfg),
                lambda: build(tcore.SmootherSpec.from_iterated_config(cfg)
                              ).iterate(tm, bys))
    args = (lin, bys, tm.m0, tm.P0)
    axes = {"parallel_filter_smoother_batched": {},
            "filter_smoother_batched": {"mode": "sequential"},
            "sqrt_parallel_filter_smoother_batched": {"form": "sqrt"}}[name]
    return (lambda: getattr(tcore, name)(*args),
            lambda: build(**axes).smooth(*args))


SHIMS = ("ieks", "ipls", "iterated_smoother_batched",
         "parallel_filter_smoother_batched", "filter_smoother_batched",
         "sqrt_parallel_filter_smoother_batched")


def _deprecations(ws):
    return [w for w in ws if issubclass(w.category, DeprecationWarning)
            and "build_smoother" in str(w.message)]


@pytest.mark.parametrize("name", SHIMS)
def test_legacy_entry_points_warn_once_and_match(name):
    shim, surface = _shim_case(name)
    _deprecation.reset_for_tests()
    with warnings.catch_warnings(record=True) as first:
        warnings.simplefilter("always")
        got = shim()
    with warnings.catch_warnings(record=True) as second:
        warnings.simplefilter("always")
        shim()
    assert len(_deprecations(first)) == 1, first
    assert f"repro_torch.core.{name}" in str(_deprecations(first)[0].message)
    assert _deprecations(second) == [], second
    _equal(got, surface())


@pytest.mark.parametrize("name", ["ieks", "ipls"])
def test_paper_drivers_match_jax(name):
    """`ieks`/`ipls` on one trajectory against JAX's (which take the
    textbook combines there; the port runs the trajectory as one lane)."""
    jax, jnp, jcore, _ = jax_env()
    jm, tm, ys = ct_problem()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jax.jit(lambda y: getattr(jcore, name)(
            jm, y, n_iter=3, lm_lambda=1.0))(jnp.asarray(ys))
        got = getattr(tcore, name)(tm, _t(ys), n_iter=3, lm_lambda=1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PATH_TOL)


# ---------------------------------------------------------------------------
# The single-trajectory cells of Smoother: one code path each
# ---------------------------------------------------------------------------

CELLS = {
    "sequential": (dict(mode="sequential"), "filter_smoother",
                   "kalman_filter"),
    "parallel": (dict(mode="parallel"), "parallel_filter_smoother",
                 "parallel_filter"),
    "sqrt": (dict(form="sqrt"), "sqrt_parallel_filter_smoother",
             "sqrt_parallel_filter"),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_smooth_matches_legacy_matrix(cell):
    """Each (mode, form) cell of `Smoother.smooth`/`filter` on one
    trajectory equals its single-trajectory driver bit for bit (the
    parallel cell under the combine_impl the Smoother resolves), the
    batched cell per lane, and JAX's `Smoother`."""
    jax, jnp, jcore, _ = jax_env()
    axes, smoother_fn, filter_fn = CELLS[cell]
    lin, ys, m0, P0 = linear_problem()
    tlin, tys, tm0, tP0 = TLin(*map(_t, lin)), _t(ys), _t(m0), _t(P0)
    sm = tcore.build_smoother(device="cpu", **axes)
    kw = ({"combine_impl": sm._combine_impl(tys, tm0)}
          if cell == "parallel" else {})
    got_f, got_s = sm.smooth(tlin, tys, tm0, tP0)
    _equal((got_f, got_s),
           getattr(tcore, smoother_fn)(tlin, tys, tm0, tP0, **kw))
    _equal(sm.filter(tlin, tys, tm0, tP0),
           getattr(tcore, filter_fn)(tlin, tys, tm0, tP0, **kw))

    blin = TLin(*(torch.stack([x, x]) for x in tlin))
    _, bs = sm.smooth(blin, torch.stack([tys, tys]), tm0, tP0)
    assert bs.mean.shape == (2,) + got_s.mean.shape
    for i in range(2):
        np.testing.assert_allclose(bs.mean[i].numpy(), got_s.mean.numpy(),
                                   **TOL)
    want_f, want_s = jax.jit(jcore.build_smoother(**axes).smooth)(
        jcore.LinearizedSSM(*map(jnp.asarray, lin)), jnp.asarray(ys),
        jnp.asarray(m0), jnp.asarray(P0))
    for g, w in zip(tuple(got_f) + tuple(got_s), tuple(want_f) + tuple(want_s)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("linearization", ["taylor", "slr"])
def test_iterate_single_is_iterated_smoother(linearization):
    """`Smoother.iterate` on one trajectory is `iterated_smoother` under
    the Smoother's config, bit for bit, with the history and info."""
    _, tm, ys = ct_problem()
    sm = tcore.build_smoother(linearization=linearization, n_iter=2,
                              lm_lambda=1.0, device="cpu")
    got = sm.iterate(tm, _t(ys), return_history=True, return_info=True)
    want = tcore.iterated_smoother(tm, _t(ys), sm.config,
                                   return_history=True, return_info=True)
    _equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and got[1].shape == (2, 9, 5)
    _equal(got[2], want[2])
    assert got[2].iterations.shape == ()
