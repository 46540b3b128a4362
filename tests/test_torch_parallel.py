"""Port parity: batched elements and filter-smoothers.

A coordinated-turn fleet is simulated and Taylor-linearized (with the LM
pseudo-measurements serving adds) by the JAX package; the linearized
model crosses as numpy. The port's batched elements, parallel
filter-smoother (every combine impl) and sequential filter-smoother are
held against the JAX package's, whose parallel path runs its fused twin
and its Pallas kernels in interpret mode. Tolerance: the suite's f64 TOL
for one level of algebra (elements); rtol=1e-8, atol=1e-9 through a whole
scan, where rounding differences pass through log2(n) combine levels.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel as jpar
from repro.core import sequential as jseq
from repro.core.iterated import _augment_lm as j_augment
from repro.core.linearization import linearize_model_taylor_batched as j_lin
from repro.core.types import LinearizedSSM as JL
from repro.scenarios import get_scenario
from repro_torch.core import parallel as tpar
from repro_torch.core import sequential as tseq
from repro_torch.core.types import Gaussian as TG, LinearizedSSM as TL
from _torch_jax import release_jax_caches  # noqa: F401

ELEM_TOL = dict(rtol=1e-9, atol=1e-10)
SCAN_TOL = dict(rtol=1e-8, atol=1e-9)


@functools.lru_cache(maxsize=None)
def fleet(B=3, n=12, per_lane_prior=False):
    """(lin, ys, m0, P0) as numpy: B simulated coordinated-turn tracks,
    linearized at the truth, LM-augmented (ny = 2 + 5)."""
    sc = get_scenario("coordinated_turn")
    model = sc.make_model(jnp.float64)

    @jax.jit
    def make(keys):
        xs, ys = jax.vmap(lambda k: sc.simulate(model, n, k))(keys)
        lin, pseudo = j_augment(j_lin(model, xs + 0.01), xs[:, 1:], 1.0)
        return lin, jnp.concatenate([ys, pseudo], axis=-1)

    lin, ys = make(jax.random.split(jax.random.PRNGKey(0), B))
    m0, P0 = np.asarray(model.m0), np.asarray(model.P0)
    if per_lane_prior:
        m0 = m0 + 0.1 * np.arange(B)[:, None]
        P0 = np.broadcast_to(P0, (B,) + P0.shape) * (1 + np.arange(B))[
            :, None, None]
    return (tuple(np.asarray(x) for x in lin), np.asarray(ys), m0, P0)


def _jax(data):
    lin, ys, m0, P0 = data
    return JL(*map(jnp.asarray, lin)), jnp.asarray(ys), jnp.asarray(m0), \
        jnp.asarray(P0)


def _torch(data):
    lin, ys, m0, P0 = data
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return TL(*map(t, lin)), t(ys), t(m0), t(P0)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("per_lane_prior", [False, True])
def test_elements_batched_match_jax(per_lane_prior):
    data = fleet(per_lane_prior=per_lane_prior)
    jl, jys, jm0, jP0 = _jax(data)
    tl, tys, tm0, tP0 = _torch(data)
    _close(tpar.filtering_elements_batched(tl, tys, tm0, tP0),
           jax.jit(jpar.filtering_elements_batched)(jl, jys, jm0, jP0),
           ELEM_TOL)
    filtered = jax.jit(jseq.kalman_filter_batched)(jl, jys, jm0, jP0)
    tf = TG(*(torch.tensor(np.asarray(x)) for x in filtered))
    _close(tpar.smoothing_elements_batched(tl, tf),
           jax.jit(jpar.smoothing_elements_batched)(jl, filtered), ELEM_TOL)


@functools.lru_cache(maxsize=None)
def jax_parallel(impl, per_lane_prior):
    jl, jys, jm0, jP0 = _jax(fleet(per_lane_prior=per_lane_prior))
    run = jax.jit(functools.partial(jpar._parallel_filter_smoother_batched,
                                    combine_impl=impl))
    return run(jl, jys, jm0, jP0)


@pytest.mark.parametrize("per_lane_prior", [False, True])
@pytest.mark.parametrize("jax_impl", ["fused", "pallas:interpret"])
@pytest.mark.parametrize("impl", ["jnp", "fused", "pallas"])
def test_parallel_filter_smoother_matches_jax(impl, jax_impl,
                                              per_lane_prior):
    """Every port impl ("pallas" is the plain version on CPU tensors) vs
    the JAX fused twin and the JAX Pallas kernels in interpret mode."""
    want_f, want_s = jax_parallel(jax_impl, per_lane_prior)
    tl, tys, tm0, tP0 = _torch(fleet(per_lane_prior=per_lane_prior))
    got_f, got_s = tpar._parallel_filter_smoother_batched(
        tl, tys, tm0, tP0, combine_impl=impl)
    _close(got_f, want_f, SCAN_TOL)
    _close(got_s, want_s, SCAN_TOL)
    assert got_s.mean.shape == (3, 13, 5)


@pytest.mark.parametrize("per_lane_prior", [False, True])
def test_sequential_filter_smoother_matches_jax(per_lane_prior):
    data = fleet(per_lane_prior=per_lane_prior)
    jl, jys, jm0, jP0 = _jax(data)
    tl, tys, tm0, tP0 = _torch(data)
    want_f, want_s = jax.jit(jseq._filter_smoother_batched)(jl, jys, jm0,
                                                            jP0)
    got_f, got_s = tseq._filter_smoother_batched(tl, tys, tm0, tP0)
    _close(got_f, want_f, SCAN_TOL)
    _close(got_s, want_s, SCAN_TOL)
    _, want_ll = jax.jit(functools.partial(
        jseq.kalman_filter_batched, return_loglik=True))(jl, jys, jm0, jP0)
    _, got_ll = tseq.kalman_filter_batched(tl, tys, tm0, tP0,
                                           return_loglik=True)
    np.testing.assert_allclose(got_ll.numpy(), np.asarray(want_ll),
                               **SCAN_TOL)


def test_parallel_matches_sequential_in_port():
    """The port's two formulations agree with each other (no JAX)."""
    tl, tys, tm0, tP0 = _torch(fleet())
    _, par = tpar._parallel_filter_smoother_batched(tl, tys, tm0, tP0,
                                                    combine_impl="pallas")
    _, seq = tseq._filter_smoother_batched(tl, tys, tm0, tP0)
    _close(par, seq, SCAN_TOL)


def test_identities():
    for nx in (1, 5):
        f = tpar.filtering_identity(nx, torch.float64)
        jf = jpar.filtering_identity(nx, jnp.float64)
        _close(f, jf, ELEM_TOL)
        s = tpar.smoothing_identity(nx, torch.float64)
        _close(s, jpar.smoothing_identity(nx, jnp.float64), ELEM_TOL)
    # Identity is neutral for the combine, on either side.
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 3))
    e = tpar.SmoothingElement(torch.tensor(a), torch.tensor(a[0]),
                              torch.tensor(a @ a.T))
    ident = tpar.smoothing_identity(3, torch.float64)
    _close(tpar.smoothing_combine(ident, e), e, ELEM_TOL)
    _close(tpar.smoothing_combine(e, ident), e, ELEM_TOL)


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_smoother_filter_and_smooth_match_jax(mode):
    """`build_smoother(...).filter/.smooth` dispatch (batched, and one
    trajectory as B=1) vs the JAX package's `Smoother`."""
    import repro.core as jcore
    from repro_torch.core import api as tapi

    jl, jys, jm0, jP0 = _jax(fleet())
    tl, tys, tm0, tP0 = _torch(fleet())
    js = jcore.build_smoother(mode=mode)
    ts = tapi.build_smoother(mode=mode, device="cpu")
    _close(ts.filter(tl, tys, tm0, tP0), js.filter(jl, jys, jm0, jP0),
           SCAN_TOL)
    want_f, want_s = js.smooth(jl, jys, jm0, jP0)
    got_f, got_s = ts.smooth(tl, tys, tm0, tP0)
    _close(got_s, want_s, SCAN_TOL)
    one_f, one_s = ts.smooth(TL(*(x[1] for x in tl)), tys[1], tm0, tP0)
    assert one_s.mean.shape == (13, 5)
    _close(one_s, [np.asarray(x)[1] for x in want_s], SCAN_TOL)
