"""Port parity: the single-trajectory surface of `repro_torch.core`.

Every single-trajectory driver (the batched one on one lane) against its
JAX function on the same numpy inputs: the parallel and sequential
filters and smoothers, the square-root forms (compared through their
covariances, as QR sign conventions differ), the elements, the public
`associative_scan`, the trajectory linearizations, `initial_trajectory`
and `iterated_smoother`. Then the exported log-likelihood and GN cost on
one trajectory (they raised before), ``axis_name`` outside a mesh (an
unbound axis raises ``NameError``, as in JAX; inside a mesh the drivers
are held in `test_torch_mesh_scan.py`), the surface itself (`__all__` and every shared signature against
`repro.core`), and `repro_torch.data`.

Tolerances: the suite's f64 TOL for one pass; rtol=1e-7, atol=1e-8 for
the whole iterated path. JAX is imported lazily, so the `cuda` test also
runs where JAX is absent.
"""
import dataclasses
import functools
import inspect
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch import convert
from repro_torch.core.types import Gaussian as TG
from repro_torch.core.types import LinearizedSSM as TLin
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-10)
PATH_TOL = dict(rtol=1e-7, atol=1e-8)
N, NX, NY = 12, 3, 2


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), **tol)


def _close_tree(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        _close(g, w, tol)


@functools.lru_cache(maxsize=None)
def jax_env():
    import jax
    import jax.numpy as jnp

    import repro.core as jcore

    return jax, jnp, jcore


def random_ssm(seed, n=N, nx=NX, ny=NY):
    """One random linear SSM ``[n]`` with its measurements and prior
    (numpy, f64), built as the JAX suite's ``random_linear_ssm``."""
    rng = np.random.default_rng(seed)

    def psd(*shape):
        a = rng.standard_normal(shape)
        return 0.5 * a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(shape[-1])

    F = 0.6 * rng.standard_normal((n, nx, nx)) / np.sqrt(nx) + 0.3 * np.eye(nx)
    lin = (F, rng.standard_normal((n, nx)), psd(n, nx, nx),
           rng.standard_normal((n, ny, nx)) / np.sqrt(nx),
           rng.standard_normal((n, ny)), psd(n, ny, ny))
    return lin, rng.standard_normal((n, ny)), rng.standard_normal(nx), \
        psd(nx, nx)


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a), dtype=torch.float64, device=device)


def as_torch(lin, ys, m0, P0, device="cpu"):
    return (TLin(*(_t(x, device) for x in lin)), _t(ys, device),
            _t(m0, device), _t(P0, device))


def as_jax(lin, ys, m0, P0):
    _, jnp, jcore = jax_env()
    return (jcore.LinearizedSSM(*map(jnp.asarray, lin)), jnp.asarray(ys),
            jnp.asarray(m0), jnp.asarray(P0))


def jax_filtered(args):
    """JAX's filtered posteriors of ``args`` (the smoothers' input)."""
    jax, _, jcore = jax_env()
    out = jax.jit(jcore.kalman_filter)(*as_jax(*args))
    return tuple(np.asarray(x) for x in out)


# ---------------------------------------------------------------------------
# One linearized pass: each driver against its JAX function
# ---------------------------------------------------------------------------

def _filter_case(name, **kw):
    def run(pkg, lin, ys, m0, P0, filtered):
        return getattr(pkg, name)(lin, ys, m0, P0, **kw)
    return run


def _smoother_case(name):
    def run(pkg, lin, ys, m0, P0, filtered):
        return getattr(pkg, name)(lin, filtered, m0, P0)
    return run


def _kalman_loglik(pkg, lin, ys, m0, P0, filtered):
    out, ll = pkg.kalman_filter(lin, ys, m0, P0, return_loglik=True)
    return tuple(out) + (ll,)


def _pair(name, **kw):
    def run(pkg, lin, ys, m0, P0, filtered):
        f, s = getattr(pkg, name)(lin, ys, m0, P0, **kw)
        return tuple(f) + tuple(s)
    return run


def _smoothing_elements(pkg, lin, ys, m0, P0, filtered):
    return pkg.smoothing_elements(lin, filtered)


DRIVERS = {
    "parallel_filter": _filter_case("parallel_filter"),
    "parallel_smoother": _smoother_case("parallel_smoother"),
    "parallel_filter_smoother": _pair("parallel_filter_smoother"),
    "kalman_filter": _filter_case("kalman_filter"),
    "kalman_filter_loglik": _kalman_loglik,
    "rts_smoother": _smoother_case("rts_smoother"),
    "filter_smoother": _pair("filter_smoother"),
    "sqrt_parallel_filter": _filter_case("sqrt_parallel_filter"),
    "sqrt_parallel_smoother": _smoother_case("sqrt_parallel_smoother"),
    "sqrt_parallel_filter_smoother": _pair("sqrt_parallel_filter_smoother"),
    "filtering_elements": _filter_case("filtering_elements"),
    "smoothing_elements": _smoothing_elements,
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_single_trajectory_driver_matches_jax(name):
    """Square-root covariances are ``U Uᵀ`` on both sides (the drivers
    return products, never factors)."""
    jax, jnp, jcore = jax_env()
    args = random_ssm(3)
    filt = jax_filtered(args)
    want = jax.jit(functools.partial(DRIVERS[name], jcore))(
        *as_jax(*args), jcore.Gaussian(*map(jnp.asarray, filt)))
    got = DRIVERS[name](tcore, *as_torch(*args), TG(*map(_t, filt)))
    _close_tree(got, want)


@pytest.mark.parametrize("impl", ["jnp", "fused", "pallas"])
@pytest.mark.parametrize("kind", ["filtering", "smoothing"])
def test_associative_scan_matches_jax(kind, impl):
    """The public scan over one trajectory's elements, prefix (filtering)
    or suffix (smoothing), under every combine_impl the port takes on the
    CPU, against JAX's textbook scan."""
    jax, jnp, jcore = jax_env()
    args = random_ssm(5)
    filt = jax_filtered(args)
    jlin, jys, jm0, jP0 = as_jax(*args)
    lin, ys, m0, P0 = as_torch(*args)
    if kind == "filtering":
        jel = jcore.filtering_elements(jlin, jys, jm0, jP0)
        el = tcore.filtering_elements(lin, ys, m0, P0)
        jc, tc, rev = jcore.filtering_combine, tcore.filtering_combine, False
    else:
        jel = jcore.smoothing_elements(
            jlin, jcore.Gaussian(*map(jnp.asarray, filt)))
        el = tcore.smoothing_elements(lin, TG(*map(_t, filt)))
        jc, tc, rev = jcore.smoothing_combine, tcore.smoothing_combine, True
    want = jax.jit(functools.partial(jcore.associative_scan, jc,
                                     reverse=rev))(jel)
    got = tcore.associative_scan(tc, el, reverse=rev, combine_impl=impl)
    _close_tree(got, want)


# ---------------------------------------------------------------------------
# The coordinated-turn model: linearization, initialization, iteration
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ct_problem(n=16):
    """JAX's coordinated_turn model (f64) and one trajectory simulated at
    ``PRNGKey(0)``."""
    jax, jnp, _ = jax_env()
    from repro.scenarios import get_scenario

    sc = get_scenario("coordinated_turn")
    model = sc.make_model(jnp.float64)
    xs, ys = sc.simulate(model, n, jax.random.PRNGKey(0))
    return sc, model, np.asarray(xs), np.asarray(ys)


def torch_model():
    _, jm, _, _ = ct_problem()
    return convert.state_space_model(
        "coordinated_turn", np.asarray(jm.Q), np.asarray(jm.R),
        np.asarray(jm.m0), np.asarray(jm.P0), device="cpu",
        dtype=torch.float64)


def _nominal(xs):
    """A trajectory near the truth: where both packages linearize."""
    return xs + 0.05 * np.random.default_rng(1).standard_normal(xs.shape)


def test_linearize_model_taylor_matches_jax():
    jax, jnp, jcore = jax_env()
    _, jm, xs, _ = ct_problem()
    means = _nominal(xs)
    want = jax.jit(functools.partial(jcore.linearize_model_taylor, jm))(
        jnp.asarray(means))
    _close_tree(tcore.linearize_model_taylor(torch_model(), _t(means)), want)


def test_linearize_model_slr_matches_jax():
    jax, jnp, jcore = jax_env()
    _, jm, xs, _ = ct_problem()
    means = _nominal(xs)
    covs = np.broadcast_to(0.01 * np.eye(5), means.shape + (5,)).copy()
    want = jax.jit(lambda t: jcore.linearize_model_slr(
        jm, t, jcore.get_scheme("cubature", 5)))(
            jcore.Gaussian(jnp.asarray(means), jnp.asarray(covs)))
    got = tcore.linearize_model_slr(torch_model(), TG(_t(means), _t(covs)),
                                    tcore.get_scheme("cubature", 5))
    _close_tree(got, want)


def test_initial_trajectory_matches_jax():
    _, _, jcore = jax_env()
    _, jm, _, _ = ct_problem()
    got = tcore.initial_trajectory(torch_model(), 16)
    _close_tree(got, jcore.initial_trajectory(jm, 16))
    assert got.mean.device == torch_model().device


@pytest.mark.parametrize("method", ["ekf", "slr"])
def test_iterated_smoother_matches_jax(method):
    """Three damped passes with the history and the lane status; the
    port runs the trajectory as one lane."""
    jax, jnp, jcore = jax_env()
    _, jm, _, ys = ct_problem()
    kw = dict(method=method, n_iter=3, lm_lambda=1.0)
    want, whist, winfo = jax.jit(lambda y: jcore.iterated_smoother(
        jm, y, jcore.IteratedConfig(**kw), return_history=True,
        return_info=True))(jnp.asarray(ys))
    got, hist, info = tcore.iterated_smoother(
        torch_model(), _t(ys), tcore.IteratedConfig(**kw),
        return_history=True, return_info=True)
    _close_tree(got, want, PATH_TOL)
    _close(hist, whist, PATH_TOL)
    assert int(info.iterations) == int(winfo.iterations) == 3
    assert int(info.code) == int(winfo.code)
    _close(info.final_cost, winfo.final_cost, PATH_TOL)
    assert info.code.shape == ()


F32_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("scenario", ["coordinated_turn", "pendulum"])
def test_float32_taylor_pass_stays_float32(scenario):
    """A float32 model's Taylor linearization is float32, as JAX's is
    (forward-mode AD promotes ``0-d tensor * Python float`` tangents to
    float64, which the two models' maps hit), and one damped pass runs
    in float32 and matches JAX's at the f32 TOL."""
    jax, jnp, jcore = jax_env()
    from repro.scenarios import get_scenario

    jm = get_scenario(scenario).make_model(jnp.float32)
    _, ys = jax.jit(functools.partial(get_scenario(scenario).simulate, jm,
                                      12))(jax.random.PRNGKey(1))
    tm = convert.state_space_model(
        scenario, np.asarray(jm.Q), np.asarray(jm.R), np.asarray(jm.m0),
        np.asarray(jm.P0), device="cpu", dtype=torch.float32)
    traj = tcore.initial_trajectory(tm, 12)
    lin = tcore.linearize_model_taylor(tm, traj.mean)
    assert {x.dtype for x in lin} == {torch.float32}
    _close_tree(lin, jax.jit(lambda: jcore.linearize_model_taylor(
        jm, jcore.initial_trajectory(jm, 12).mean))(), F32_TOL)
    kw = dict(n_iter=1, lm_lambda=1.0)
    want = jax.jit(lambda y: jcore.iterated_smoother(
        jm, y, jcore.IteratedConfig(**kw)))(ys)
    got = tcore.iterated_smoother(tm, torch.tensor(np.asarray(ys)),
                                  tcore.IteratedConfig(**kw))
    assert got.mean.dtype == torch.float32
    _close_tree(got, want, F32_TOL)


# ---------------------------------------------------------------------------
# The exported log-likelihood and GN cost on one trajectory
# ---------------------------------------------------------------------------

#: JAX's values on coordinated_turn, n = 16, `PRNGKey(0)`, after
#: `default_spec(n_iter=2)`'s two passes (f64, CPU).
JAX_LOGLIK = 54.52153311001858
JAX_GN_COST = 13.6328979154388


def test_loglik_and_cost_accept_one_trajectory():
    """`smoothed_log_likelihood` and `gn_cost` take ``ys [n, ny]`` with
    ``traj [n+1, ...]`` and return JAX's scalar; the Smoother's methods
    return the same."""
    jax, jnp, jcore = jax_env()
    sc, jm, _, ys = ct_problem()
    spec = sc.default_spec(n_iter=2)

    @jax.jit
    def reference(y):
        traj = jcore.build_smoother(spec).iterate(jm, y)
        return (traj, jcore.smoothed_log_likelihood(
            jm, y, traj, spec.iterated_config()), jcore.gn_cost(jm, y, traj))

    jtraj, want_ll, want_cost = reference(jnp.asarray(ys))
    np.testing.assert_allclose(float(want_ll), JAX_LOGLIK, rtol=1e-9)
    np.testing.assert_allclose(float(want_cost), JAX_GN_COST, rtol=1e-9)

    from repro_torch.scenarios import get_scenario

    tspec = get_scenario("coordinated_turn").default_spec(n_iter=2)
    traj = TG(*(_t(x) for x in jtraj))
    model, tys = torch_model(), _t(ys)
    ll = tcore.smoothed_log_likelihood(model, tys, traj,
                                       tspec.iterated_config())
    cost = tcore.gn_cost(model, tys, traj)
    assert ll.shape == () and cost.shape == ()
    np.testing.assert_allclose(float(ll), JAX_LOGLIK, rtol=1e-9)
    np.testing.assert_allclose(float(cost), JAX_GN_COST, rtol=1e-9)
    sm = tcore.build_smoother(tspec, device="cpu")
    assert float(sm.log_likelihood(model, tys, traj)) == float(ll)
    assert float(sm.cost(model, tys, traj)) == float(cost)
    per_step = tcore.smoothed_log_likelihood(model, tys, traj,
                                             tspec.iterated_config(),
                                             per_step=True)
    assert per_step.shape == (16,)
    _close(per_step.sum(), float(ll))


# ---------------------------------------------------------------------------
# axis_name outside a mesh: an unbound axis
# ---------------------------------------------------------------------------

AXIS_CALLS = ("associative_scan", "linear_recurrence_scan",
              "parallel_filter", "parallel_filter_smoother_batched",
              "parallel_smoother_batched", "sqrt_parallel_filter")


def _axis_call(name):
    lin, ys, m0, P0 = as_torch(*random_ssm(2, n=4))
    blin, bys = TLin(*(x[None] for x in lin)), ys[None]
    if name == "associative_scan":
        return tcore.associative_scan(
            tcore.filtering_combine,
            tcore.filtering_elements(lin, ys, m0, P0), axis_name="x",
            identity=lambda: tcore.filtering_identity(
                m0.shape[-1], m0.dtype))
    if name == "linear_recurrence_scan":
        return tcore.linear_recurrence_scan(ys, ys, axis_name="x")
    if name == "parallel_smoother_batched":
        filt = tcore.kalman_filter_batched(blin, bys, m0, P0)
        return tcore.parallel_smoother_batched(blin, filt, m0, P0,
                                               axis_name="x")
    if name.endswith("_batched"):
        return getattr(tcore, name)(blin, bys, m0, P0, axis_name="x")
    return getattr(tcore, name)(lin, ys, m0, P0, axis_name="x")


@pytest.mark.parametrize("name", AXIS_CALLS)
def test_axis_name_raises_naming_item_4(name):
    """With no mesh around the call, the axis is unbound and the sharded
    path raises ``NameError`` (JAX's unbound axis), naming the axis."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(NameError, match="unbound axis name: 'x'"):
            _axis_call(name)


# ---------------------------------------------------------------------------
# The surface itself
# ---------------------------------------------------------------------------

#: The port's one addition to `repro.core`'s names.
PORT_ONLY = {"resolve_device"}
#: Every allowed signature difference, by name: "device" — the port adds a
#: ``device`` parameter (entry points run on the card unless told);
#: "dtype" — a ``torch.*`` dtype default where JAX has ``jnp.*``.
ALLOWED = {
    "build_smoother": {"device"},
    "Smoother.__init__": {"device"},
    "filtering_identity": {"device", "dtype"},
    "smoothing_identity": {"device", "dtype"},
}


def _default(value, allow_dtype):
    if value is inspect.Parameter.empty:
        return "<none>"
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__, dataclasses.astuple(value))
    if allow_dtype and (isinstance(value, torch.dtype)
                        or getattr(value, "__module__", "").startswith("jax")):
        return ("dtype", np.dtype(str(value).split(".")[-1].rstrip("'>")))
    return repr(value)


def _params(where, sig):
    allowed = ALLOWED.get(where, set())
    return [(p.name, p.kind, _default(p.default, "dtype" in allowed))
            for p in sig.parameters.values()
            if not ("device" in allowed and p.name == "device")]


def _signatures(name, obj):
    """``{where: signature}`` of one exported name: the function, each
    public method of a plain class (and its constructor), the fields of a
    dataclass or NamedTuple."""
    if dataclasses.is_dataclass(obj) and isinstance(obj, type):
        return {name: [(f.name, repr(f.default))
                       for f in dataclasses.fields(obj)]}
    if isinstance(obj, type) and issubclass(obj, tuple):
        return {name: list(obj._fields)}
    if isinstance(obj, type):
        out = {}
        for m in sorted(vars(obj)):
            member = inspect.getattr_static(obj, m)
            if (m.startswith("_") and m not in ("__call__", "__init__")) \
                    or not callable(member):
                continue
            where = f"{name}.{m}"
            out[where] = _params(where, inspect.signature(member))
        return out
    if callable(obj):
        return {name: _params(name, inspect.signature(obj))}
    return {name: repr(obj)}


def test_surface_matches_jax():
    """`__all__` is JAX's plus `resolve_device`, and every shared name
    agrees on parameter names, kinds and defaults (on fields, for
    dataclasses and NamedTuples), up to `ALLOWED`."""
    _, _, jcore = jax_env()
    assert len(tcore.__all__) == len(set(tcore.__all__)) == 74
    assert set(tcore.__all__) == set(jcore.__all__) | PORT_ONLY
    seen = set()
    for name in sorted(set(tcore.__all__) & set(jcore.__all__)):
        got = _signatures(name, getattr(tcore, name))
        want = _signatures(name, getattr(jcore, name))
        assert got == want, name
        seen.update(got)
    assert set(ALLOWED) <= seen


def test_dump_surface_runs():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.api", "--dump-surface"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    lines = out.stdout.splitlines()
    assert lines[0] == "# repro_torch.core public API surface (74 names)"
    assert any(line.startswith("ieks(model, ys, n_iter: 'int' = 10")
               for line in lines)


def test_data_reexports_the_tracking_names():
    import repro_torch.data as data
    from repro_torch import scenarios

    assert data.__all__ == ["CoordinatedTurnConfig",
                            "make_coordinated_turn_model",
                            "simulate_trajectory"]
    assert data.CoordinatedTurnConfig is scenarios.CoordinatedTurnConfig
    assert data.make_coordinated_turn_model is \
        scenarios.make_coordinated_turn_model
    assert data.simulate_trajectory is scenarios.simulate_trajectory


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the combine kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_single_trajectory_kernels_match_textbook(cuda):
    """`parallel_filter_smoother` at n = 64 through the kernels (each scan
    level a ``[1, P]`` grid) against the textbook combines."""
    from repro_torch.kernels.kalman_combine import kalman_combine as kc

    args = as_torch(*random_ssm(9, n=64, nx=5, ny=2), device=cuda)
    kc.reset_launch_counts()
    got = tcore.parallel_filter_smoother(*args, combine_impl="pallas")
    torch.cuda.synchronize()
    assert min(kc.LAUNCHES.values()) > 0
    want = tcore.parallel_filter_smoother(*args, combine_impl="jnp")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _close(a, b.cpu().numpy())
