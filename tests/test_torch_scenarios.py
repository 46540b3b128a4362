"""Port parity: the scenario registry and the scenario smoke matrix.

All six scenarios must have the JAX package's ``model_id`` (content hash
of name and parameters), knobs, noise and prior, and maps that agree at
the suite's f64 TOL on JAX-simulated states; `rollout` fed numpy noise
must reproduce the JAX simulator's recursion. The port's ``run_matrix``
runs all 24 cells on the CPU, and — fed the JAX simulator's measurements
— matches the JAX ``run_matrix`` row by row on two scenarios (the JAX side
compiles every cell, so the comparison keeps to nx = 1 and nx = 2 to stay
within a minute). The `cuda` test runs the matrix on the card against its
plain twin and skips here; JAX is imported lazily.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.scenarios import get_scenario, list_scenarios, rollout
from repro_torch.scenarios import smoke as tsmoke
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-10)
PATH_TOL = dict(rtol=1e-7, atol=1e-8)
SCENARIOS = ("bearings_only", "coordinated_turn", "lorenz96", "pendulum",
             "population", "stochastic_volatility")
#: Scenarios of the row-by-row comparison with the JAX matrix.
MATRIX_PAIR = ("pendulum", "stochastic_volatility")


def _close(got, want, tol):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), **tol)


@functools.lru_cache(maxsize=None)
def jax_env():
    import jax
    import jax.numpy as jnp

    from repro.scenarios import get_scenario as jscenario
    from repro.scenarios import smoke as jsmoke

    return jax, jnp, jscenario, jsmoke


@functools.lru_cache(maxsize=None)
def jax_model(name):
    _, jnp, jscenario, _ = jax_env()
    return jscenario(name).make_model(jnp.float64)


@functools.lru_cache(maxsize=None)
def jax_simulation(name, n, seed):
    jax, _, jscenario, _ = jax_env()
    xs, ys = jscenario(name).simulate(jax_model(name), n,
                                      jax.random.PRNGKey(seed))
    return np.asarray(xs), np.asarray(ys)


def test_registry_holds_the_jax_catalogue():
    assert tuple(list_scenarios()) == SCENARIOS
    from repro.scenarios import list_scenarios as jlist
    assert tuple(jlist()) == SCENARIOS


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_identity_and_model_match_jax(name):
    _, _, jscenario, _ = jax_env()
    sj, st = jscenario(name), get_scenario(name)
    assert st.model_id == sj.model_id
    assert st.params == sj.params
    assert (st.nx, st.ny, st.default_method, st.sigma_scheme,
            st.lm_lambda) == (sj.nx, sj.ny, sj.default_method,
                              sj.sigma_scheme, sj.lm_lambda)
    assert st.default_spec(n_iter=3).spec_id == \
        sj.default_spec(n_iter=3).spec_id
    jm, tm = jax_model(name), st.make_model(torch.float64, "cpu")
    assert tm.device.type == "cpu" and tm.m0.dtype == torch.float64
    for field in ("Q", "R", "m0", "P0"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(),
                                      np.asarray(getattr(jm, field)))
    xs, _ = jax_simulation(name, 16, 1)
    import jax
    jf, jh = jax.jit(jax.vmap(jm.f)), jax.jit(jax.vmap(jm.h))
    _close(torch.func.vmap(tm.f)(torch.tensor(xs)), jf(xs), TOL)
    _close(torch.func.vmap(tm.h)(torch.tensor(xs)), jh(xs), TOL)
    assert st.make_model(torch.float32, "cpu").Q.dtype == torch.float32


@pytest.mark.parametrize("name", SCENARIOS)
def test_rollout_on_jax_noise_matches_jax_simulator(name):
    """The JAX simulator's states are reproduced by `rollout` fed the
    noise they imply (``q_k = x_k - f(x_{k-1})``, ``r_k = y_k - h(x_k)``,
    computed on the JAX side)."""
    jax, jnp, _, _ = jax_env()
    xs, ys = jax_simulation(name, 24, 3)
    jm = jax_model(name)
    qs = xs[1:] - np.asarray(jax.vmap(jm.f)(jnp.asarray(xs[:-1])))
    rs = ys - np.asarray(jax.vmap(jm.h)(jnp.asarray(xs[1:])))
    tm = get_scenario(name).make_model(torch.float64, "cpu")
    got_x, got_y = rollout(tm, torch.tensor(xs[0]), torch.tensor(qs),
                           torch.tensor(rs))
    _close(got_x, xs, TOL)
    _close(got_y, ys, TOL)


@pytest.mark.parametrize("name", SCENARIOS)
def test_simulate_is_seeded_on_the_models_device(name):
    sc = get_scenario(name)
    model = sc.make_model(torch.float64, "cpu")
    a = sc.simulate(model, 12, torch.Generator().manual_seed(5))
    b = sc.simulate(model, 12, torch.Generator().manual_seed(5))
    assert a[0].shape == (13, sc.nx) and a[1].shape == (12, sc.ny)
    assert torch.equal(a[1], b[1]) and torch.isfinite(a[1]).all()


def test_port_matrix_all_cells_ok():
    """The port's own gate on its own simulated data: 24/24 cells."""
    rows = tsmoke.run_matrix(device="cpu", emit=lambda *_: None)
    assert len(rows) == 24
    assert [r["scenario"] for r in rows[::4]] == list(SCENARIOS)
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
    assert tsmoke.main(["--device", "cpu", "--n", "8", "--iters", "1"]) == 0


@functools.lru_cache(maxsize=None)
def both_matrices():
    """The JAX and the port matrix on `MATRIX_PAIR`, on the JAX
    simulator's measurements (seed 0, as the JAX matrix draws them)."""
    _, _, _, jsmoke = jax_env()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jsmoke, "list_scenarios", lambda: list(MATRIX_PAIR))
        mp.setattr(tsmoke, "list_scenarios", lambda: list(MATRIX_PAIR))
        want = jsmoke.run_matrix(emit=lambda *_: None)
        got = tsmoke.run_matrix(
            device="cpu", emit=lambda *_: None,
            measurements=lambda name, model, n: torch.tensor(
                jax_simulation(name, n, 0)[1], device=model.device))
    finally:
        mp.undo()
    return want, got


@pytest.mark.parametrize("cell", range(2 * 2 * len(MATRIX_PAIR)))
def test_port_matrix_matches_jax_row_by_row(cell):
    want, got = both_matrices()
    assert len(want) == len(got) == 4 * len(MATRIX_PAIR)
    w, g = want[cell], got[cell]
    for key in ("scenario", "method", "form", "model_id", "spec_id", "nx",
                "ny", "ok"):
        assert g[key] == w[key], key
    assert g["ok"]
    for key in ("loglik", "loglik_prior"):
        np.testing.assert_allclose(g[key], w[key], **PATH_TOL)
    gap = "par_seq_gap" if w["form"] == "standard" else "sqrt_std_gap"
    assert g[gap] < tsmoke.PARITY_TOL and abs(g[gap] - w[gap]) < 1e-12


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_matrix_on_card_matches_plain_twin(cuda):
    """All 24 cells on the card (nx = 1, 2, 4, 5, 8 through the kernels),
    each standard cell launching both combine kernels equally often and
    every cell's means within PATH_TOL of its plain-combine twin."""
    from repro_torch.kernels.kalman_combine import kalman_combine as kc

    marks = []
    kc.reset_launch_counts()
    rows = tsmoke.run_matrix(device=cuda,
                             emit=lambda *_: marks.append(dict(kc.LAUNCHES)))
    before = dict(kc.LAUNCHES)
    twins = tsmoke.run_matrix(device=cuda, backend="jnp",
                              emit=lambda *_: None)
    assert kc.LAUNCHES == before
    prev = {k: 0 for k in kc.LAUNCHES}
    for row, twin, now in zip(rows, twins, marks):
        launched = {k: now[k] - prev[k] for k in now}
        prev = now
        assert row["ok"], row
        if row["form"] == "standard":
            assert min(launched.values()) > 0
            assert len(set(launched.values())) == 1
        else:
            assert not any(launched.values())
        _close(row["mean"], twin["mean"].cpu().numpy(), PATH_TOL)
