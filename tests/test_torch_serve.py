"""Port parity: the one-shot smoother service (the slice as a whole).

The same six JAX-simulated requests (numpy across) go through the JAX
`SmootherServer` and the port's, on the CPU: same buckets and launches,
per-request smoothed means and log-likelihood fit scores within the
iterated-path tolerance (rtol=1e-7, atol=1e-8: rounding compounds over
up to 10 Gauss-Newton passes). Also: the padding contract, the package's
import boundary (no jax, no repro), and that the entry points refuse to
run without a card unless asked for the CPU.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.scenarios import get_scenario as j_scenario
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.launch import serve as tserve
from repro_torch.scenarios import get_scenario as t_scenario
from _torch_jax import release_jax_caches  # noqa: F401

PATH_TOL = dict(rtol=1e-7, atol=1e-8)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
LENGTHS = [48, 36, 24, 48, 36, 48]


def _linearization(method):
    return "taylor" if method == "ekf" else "slr"


@functools.lru_cache(maxsize=None)
def jax_side(method="ekf"):
    sc = j_scenario("coordinated_turn")
    model = sc.make_model(jnp.float64)
    requests = [np.asarray(sc.simulate(model, n, jax.random.PRNGKey(i))[1])
                for i, n in enumerate(LENGTHS)]
    cfg = jserve.SmootherServeConfig(requests=6, n=48, max_batch=4,
                                     method=method)
    spec = sc.default_spec(linearization=_linearization(method),
                           n_iter=cfg.n_iter, tol=cfg.tol,
                           lm_lambda=cfg.lm_lambda)
    server = jserve.SmootherServer(model, cfg, spec=spec)
    stats = server.serve_requests(requests, emit=lambda *_: None)
    return model, requests, server, stats


def torch_server(method="ekf"):
    jmodel, _, _, _ = jax_side()
    model = convert.state_space_model(
        "coordinated_turn", *(np.asarray(getattr(jmodel, k))
                              for k in ("Q", "R", "m0", "P0")),
        device="cpu")
    cfg = tserve.SmootherServeConfig(requests=6, n=48, max_batch=4,
                                     method=method)
    spec = t_scenario("coordinated_turn").default_spec(
        linearization=_linearization(method), n_iter=cfg.n_iter,
        tol=cfg.tol, lm_lambda=cfg.lm_lambda)
    return tserve.SmootherServer(model, cfg, spec=spec, device="cpu")


def test_pad_requests_matches_jax():
    rng = np.random.default_rng(0)
    R = np.diag([0.01, 0.02])
    batch = [rng.standard_normal((n, 2)) for n in (5, 8, 3)]
    want_y, want_r = jserve.pad_requests(batch, 8, 4, R)
    got_y, got_r = tserve.pad_requests([torch.tensor(b) for b in batch], 8,
                                       4, torch.tensor(R))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    assert tserve.R_PAD_SCALE == jserve.R_PAD_SCALE


def test_serve_requests_matches_jax():
    _check_service_matches_jax("ekf")


def test_slr_serve_requests_matches_jax():
    """The IPLS service: sigma-point SLR (cubature) linearization."""
    _check_service_matches_jax("slr")


def _check_service_matches_jax(method):
    _, requests, jserver, want = jax_side(method)
    server = torch_server(method)
    for n in set(LENGTHS):
        assert server.queue_signature(n) == jserver.queue_signature(n)
    got = server.serve_requests([torch.tensor(r) for r in requests],
                                emit=lambda *_: None)
    assert set(want) <= set(got)
    assert got["launches"] == want["launches"] == 3
    assert got["requests"] == want["requests"] == 6
    assert got["mean_iterations"] == want["mean_iterations"]
    for n, g, w in zip(LENGTHS, got["results"], want["results"]):
        assert tuple(g.shape) == (n + 1, 5)
        np.testing.assert_allclose(g.numpy(), w, **PATH_TOL)
    np.testing.assert_allclose(got["logliks"], want["logliks"], **PATH_TOL)
    assert all(c in (0, 1) for c in got["codes"])


def test_serve_smoother_end_to_end_on_cpu(capsys):
    _check_cli_on_cpu(capsys, "ekf")


def test_slr_serve_smoother_end_to_end_on_cpu(capsys):
    _check_cli_on_cpu(capsys, "slr")


def _check_cli_on_cpu(capsys, method):
    tserve.main(["--workload", "smoother", "--arrival", "none",
                 "--requests", "3", "--n", "16", "--max-batch", "2",
                 "--iters", "3", "--device", "cpu", "--method", method])
    out = capsys.readouterr().out
    assert "[serve/smoother] 3 requests in" in out
    assert "mean position RMSE" in out
    stats = tserve.serve_smoother(
        tserve.SmootherServeConfig(requests=3, n=16, max_batch=2, n_iter=3,
                                   method=method),
        emit=lambda *_: None, device="cpu")
    assert stats["mean_rmse"] < 1.0 and len(stats["results"]) == 3


def test_warmup_runs_each_bucket_shape():
    server = torch_server()
    server.warmup([16, 32], [1, 2])
    means, info, lls, health = server.smooth_batch(
        [torch.zeros(10, 2, dtype=torch.float64)], 16, 2)
    assert means[0].shape == (11, 5) and len(lls) == 1 and health == [True]
    assert info.code.shape == (2,)


def test_fleet_is_seeded():
    model = convert.state_space_model(
        "coordinated_turn", *(np.asarray(getattr(jax_side()[0], k))
                              for k in ("Q", "R", "m0", "P0")), device="cpu")
    cfg = tserve.SmootherServeConfig(requests=4, n=16)
    a, ta = tserve.make_fleet(cfg, model)
    b, _ = tserve.make_fleet(cfg, model)
    assert [len(y) for y in a] == [len(y) for y in b]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(len(t) == len(y) + 1 for t, y in zip(ta, a))


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tserve.SmootherServeConfig(requests=2, n=8, max_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build_smoother()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build_smoother(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve_smoother(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--requests", "2", "--n", "8"])
    model = torch_server().model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.SmootherServer(model, cfg)
    assert tapi.build_smoother(device="cpu").device.type == "cpu"


def test_convert_model_needs_a_card_unless_asked_for_cpu(monkeypatch):
    """`convert.state_space_model` without ``device`` resolves to the
    card, and raises without one, as every entry point of the port."""
    arrays = [np.asarray(getattr(jax_side()[0], k))
              for k in ("Q", "R", "m0", "P0")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_space_model("coordinated_turn", *arrays)
    assert convert.state_space_model("coordinated_turn", *arrays,
                                     device="cpu").Q.device.type == "cpu"


def test_package_imports_no_jax_and_no_repro():
    """Importing every repro_torch module (fresh interpreter) loads no
    jax and no module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(' '.join(n for n in sys.modules "
        "if n.startswith('repro_torch')))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    loaded = set(proc.stdout.split())
    assert len(loaded) >= 15
    # The streaming service's modules are among them.
    assert {"repro_torch.runtime", "repro_torch.runtime.fault",
            "repro_torch.launch.autobatch", "repro_torch.launch.chaos",
            "repro_torch.launch.serve",
            "repro_torch.kernels.kalman_combine.autotune"} <= loaded
    for root, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for name in files:
            if name.endswith(".py"):
                text = open(os.path.join(root, name)).read()
                assert "import jax" not in text, name
                assert "from repro." not in text and \
                    "import repro\n" not in text, name
