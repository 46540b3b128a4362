"""Port parity: the multi-tenant smoother service.

`TenantSpec.parse` and the duplicate-route check behave as the JAX
package's; `make_tenant_fleet` draws the same tenants and lengths from the
same numpy stream; one mixed stream of JAX-simulated requests (numpy
across) through both packages' `MultiTenantServer.serve_stream` gives the
same records and, per request, means and log-likelihoods within the
iterated-path tolerance (rtol=1e-7, atol=1e-8), and no launch mixes
tenants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_smoother as j_build
from repro.launch import serve as jserve
from repro.scenarios import get_scenario as j_scenario
from repro_torch.core.api import build_smoother as t_build
from repro_torch.launch import serve as tserve
from repro_torch.scenarios import get_scenario as t_scenario
from _torch_jax import release_jax_caches  # noqa: F401

PATH_TOL = dict(rtol=1e-7, atol=1e-8)
CFG = dict(requests=6, n=8, max_batch=2, n_iter=2, tol=0.0, f64=True,
           max_wait_s=0.05, deadline_s=0.5)
TENANTS = ("pendulum:gold", "stochastic_volatility:batch")
ORDER = ["pendulum", "stochastic_volatility"] * 3


def _quiet(*_a, **_k):
    return None


@pytest.mark.parametrize("text", [
    "lorenz96:batch:0.5", "pendulum", "pendulum::2.0", "pendulum:gold:",
    "coordinated_turn:standard:3"])
def test_tenantspec_parse_matches_jax(text):
    want, got = jserve.TenantSpec.parse(text), tserve.TenantSpec.parse(text)
    assert vars(got) == vars(want)
    assert got.budget_s == want.budget_s
    assert got.slo_class.priority == want.slo_class.priority


@pytest.mark.parametrize("text,match", [
    ("pendulum:platinum", "unknown SLO class"),
    ("pendulum:gold:heavy", "weight must be a float")])
def test_tenantspec_rejects_like_jax(text, match):
    for mod in (jserve, tserve):
        with pytest.raises(ValueError, match=match):
            mod.TenantSpec.parse(text)


def test_duplicate_route_rejected_like_jax():
    tenants = [("pendulum", "pendulum"), ("p2", "pendulum")]
    for mod, kw in ((jserve, {}), (tserve, {"device": "cpu"})):
        cfg = mod.SmootherServeConfig(**CFG)
        with pytest.raises(ValueError, match="same .model_id, method."):
            mod.MultiTenantServer([mod.TenantSpec(tenant=t, scenario=s)
                                   for t, s in tenants], cfg, **kw)
        with pytest.raises(ValueError, match="duplicate tenant"):
            mod.MultiTenantServer([mod.TenantSpec.parse("pendulum")] * 2,
                                  cfg, **kw)


def test_tenant_fleet_draws_match_jax():
    """Same tenants and lengths, request for request (trajectories come
    from each package's own generator)."""
    tenants = ["coordinated_turn", "pendulum:gold:2", "lorenz96:batch:0.5"]
    jserver = jserve.MultiTenantServer(
        [jserve.TenantSpec.parse(t) for t in tenants],
        jserve.SmootherServeConfig(**CFG))
    tserver = tserve.MultiTenantServer(
        [tserve.TenantSpec.parse(t) for t in tenants],
        tserve.SmootherServeConfig(**CFG), device="cpu")
    want, _ = jserve.make_tenant_fleet(jserver, 12, 8, seed=3)
    got, gtruth = tserve.make_tenant_fleet(tserver, 12, 8, seed=3)
    assert [t for t, _ in got] == [t for t, _ in want]
    assert [len(y) for _, y in got] == [len(y) for _, y in want]
    assert len({t for t, _ in got}) == 3
    assert {len(y) for _, y in got} <= {4, 6, 8}
    for (tenant, ys), xs in zip(got, gtruth):
        assert ys.shape[1] == tserver.servers[tenant].model.ny
        assert len(xs) == len(ys) + 1 and bool(torch.isfinite(xs).all())
    again, _ = tserve.make_tenant_fleet(tserver, 12, 8, seed=3)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, again))


@pytest.fixture(scope="module")
def served():
    """One mixed stream through both packages' multi-tenant servers (each
    tenant's requests simulated by one vmapped JAX call). Both autotune
    caches start empty, so the streams' ``backend_choices`` hold this
    stream's shapes only, whatever ran before in the process."""
    from repro.kernels.kalman_combine import autotune as jat
    from repro_torch.kernels.kalman_combine import autotune as tat

    jat.clear_cache()
    tat.clear_cache()
    jserver = jserve.MultiTenantServer(
        [jserve.TenantSpec.parse(t) for t in TENANTS],
        jserve.SmootherServeConfig(**CFG))
    sims = {}
    for tenant in TENANTS:
        name = tenant.split(":")[0]
        keys = jnp.stack([jax.random.PRNGKey(40 + i)
                          for i, t in enumerate(ORDER) if t == name])
        model = jserver.servers[name].model
        sims[name] = list(np.asarray(jax.vmap(
            lambda k: j_scenario(name).simulate(model, 8, k)[1])(keys)))
    requests = [(t, sims[t].pop(0)) for t in ORDER]
    arrivals = np.zeros(len(requests))
    want = jserver.serve_stream(requests, arrivals, emit=_quiet)
    tserver = tserve.MultiTenantServer(
        [tserve.TenantSpec.parse(t) for t in TENANTS],
        tserve.SmootherServeConfig(**CFG), device="cpu")
    got = tserver.serve_stream([(t, torch.tensor(y)) for t, y in requests],
                               arrivals, emit=_quiet)
    return jserver, tserver, requests, want, got


def test_routes_match_jax(served):
    jserver, tserver = served[:2]
    for tenant in ORDER[:2]:
        assert tserver.servers[tenant].model_id == \
            jserver.servers[tenant].model_id
        assert tserver.servers[tenant].retry_model_id == \
            jserver.servers[tenant].retry_model_id
        assert tserver.servers[tenant].spec.spec_id == \
            jserver.servers[tenant].spec.spec_id


def test_mixed_stream_matches_jax_per_tenant(served):
    _, _, requests, want, got = served
    view = [(r["req_id"], r["reason"], r["verdict"], r["tenant"],
             r["attempt"]) for r in got["records"]]
    assert view == [(r["req_id"], r["reason"], r["verdict"], r["tenant"],
                     r["attempt"]) for r in want["records"]]
    assert [(l["signature"], l["req_ids"], l["b_pad"], l["reason"],
             l["tenants"]) for l in got["launch_log"]] == \
        [(l["signature"], l["req_ids"], l["b_pad"], l["reason"],
          l["tenants"]) for l in want["launch_log"]]
    for i, (g, w) in enumerate(zip(got["results"], want["results"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PATH_TOL,
                                   err_msg=f"request {i} ({ORDER[i]})")
    np.testing.assert_allclose(got["logliks"], want["logliks"], **PATH_TOL)
    assert set(got["per_tenant"]) == set(want["per_tenant"]) == set(ORDER)
    for tenant, digest in got["per_tenant"].items():
        assert digest["requests"] == want["per_tenant"][tenant]["requests"]
    assert got["compiles"] == want["compiles"]
    assert got["backend_choices"] == want["backend_choices"]


def test_no_launch_mixes_tenants(served):
    _, tserver, requests, _, got = served
    tenant_of = {i: t for i, (t, _) in enumerate(requests)}
    seen = set()
    for launch in got["launch_log"]:
        members = {tenant_of[i] for i in launch["req_ids"]}
        assert len(members) == 1 and launch["tenants"] == sorted(members)
        tenant = members.pop()
        assert launch["signature"][0] == tserver.servers[tenant].model_id
        assert "error" not in launch
        seen.add(tenant)
    assert seen == set(ORDER)
    for srv in tserver.servers.values():
        assert len(srv.signatures_seen) <= 2
        assert all(key[0].model_id == srv.model_id
                   for key in srv.signatures_seen)


def test_pendulum_tenant_long_tracks_match_jax():
    """The pendulum tenant's spec (SLR, cubature, no damping) at the
    stream's longest length, n = 512: the JAX package loses these tracks
    (state RMSE far above the noise), and the port's smoothed means equal
    JAX's, so a large pendulum RMSE on the card belongs to the reference
    configuration, not to the port."""
    sc = j_scenario("pendulum")
    model = sc.make_model(np.float64)
    xs, ys = (np.asarray(a) for a in jax.vmap(
        lambda k: sc.simulate(model, 512, k))(jnp.stack(
            [jax.random.PRNGKey(i) for i in range(2)])))
    jspec = jserve.TenantSpec.parse("pendulum:gold").smoother_spec(
        jserve.SmootherServeConfig())
    want = np.asarray(j_build(jspec).iterate(model, ys).mean)
    tspec = tserve.TenantSpec.parse("pendulum:gold").smoother_spec(
        tserve.SmootherServeConfig())
    assert tspec.spec_id == jspec.spec_id
    got = t_build(tspec, device="cpu").iterate(
        t_scenario("pendulum").make_model(torch.float64, "cpu"),
        torch.tensor(ys)).mean
    np.testing.assert_allclose(got.numpy(), want, **PATH_TOL)
    rmse = np.sqrt(np.mean((want[:, 1:] - xs[:, 1:]) ** 2, axis=(1, 2)))
    assert (rmse > 1.0).all(), rmse
