"""Port parity: the streaming smoother service (`serve_stream`), its retry
lane, sequential fallback and fault injection.

One small bursty stream of JAX-simulated coordinated-turn requests (numpy
across) goes through the JAX `SmootherServer.serve_stream` and the
port's, on the CPU, under the static policy (whose flushes do not depend
on measured time), without and with the seeded fault mix. Per request:
equal verdicts, and means and log-likelihoods within the iterated-path
tolerance (rtol=1e-7, atol=1e-8). Under chaos the port must also keep
healthy requests bit-identical to its own fault-free run and return no
NaN. Under the deadline policy the flush composition follows measured
time, so those results are held against the one-shot run only.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import autobatch as jab
from repro.launch import chaos as jchaos
from repro.launch import serve as jserve
from repro.scenarios import get_scenario as j_scenario
from repro_torch import convert
from repro_torch.launch import autobatch as tab
from repro_torch.launch import chaos as tchaos
from repro_torch.launch import serve as tserve
from repro_torch.scenarios import get_scenario as t_scenario
from _torch_jax import release_jax_caches  # noqa: F401

PATH_TOL = dict(rtol=1e-7, atol=1e-8)
#: One time bucket (n_pad 16), widths 1, 2 and 4.
LENGTHS = [16, 12, 10, 16, 9, 14, 16, 11, 13, 16]
CFG = dict(requests=len(LENGTHS), n=16, max_batch=4, n_iter=2, tol=1e-6,
           vary_lengths=False, arrival="bursty", policy="static", rate=32.0,
           burst_size=4, deadline_s=0.5, max_wait_s=0.05)
CHAOS = dict(seed=2, nan_rate=0.25, exception_rate=0.5, straggler_rate=0.5)


def _quiet(*_a, **_k):
    return None


@pytest.fixture(scope="module")
def jax_side():
    """The JAX server's fault-free and chaos streams and one-shot run.
    The requests are prefixes of ten n=16 simulations (one vmapped
    call). Both autotune caches start empty, so the streams'
    ``backend_choices`` hold this module's shapes only."""
    from repro.kernels.kalman_combine import autotune as jat
    from repro_torch.kernels.kalman_combine import autotune as tat

    jat.clear_cache()
    tat.clear_cache()
    sc = j_scenario("coordinated_turn")
    model = sc.make_model(jnp.float64)
    keys = jnp.stack([jax.random.PRNGKey(100 + i)
                      for i in range(len(LENGTHS))])
    ys = np.asarray(jax.vmap(lambda k: sc.simulate(model, 16, k)[1])(keys))
    requests = [ys[i, :n] for i, n in enumerate(LENGTHS)]
    arrivals = jab.make_arrivals("bursty", len(LENGTHS), CFG["rate"],
                                 CFG["burst_size"], seed=0)
    cfg = jserve.SmootherServeConfig(**CFG)
    server = jserve.SmootherServer(model, cfg, spec=sc.default_spec(
        n_iter=cfg.n_iter, tol=cfg.tol))
    policy = jab.FlushPolicy(kind="static", max_batch=cfg.max_batch)
    clean = server.serve_stream(requests, arrivals, emit=_quiet,
                                policy=policy)
    faulty = server.serve_stream(requests, arrivals, emit=_quiet,
                                 policy=policy,
                                 chaos=jchaos.ChaosConfig(**CHAOS))
    oneshot = server.serve_requests(requests, emit=_quiet)
    return model, requests, arrivals, server, clean, faulty, oneshot


@pytest.fixture(scope="module")
def torch_side(jax_side):
    jmodel, requests, arrivals = jax_side[:3]
    model = convert.state_space_model(
        "coordinated_turn", *(np.asarray(getattr(jmodel, k))
                              for k in ("Q", "R", "m0", "P0")),
        device="cpu")
    cfg = tserve.SmootherServeConfig(**CFG)
    server = tserve.SmootherServer(
        model, cfg, spec=t_scenario("coordinated_turn").default_spec(
            n_iter=cfg.n_iter, tol=cfg.tol), device="cpu")
    treqs = [torch.tensor(r) for r in requests]
    policy = tab.FlushPolicy(kind="static", max_batch=cfg.max_batch)
    clean = server.serve_stream(treqs, arrivals, emit=_quiet, policy=policy)
    faulty = server.serve_stream(treqs, arrivals, emit=_quiet, policy=policy,
                                 chaos=tchaos.ChaosConfig(**CHAOS))
    return server, treqs, clean, faulty


def _verdicts(stats):
    return {r["req_id"]: r["verdict"] for r in stats["records"]}


def _record_view(stats):
    """The records without their measured times, in completion order."""
    return [(r["req_id"], r["reason"], r["verdict"], r["attempt"],
             r["tenant"], r["arrival"]) for r in stats["records"]]


def _check_results(got, want):
    assert len(got["results"]) == len(want["results"])
    for i, (g, w) in enumerate(zip(got["results"], want["results"])):
        assert tuple(g.shape) == np.asarray(w).shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PATH_TOL,
                                   err_msg=f"request {i}")
    np.testing.assert_allclose(np.asarray(got["logliks"], float),
                               np.asarray(want["logliks"], float),
                               **PATH_TOL)


def test_routing_ids_match_jax(jax_side, torch_side):
    jserver = jax_side[3]
    tserver = torch_side[0]
    assert tserver.model_id == jserver.model_id
    assert tserver.retry_model_id == jserver.retry_model_id
    assert tserver.retry_model_id != tserver.model_id
    assert tserver.queue_signature(12) == jserver.queue_signature(12)
    assert tserver._fallback_smoother.spec_id == \
        jserver._fallback_smoother.spec_id


def test_clean_stream_matches_jax(jax_side, torch_side):
    want = jax_side[4]
    got = torch_side[2]
    assert _verdicts(got) == _verdicts(want)
    assert set(_verdicts(got).values()) == {"ok"}
    _check_results(got, want)
    assert _record_view(got) == _record_view(want)
    for key in ("requests", "launches", "flush_reasons", "verdicts",
                "occupancy", "mean_iterations", "compiles"):
        assert got[key] == want[key], key
    # Warmup autotuned every bucket shape under backend="auto": on the
    # CPU the choices are "fused", under the JAX package's keys.
    assert got["backend_choices"] == want["backend_choices"]
    assert set(got["backend_choices"].values()) == {"fused"}
    assert len(got["backend_choices"]) >= 3


def test_chaos_stream_matches_jax(jax_side, torch_side):
    want = jax_side[5]
    got = torch_side[3]
    assert got["chaos"]["corrupted_requests"] == \
        want["chaos"]["corrupted_requests"]
    for key in ("fault_kinds", "exceptions", "stragglers", "config"):
        assert got["chaos"][key] == want["chaos"][key], key
    assert got["chaos"]["exceptions"] >= 1 and got["chaos"]["stragglers"] >= 1
    assert _verdicts(got) == _verdicts(want)
    assert got["verdicts"] == want["verdicts"]
    assert _record_view(got) == _record_view(want)
    _check_results(got, want)


def test_chaos_gives_every_fault_a_verdict_and_keeps_healthy_bits(
        torch_side):
    _, _, clean, faulty = torch_side
    corrupted = set(faulty["chaos"]["corrupted_requests"])
    assert corrupted
    verdicts = _verdicts(faulty)
    for idx in corrupted:
        assert verdicts[idx] in ("diverged", "retried", "shed")
    ok = [i for i, v in verdicts.items() if v == "ok"]
    assert ok
    for i in ok:
        assert torch.equal(faulty["results"][i], clean["results"][i])
        assert faulty["logliks"][i] == clean["logliks"][i]
    for i, mean in enumerate(faulty["results"]):
        assert mean is not None and bool(torch.isfinite(mean).all()), i
    assert not any("error" in l for l in clean["launch_log"])


def test_deadline_stream_matches_oneshot(jax_side, torch_side):
    """Deadline policy with measured compute: the flushes may differ from
    run to run, the results may not (held against the JAX one-shot run)."""
    server, treqs = torch_side[:2]
    oneshot = jax_side[6]
    arrivals = np.linspace(0.0, 0.2, len(treqs))
    stats = server.serve_stream(
        treqs, arrivals, emit=_quiet,
        policy=tab.FlushPolicy(kind="deadline", max_batch=4, max_wait=0.05))
    assert set(_verdicts(stats).values()) == {"ok"}
    _check_results(stats, oneshot)
    assert stats["launches"] >= 3 and stats["flush_reasons"]
    assert 0.0 <= stats["deadline_hit_rate"] <= 1.0
    assert stats["latency_p95_s"] > 0.0


def test_stream_raises_an_exception_chaos_did_not_inject(torch_side,
                                                         monkeypatch):
    """The port's queue absorbs only injected transient faults: any other
    executor exception leaves `serve_stream` instead of coming back as
    retried requests (the JAX service records it on the launch)."""
    server, treqs = torch_side[:2]
    arrivals = np.zeros(2)

    def broken(*_a, **_k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(server, "smooth_batch", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        server.serve_stream(treqs[:2], arrivals, emit=_quiet,
                            policy=tab.FlushPolicy(kind="static",
                                                   max_batch=4))


def test_run_flush_routes_retry_lane_and_falls_back(torch_side):
    """A NaN request on the retry lane fails again and runs the sequential
    fallback inline: verdict diverged, a finite frozen mean."""
    server, treqs = torch_side[:2]
    bad = treqs[0].clone()
    bad[3] = float("nan")
    req = tab.QueuedRequest(req_id=0, n=len(bad), nx=5, arrival=0.0,
                            payload=bad, model_id=server.model_id)
    retry = server.retry_request(req)
    assert retry.attempt == 1 and retry.model_id == server.retry_model_id
    for r, verdict in ((req, "failed"), (retry, "diverged")):
        fl = tab.BucketFlush(signature=r.signature, requests=[r], b_pad=1,
                             reason="drain", at=0.0)
        dt, outcomes, store, iters = server.run_flush(fl)
        assert outcomes == {0: verdict} and dt > 0.0
    mean = store[0][0]
    assert tuple(mean.shape) == (len(bad) + 1, 5)
    assert bool(torch.isfinite(mean).all())


@pytest.mark.parametrize("args,line", [
    (["--arrival", "poisson", "--policy", "deadline"],
     "[serve/smoother/deadline]"),
    (["--arrival", "poisson", "--policy", "deadline", "--tenants",
      "coordinated_turn,pendulum:gold"], "[serve/smoother/mt/deadline]"),
    (["--arrival", "bursty", "--chaos", "0.25"], "[serve/chaos]"),
], ids=["deadline", "tenants", "chaos"])
def test_streaming_cli_on_cpu(capsys, args, line):
    tserve.main(["--workload", "smoother", "--requests", "4", "--n", "8",
                 "--max-batch", "2", "--iters", "2", "--device", "cpu"]
                + args)
    out = capsys.readouterr().out
    assert line in out


def test_cli_rejects_chaos_without_a_stream():
    with pytest.raises(SystemExit):
        tserve.main(["--arrival", "none", "--chaos", "0.1", "--device",
                     "cpu"])
