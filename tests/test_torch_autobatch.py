"""Port parity: the autobatching queue and its discrete-event service loop.

The fake-clock streams of the JAX package's queue tests go through both
packages' `AutobatchQueue` and `run_service` with one deterministic
executor: flush sequences, launch logs, per-request records and
`summarize_service` digests must be equal, value for value. Neither
module imports its framework, so nothing here needs torch or jax beyond
the import.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.launch import autobatch as jab
from repro.runtime import StepWatchdog as JWatchdog
from repro_torch.launch import autobatch as tab
from repro_torch.runtime import StepWatchdog as TWatchdog
from _torch_jax import release_jax_caches  # noqa: F401

PKGS = ((jab, JWatchdog), (tab, TWatchdog))


def _req(ab, i, n=10, nx=5, arrival=0.0, deadline=math.inf, model_id="",
         method="ekf", tenant="", priority=1):
    return ab.QueuedRequest(req_id=i, n=n, nx=nx, arrival=arrival,
                            deadline=deadline, model_id=model_id,
                            method=method, tenant=tenant, priority=priority)


def _flush_view(fl):
    return (fl.signature, [r.req_id for r in fl.requests], fl.b_pad,
            fl.reason, fl.at, fl.priority)


def test_constants_and_keys_match():
    for name in ("FLUSH_FULL", "FLUSH_DEADLINE", "FLUSH_MAX_WAIT",
                 "FLUSH_DRAIN", "VERDICT_OK", "VERDICT_RETRIED",
                 "VERDICT_FAILED", "VERDICT_DIVERGED", "VERDICT_SHED",
                 "_REASON_RANK", "SLO_CLASSES"):
        want, got = getattr(jab, name), getattr(tab, name)
        if name == "SLO_CLASSES":
            want = {k: dataclasses.astuple(v) for k, v in want.items()}
            got = {k: dataclasses.astuple(v) for k, v in got.items()}
        assert got == want, name
    assert dataclasses.astuple(tab.FlushPolicy()) == \
        dataclasses.astuple(jab.FlushPolicy())
    for n in (1, 2, 3, 9, 16, 17, 511, 512, 513):
        assert tab.next_pow2(n) == jab.next_pow2(n)
        for mb in (1, 4, 64):
            assert tab.pad_width(n, mb) == jab.pad_width(n, mb)
        assert tab.bucket_signature("m:1", "slr", n, 5) == \
            jab.bucket_signature("m:1", "slr", n, 5)
    for ab in (jab, tab):
        with pytest.raises(ValueError):
            ab.FlushPolicy(kind="eager")
        with pytest.raises(ValueError):
            ab.FlushPolicy(max_batch=0)
        with pytest.raises(ValueError):
            ab.FlushPolicy(shed_backlog_s=-1.0)


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_make_arrivals_match(kind):
    for seed in (0, 1, 7):
        np.testing.assert_array_equal(
            tab.make_arrivals(kind, 53, 12.5, burst_size=4, seed=seed),
            jab.make_arrivals(kind, 53, 12.5, burst_size=4, seed=seed))
    with pytest.raises(ValueError):
        tab.make_arrivals("adversarial", 10, 1.0)


def test_estimator_sequences_match():
    """One observe/estimate script (cold seeds, warmed seeds, EMA blends,
    width scaling and its tie-break, unseen signatures) on both."""
    sig = ("", "ekf", 16, 5)
    other = ("m:2", "ekf", 16, 5)
    script = [("obs", sig, 4, 10.0, False), ("est", sig, 4),
              ("obs", sig, 4, 0.1, False), ("est", sig, 4),
              ("obs", sig, 4, 0.3, False), ("est", sig, 8), ("est", sig, 2),
              ("obs", sig, 2, 0.1, True), ("obs", sig, 6, 0.6, True),
              ("est", sig, 4), ("est", sig, 5), ("est", other, 4),
              ("obs", other, 1, 0.05, True), ("obs", other, 1, 0.07, False),
              ("est", other, 1), ("est", other, 64)]
    outs = []
    for ab, _ in PKGS:
        est, out = ab.ComputeEstimator(alpha=0.4, default=0.123), []
        for step in script:
            if step[0] == "obs":
                est.observe(step[1], step[2], step[3], warmed=step[4])
            else:
                out.append(est.estimate(step[1], step[2]))
        outs.append(out)
    assert outs[0] == outs[1]


#: Queue scripts: (policy kwargs, [("submit", req kwargs, now) |
#: ("pop", now, drain) | ("due",)], estimator observations).
QUEUE_SCRIPTS = {
    "fill": (dict(kind="deadline", max_batch=4, max_wait=10.0),
             [("submit", dict(i=i), 0.0) for i in range(4)]
             + [("pop", 0.0, False)], []),
    "fill_keeps_remainder": (
        dict(kind="deadline", max_batch=2, max_wait=10.0),
        [("submit", dict(i=i, arrival=float(i)), float(i))
         for i in range(5)] + [("pop", 4.0, False), ("due",)], []),
    "deadline": (dict(kind="deadline", max_batch=8, max_wait=100.0,
                      slack=1.0),
                 [("submit", dict(i=0, deadline=1.0), 0.0), ("due",),
                  ("pop", 0.69, False), ("pop", 0.7, False)],
                 [(("", "ekf", 16, 5), 1, 0.3)]),
    "deadline_tightest": (
        dict(kind="deadline", max_batch=8, max_wait=100.0, slack=1.0),
        [("submit", dict(i=0, deadline=10.0), 0.0),
         ("submit", dict(i=1, arrival=0.1, deadline=0.5), 0.1), ("due",),
         ("pop", 0.4, False)], [(("", "ekf", 16, 5), 2, 0.1)]),
    "max_wait": (dict(kind="deadline", max_batch=8, max_wait=0.5),
                 [("submit", dict(i=0, arrival=1.0), 1.0), ("due",),
                  ("pop", 1.49, False), ("pop", 1.5, False)], []),
    "no_starvation": (
        dict(kind="deadline", max_batch=4, max_wait=0.2),
        [("submit", dict(i=99, n=100), 0.0)]
        + [("submit", dict(i=i, n=16, arrival=0.01), 0.01) for i in range(8)]
        + [("pop", 0.05, False), ("due",), ("pop", 0.2, False)], []),
    "static_fill_or_drain": (
        dict(kind="static", max_batch=3, max_wait=0.1),
        [("submit", dict(i=i, deadline=0.5), 0.0) for i in range(2)]
        + [("due",), ("pop", 1e9, False),
           ("submit", dict(i=2, arrival=1e9), 1e9), ("pop", 1e9, False),
           ("submit", dict(i=3, arrival=1e9), 1e9), ("pop", 1e9, True)], []),
    "tenants_never_mix": (
        dict(kind="static", max_batch=4),
        [("submit", dict(i=i, n=16, model_id="m:a", tenant="a"), 0.0)
         for i in range(3)]
        + [("submit", dict(i=10 + i, n=16, model_id="m:b", tenant="b"), 0.0)
           for i in range(3)]
        + [("submit", dict(i=20, n=16, model_id="m:a", method="slr",
                           tenant="a2"), 0.0), ("pop", 0.0, True)], []),
    "slo_priority": (
        dict(kind="deadline", max_batch=2, max_wait=10.0, slack=1.0),
        [("submit", dict(i=0, n=16, model_id="a"), 0.0),
         ("submit", dict(i=1, n=16, model_id="a"), 0.0),
         ("submit", dict(i=2, n=16, model_id="b", deadline=1.0), 0.0),
         ("submit", dict(i=3, n=16, model_id="c", deadline=1.0, priority=0),
          0.0), ("pop", 1.0, False)], []),
    "intra_bucket_fifo": (
        dict(kind="deadline", max_batch=2, max_wait=0.5),
        [("submit", dict(i=i, n=16), 0.0) for i in range(3)]
        + [("pop", 0.5, False)], []),
}


@pytest.mark.parametrize("name", sorted(QUEUE_SCRIPTS))
def test_queue_scripts_match(name):
    pol_kw, script, observations = QUEUE_SCRIPTS[name]
    outs = []
    for ab, _ in PKGS:
        est = ab.ComputeEstimator(alpha=1.0)
        for sig, b, dt in observations:
            est.observe(sig, b, dt)
        q = ab.AutobatchQueue(ab.FlushPolicy(**pol_kw), est)
        out = []
        for step in script:
            if step[0] == "submit":
                q.submit(_req(ab, **step[1]), now=step[2])
            elif step[0] == "pop":
                out.append([_flush_view(f) for f in
                            q.pop_ready(now=step[1], drain=step[2])])
            else:
                out.append(q.next_due())
            out.append(q.pending())
        outs.append(out)
    assert outs[0] == outs[1]
    assert any(outs[0][i] for i in range(0, len(outs[0]), 2))


def _retry_to(model_id):
    return lambda r: dataclasses.replace(r, model_id=model_id,
                                         attempt=r.attempt + 1)


def _fail_on(model_id, dt_fail, dt_ok):
    def execute(fl):
        if fl.signature[0] == model_id:
            return dt_fail, {r.req_id: "failed" for r in fl.requests}
        return dt_ok, {}
    return execute


def _raise(fl):
    raise RuntimeError("injected")


def _straggle(fl):
    rid = fl.requests[0].req_id
    if rid == 3:
        raise RuntimeError("boom")
    return {0: 0.1, 1: 4.0, 2: 0.1}[rid], {}


def _mixed_stream():
    """A 40-request Poisson stream over three models, two methods, three
    SLO classes and deadlines, with failures and shed-able batch work."""
    rng = np.random.default_rng(3)
    arrivals = jab.make_arrivals("poisson", 40, 20.0, seed=3)
    reqs = []
    for i, t in enumerate(arrivals):
        prio = int(rng.integers(3))
        reqs.append(dict(i=i, n=int(rng.choice([8, 12, 30, 64])),
                         arrival=float(t),
                         deadline=(math.inf if prio == 2
                                   else float(t) + [0.5, 2.0][prio]),
                         model_id=["m:a", "m:b", "m:c"][i % 3],
                         method="slr" if i % 5 == 0 else "ekf",
                         tenant=["a", "b", "c"][i % 3], priority=prio))
    return reqs


def _mixed_execute(fl):
    """Deterministic compute: grows with width and length; every 7th
    request fails once, and retried ones succeed."""
    dt = 0.01 * fl.b_pad + 0.001 * fl.signature[2]
    return dt, {r.req_id: "failed" for r in fl.requests
                if r.req_id % 7 == 0 and r.attempt == 0}


#: Service streams: (policy kwargs, requests, execute, retry, watchdog?).
STREAMS = {
    "latency_accounting": (
        dict(kind="deadline", max_batch=2, max_wait=0.5),
        [dict(i=0), dict(i=1), dict(i=2, arrival=0.1)],
        lambda fl: 0.25, None, False),
    "backlog_serializes": (
        dict(kind="deadline", max_batch=2, max_wait=0.1),
        [dict(i=0, n=8), dict(i=1, n=100)], lambda fl: 1.0, None, False),
    "static_drain": (dict(kind="static", max_batch=8),
                     [dict(i=i, arrival=0.1 * i) for i in range(3)],
                     lambda fl: 0.01, None, False),
    "multi_tenant": (
        dict(kind="deadline", max_batch=2, max_wait=0.1),
        [dict(i=0, n=8, model_id="a", tenant="a"),
         dict(i=1, n=8, model_id="b", tenant="b"),
         dict(i=2, n=8, model_id="b", tenant="b")],
        lambda fl: 0.05, None, False),
    "retry_reroutes_once": (
        dict(kind="static", max_batch=1), [dict(i=0, model_id="m")],
        _fail_on("m", 0.2, 0.3), "m#retry", False),
    "failed_without_retry": (
        dict(kind="static", max_batch=1), [dict(i=0)],
        lambda fl: (0.1, {0: "failed"}), None, False),
    "retry_bounded": (
        dict(kind="static", max_batch=1), [dict(i=0, model_id="m")],
        lambda fl: (0.1, {0: "failed"}), "m#retry", False),
    "exception_contained": (
        dict(kind="static", max_batch=2), [dict(i=0), dict(i=1)], _raise,
        None, False),
    "shed_under_backlog": (
        dict(kind="deadline", max_batch=1, max_wait=0.1, shed_backlog_s=0.5,
             shed_priority=2),
        [dict(i=0, priority=0), dict(i=1, n=100, arrival=0.2, priority=2),
         dict(i=2, n=200, arrival=0.2, priority=0)],
        lambda fl: 5.0, None, False),
    "stragglers_and_errors": (
        dict(kind="static", max_batch=1),
        [dict(i=i, n=10 * (i + 1) ** 2) for i in range(4)], _straggle,
        None, True),
    "goodput": (
        dict(kind="static", max_batch=1),
        [dict(i=0, deadline=1.0), dict(i=1, deadline=0.05),
         dict(i=2, arrival=0.5)],
        lambda fl: (0.2, {2: "failed"}), None, False),
    "mixed_deadline": (
        dict(kind="deadline", max_batch=8, max_wait=1.0, slack=1.25),
        _mixed_stream(), _mixed_execute, "#retry", True),
    "mixed_static_shedding": (
        dict(kind="static", max_batch=4, shed_backlog_s=0.02,
             shed_priority=2),
        _mixed_stream(), _mixed_execute, "#retry", True),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_run_service_streams_match(name):
    pol_kw, reqs, execute, retry, watch = STREAMS[name]
    outs = []
    for ab, watchdog in PKGS:
        kw = {}
        if retry is not None:
            kw["retry"] = _retry_to(retry)
        if watch:
            kw["watchdog"] = watchdog(threshold=2.0, warmup_steps=1)
        service = ab.run_service([_req(ab, **r) for r in reqs], execute,
                                 ab.FlushPolicy(**pol_kw),
                                 ab.ComputeEstimator(alpha=1.0), **kw)
        outs.append((service, ab.summarize_service(service)))
    (jsvc, jsum), (tsvc, tsum) = outs
    assert tsvc["launches"] == jsvc["launches"]
    assert tsvc["records"] == jsvc["records"]
    assert tsum == jsum
    assert len(tsvc["records"]) == len(reqs)


def test_run_service_absorbs_only_the_listed_exceptions():
    """``absorb`` narrows the fault boundary: a listed exception is
    recorded on the launch as the JAX package records every one, any
    other propagates (the port's service absorbs only injected faults)."""
    reqs = [_req(tab, 0), _req(tab, 1)]
    policy = tab.FlushPolicy(kind="static", max_batch=2)
    svc = tab.run_service(reqs, _raise, policy, absorb=(RuntimeError,))
    assert svc["launches"][0]["error"] == "RuntimeError: injected"
    assert {r["verdict"] for r in svc["records"]} == {"diverged"}
    with pytest.raises(RuntimeError, match="injected"):
        tab.run_service(reqs, _raise, policy, absorb=(KeyError,))
