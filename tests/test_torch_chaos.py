"""Port parity: the fault-injection harness and the fault-tolerance runtime.

Both packages' `ChaosInjector`s, seeded alike, must corrupt the same
requests at the same steps with the same values (the port takes tensors
and clones what it corrupts; the reference takes numpy arrays), raise
their transient errors on the same flushes and inflate the same
stragglers. `StepWatchdog` and `with_retries` must report and retry
alike on the same duration and failure scripts.
"""
import types

import numpy as np
import pytest
import torch

from repro.launch import chaos as jchaos
from repro.runtime import fault as jfault
from repro_torch.launch import chaos as tchaos
from repro_torch.runtime import fault as tfault
from _torch_jax import release_jax_caches  # noqa: F401


def _payloads(count, n, ny, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, ny)) for _ in range(count)]


@pytest.mark.parametrize("cfg", [
    dict(seed=5, nan_rate=0.2),
    dict(seed=0, outlier_rate=0.3, outlier_scale=1e6),
    dict(seed=11, nan_rate=0.15, outlier_rate=0.2, outlier_scale=1e3),
], ids=["nan", "outlier", "mixed"])
@pytest.mark.parametrize("pairs", [False, True], ids=["ys", "tenant_pairs"])
def test_corrupt_requests_matches_reference(cfg, pairs):
    reqs = _payloads(60, 12, 2, seed=1)
    wrap = (lambda i, y: (f"t{i % 3}", y)) if pairs else (lambda i, y: y)
    jout, jfaults = jchaos.ChaosInjector(jchaos.ChaosConfig(**cfg)) \
        .corrupt_requests([wrap(i, y) for i, y in enumerate(reqs)])
    treqs = [wrap(i, torch.tensor(y)) for i, y in enumerate(reqs)]
    originals = [torch.tensor(y) for y in reqs]
    tout, tfaults = tchaos.ChaosInjector(tchaos.ChaosConfig(**cfg)) \
        .corrupt_requests(treqs)
    assert tfaults == jfaults and len(tfaults) > 0
    for i, (j, t) in enumerate(zip(jout, tout)):
        if pairs:
            assert t[0] == j[0] == f"t{i % 3}"
            j, t = j[1], t[1]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        original = treqs[i][1] if pairs else treqs[i]
        if i in tfaults:
            assert t is not original          # a clone was corrupted
        else:
            assert t is original              # untouched: the same tensor
        # The caller's tensors are never written.
        assert torch.equal(original, originals[i])


def _flush(sig="s", at=0.0, req_ids=(0,)):
    return types.SimpleNamespace(
        signature=sig, at=at,
        requests=[types.SimpleNamespace(req_id=r) for r in req_ids])


def _drive(chaos_mod, cfg, flushes):
    """Run flush identities through a wrapped executor with one in-place
    retry: the log of raises, calls and reported seconds."""
    from repro.runtime import with_retries as jretries
    from repro_torch.runtime import with_retries as tretries

    inj = chaos_mod.ChaosInjector(chaos_mod.ChaosConfig(**cfg))
    calls, events = [], []

    def execute(fl):
        calls.append((fl.signature, fl.at))
        return 0.5 + fl.at, {r.req_id: "ok" for r in fl.requests}

    retries = jretries if chaos_mod is jchaos else tretries
    fn = retries(inj.wrap_execute(execute), max_retries=1,
                 retry_on=(chaos_mod.TransientComputeError,),
                 on_retry=lambda a, e: events.append(("retry", a, str(e))))
    for fl in flushes:
        events.append(fn(fl))
    return calls, events, inj.log, inj.summary()


def test_wrap_execute_matches_reference():
    flushes = [_flush(sig=f"s{k % 4}", at=0.1 * k, req_ids=(k, k + 1))
               for k in range(40)]
    cfg = dict(seed=3, exception_rate=0.3, straggler_rate=0.25,
               straggler_factor=4.0)
    want = _drive(jchaos, cfg, flushes)
    got = _drive(tchaos, cfg, flushes)
    assert got == want
    assert got[2]["exceptions"] > 0 and got[2]["stragglers"] > 0


def test_wrap_execute_raises_once_per_flush_identity():
    for mod in (jchaos, tchaos):
        inj = mod.ChaosInjector(mod.ChaosConfig(seed=0, exception_rate=1.0))
        calls = []
        chaotic = inj.wrap_execute(
            lambda fl: calls.append(fl.signature) or (0.25, {0: "ok"}))
        with pytest.raises(mod.TransientComputeError):
            chaotic(_flush())
        assert calls == []                    # the fault precedes any work
        assert chaotic(_flush()) == (0.25, {0: "ok"})
        with pytest.raises(mod.TransientComputeError):
            chaotic(_flush(sig="other"))
        # Legacy float-returning executors are normalized.
        inj = mod.ChaosInjector(mod.ChaosConfig(seed=0, straggler_rate=1.0))
        assert inj.wrap_execute(lambda fl: 0.5)(_flush()) == (2.0, {})


def test_chaos_config_matches_reference():
    for bad in (dict(nan_rate=1.5), dict(exception_rate=-0.1),
                dict(straggler_factor=0.5)):
        for mod in (jchaos, tchaos):
            with pytest.raises(ValueError):
                mod.ChaosConfig(**bad)
    for rate, seed in ((0.1, 0), (0.25, 3)):
        j = jchaos.ChaosConfig.at_rate(rate, seed=seed)
        t = tchaos.ChaosConfig.at_rate(rate, seed=seed)
        assert vars(t) == vars(j) and t.active == j.active
    assert not tchaos.ChaosConfig().active


@pytest.mark.parametrize("kw", [dict(), dict(threshold=1.5, ema_decay=0.5,
                                             warmup_steps=1)])
def test_step_watchdog_matches_reference(kw):
    durations = [0.1, 0.11, 0.09, 0.5, 0.1, 0.12, 0.4, 0.1, 0.08, 1.0,
                 0.1, 0.3]
    out = []
    for mod in (jfault, tfault):
        w = mod.StepWatchdog(**kw)
        reports = [w.observe(i, d) for i, d in enumerate(durations)]
        out.append(([None if r is None else vars(r) for r in reports],
                    [vars(r) for r in w.reports]))
    assert out[0] == out[1]
    assert any(r is not None for r in out[1][0])


@pytest.mark.parametrize("fails", [0, 1, 2, 3])
def test_with_retries_matches_reference(fails):
    """A step that fails ``fails`` times: retried up to twice, then the
    last error is raised; other exception types are never retried."""
    out = []
    for mod in (jfault, tfault):
        attempts, seen = [], []

        def step(x):
            attempts.append(x)
            if len(attempts) <= fails:
                raise RuntimeError(f"transient {len(attempts)}")
            return 2 * x

        fn = mod.with_retries(step, max_retries=2,
                              on_retry=lambda a, e: seen.append((a, str(e))))
        try:
            res = fn(21)
        except RuntimeError as e:
            res = f"raised {e}"
        out.append((res, attempts, seen))
    assert out[0] == out[1]
    for mod in (jfault, tfault):
        fn = mod.with_retries(lambda: 1 / 0, retry_on=(RuntimeError,))
        with pytest.raises(ZeroDivisionError):
            fn()
