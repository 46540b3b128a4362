"""Port parity: the measured kernel-vs-plain chooser behind
``backend="auto"``.

`IteratedConfig.resolved_combine_impl` must give the JAX package's answer
for every (``combine_impl``, ``backend``, batched, cache state); on the CPU
`autotune` times nothing and records ``"fused"`` under the JAX package's
own cache keys; ``autotune_for`` measures once per shape; the measured
choice is the faster candidate; an ``"auto"`` call site runs what the
cache says, and an unmeasured one the kernel on a CUDA device. On the
card, an ``"auto"`` call launches the combine kernels if and only if the
measured choice is ``"pallas"``, and at an unmeasured shape (those tests
skip here;
JAX is imported lazily, so it also runs where JAX is absent).
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import api as tapi
from repro_torch.core import iterated as tit
from repro_torch.core import parallel as tparallel
from repro_torch.kernels.kalman_combine import autotune as tat
from repro_torch.kernels.kalman_combine import ops as tops
from repro_torch.scenarios import get_scenario as t_scenario
from repro_torch.scenarios import simulate_trajectory
from _torch_jax import release_jax_caches  # noqa: F401

SHAPE = (4, 16, 5)
PATH_TOL = dict(rtol=1e-7, atol=1e-8)


def jax_mods():
    """The JAX package's api, iterated and autotune modules."""
    from repro.core import api as japi
    from repro.core import iterated as jit
    from repro.kernels.kalman_combine import autotune as jat

    return japi, jit, jat


@pytest.fixture
def jat():
    """The JAX autotuner with an empty cache (the port's too)."""
    jat = jax_mods()[2]
    jat.clear_cache()
    tat.clear_cache()
    yield jat
    jat.clear_cache()


@pytest.fixture(autouse=True)
def clear_port_cache():
    tat.clear_cache()
    yield
    tat.clear_cache()


def _entry(choice):
    return {"choice": choice, "backend": "gpu", "kernel_us": 1.0,
            "fused_us": 2.0}


@pytest.mark.parametrize("cache", [None, "pallas", "fused"])
def test_resolution_table_matches_jax(jat, cache):
    """Every valid (combine_impl, backend, batched, shape) under one cache
    state: an empty cache, or one whose entry for SHAPE says pallas or
    fused (put in both packages' caches under their own keys)."""
    jit = jax_mods()[1]
    model_id = "coordinated_turn/abc123"
    if cache is not None:
        jat._cache[jat.cache_key(model_id, *SHAPE)] = _entry(cache)
        tat._cache[tat.cache_key(model_id, *SHAPE, device="cpu")] = \
            _entry(cache)
    rows = 0
    for impl, backend, batched, shape in itertools.product(
            tit.COMBINE_IMPLS, tit.BACKENDS, (False, True),
            (None, SHAPE, (8, 16, 5))):
        if impl == "pallas" and backend == "jnp":
            for mod in (jit, tit):
                with pytest.raises(ValueError):
                    mod.IteratedConfig(combine_impl=impl, backend=backend)
            continue
        kw = dict(combine_impl=impl, backend=backend, model_id=model_id)
        want = jit.IteratedConfig(**kw).resolved_combine_impl(batched, shape)
        got = tit.IteratedConfig(**kw).resolved_combine_impl(
            batched, shape, device="cpu")
        assert got == want, (impl, backend, batched, shape)
        rows += 1
    assert rows == 3 * 4 * 2 * 3 + 3 * 2 * 3


def test_unmeasured_site_runs_the_kernel_on_a_cuda_device():
    """Where the JAX package runs "fused" at every unmeasured site, the
    port runs the kernel on a CUDA device (it runs plain PyTorch on the
    card only where a measurement chose it) and "fused" on the CPU. The
    lookup needs no card: it reads the device's type."""
    cfg = tit.IteratedConfig(model_id="m/1", backend="auto")
    for shape in (None, SHAPE):
        assert cfg.resolved_combine_impl(True, shape, device="cuda") == \
            "pallas"
        assert cfg.resolved_combine_impl(True, shape, device="cpu") == \
            "fused"
    assert cfg.resolved_combine_impl(False, SHAPE, device="cuda") == "jnp"
    assert tat.decide("m/1", *SHAPE, device="cuda") == tat.CHOICE_KERNEL
    assert tat.decide("m/1", None, None, None, device="cuda") == \
        tat.CHOICE_KERNEL
    tat._cache[tat.cache_key("m/1", *SHAPE, device="cuda")] = \
        _entry("fused")
    assert cfg.resolved_combine_impl(True, SHAPE, device="cuda") == "fused"
    assert tat.decide("m/1", *SHAPE, device="cpu") == tat.CHOICE_FUSED


def test_cache_key_and_bucket_key_match_jax(jat):
    jit = jax_mods()[1]
    jcfg = jit.IteratedConfig(model_id="m/1", backend="auto")
    tcfg = tit.IteratedConfig(model_id="m/1", backend="auto")
    assert tat.cache_key("m/1", 4, 16, 5, device="cpu") == \
        jat.cache_key("m/1", 4, 16, 5)
    assert tcfg.cache_key(16, 4, 5)[1:] == jcfg.cache_key(16, 4, 5)[1:]
    assert tcfg.cache_key(16, 4, 5) == tcfg.cache_key(16, 4, 5)
    assert tcfg.cache_key(16, 4, 5) != tit.IteratedConfig(
        model_id="m/2").cache_key(16, 4, 5)
    assert tops.kernel_backend("cpu") is None
    assert tops.kernel_backend(torch.device("cuda")) == "gpu"
    assert tat.CHOICE_KERNEL == jat.CHOICE_KERNEL == "pallas"
    assert tat.CHOICE_FUSED == jat.CHOICE_FUSED == "fused"
    assert tat._REPS == jat._REPS


def test_cpu_autotune_times_nothing_and_keys_match_jax(jat, monkeypatch):
    """On the CPU nothing is timed: every entry is the plain version with
    no times, under the JAX package's keys (same spec_id, "cpu")."""
    japi = jax_mods()[0]
    monkeypatch.setattr(tat, "_time_us", lambda *a: pytest.fail("timed"))
    spec = dict(linearization="taylor", n_iter=3, tol=1e-6, lm_lambda=1.0,
                model_id="coordinated_turn:x")
    for shape in ((1, 256, 5), (64, 512, 5), (2, 16, 4)):
        want = japi.build_smoother(japi.SmootherSpec(**spec),
                                   autotune_for=shape)
        got = tapi.build_smoother(tapi.SmootherSpec(**spec), device="cpu",
                                  autotune_for=shape)
        assert got.spec_id == want.spec_id
    assert tat.cache_entries() == jat.cache_entries()
    assert len(tat.cache_entries()) == 3
    for entry in tat.cache_entries().values():
        assert entry == {"choice": "fused", "backend": "none",
                         "kernel_us": None, "fused_us": None}
    assert all("@cpu/" in k for k in tat.cache_entries())


def test_autotune_for_is_idempotent(monkeypatch):
    """A second build for the same shape hits the cache: the same entry,
    nothing measured again; a new shape adds one entry."""
    timed = []
    monkeypatch.setattr(tops, "kernel_backend", lambda device=None: "gpu")
    monkeypatch.setattr(tat, "_time_us", lambda fn, ei, ej: timed.append(
        (fn.__name__, tuple(ei.b.shape))) or 5.0)
    spec = tapi.SmootherSpec(n_iter=2)
    first = tapi.build_smoother(spec, device="cpu", autotune_for=SHAPE)
    entry = tat.lookup(spec.spec_id, *SHAPE, device="cpu")
    again = tapi.build_smoother(spec, device="cpu", autotune_for=SHAPE)
    assert tat.lookup(spec.spec_id, *SHAPE, device="cpu") is entry
    assert again.autotune(*SHAPE) is entry is first.autotune(*SHAPE)
    # The probe: the top level's [B, T // 2] pair grid, kernel then plain.
    assert timed == [("filtering_combine_cuda", (4, 8, 5)),
                     ("filtering_combine_plain", (4, 8, 5))]
    tapi.build_smoother(spec, device="cpu", autotune_for=(8, 16, 5))
    assert len(tat.cache_entries()) == 2 and len(timed) == 4


@pytest.mark.parametrize("kernel_us,fused_us,choice", [
    (3.0, 9.0, "pallas"), (9.0, 3.0, "fused"), (4.0, 4.0, "fused")])
def test_choice_is_the_faster_candidate(monkeypatch, kernel_us, fused_us,
                                        choice):
    times = {"filtering_combine_cuda": kernel_us,
             "filtering_combine_plain": fused_us}
    monkeypatch.setattr(tops, "kernel_backend", lambda device=None: "gpu")
    monkeypatch.setattr(tat, "_time_us", lambda fn, ei, ej: times[fn.__name__])
    entry = tat.autotune("s/1", *SHAPE, device="cpu")
    assert entry == {"choice": choice, "backend": "gpu",
                     "kernel_us": kernel_us, "fused_us": fused_us}
    assert tat.decide("s/1", *SHAPE, device="cpu") == choice
    # Unmeasured sites on this (patched) card platform run the kernel.
    assert tat.decide("s/1", None, 16, 5, device="cpu") == "pallas"
    assert tat.decide("s/2", *SHAPE, device="cpu") == "pallas"


def test_probe_elements_follow_the_reference_stream(jat):
    """The probe operand is the JAX package's numpy draw, laid out as a
    [B, T // 2] pair grid."""
    j = jat._level_elements(4 * 8, 5, np.float32)
    t = tat._level_elements(4, 8, 5, torch.float32, torch.device("cpu"))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(
            b.reshape((32,) + tuple(b.shape[2:])).numpy(), np.asarray(a))


def _record_impls(monkeypatch):
    seen = []
    orig = tparallel._parallel_filter_smoother_batched

    def recorder(*args, combine_impl, **kw):
        seen.append(combine_impl)
        return orig(*args, combine_impl=combine_impl, **kw)

    monkeypatch.setattr(tparallel, "_parallel_filter_smoother_batched",
                        recorder)
    return seen


def test_auto_call_site_runs_what_the_cache_says(monkeypatch):
    """``iterate`` and ``smooth`` under ``backend="auto"`` on the CPU pass
    the scan "fused" at an unmeasured shape and "pallas" where the cache
    says so (on CPU tensors the kernel wrappers run the plain version, so the
    means agree)."""
    seen = _record_impls(monkeypatch)
    model = t_scenario("coordinated_turn").make_model(torch.float64, "cpu")
    gen = torch.Generator().manual_seed(0)
    _, ys = simulate_trajectory(model, SHAPE[1], gen, batch=(SHAPE[0],))
    smoother = tapi.build_smoother(n_iter=2, lm_lambda=1.0, device="cpu")
    plain = smoother.iterate(model, ys)
    assert set(seen) == {"fused"}
    tat._cache[tat.cache_key(smoother.spec_id, *SHAPE, device="cpu")] = \
        _entry("pallas")
    seen.clear()
    kernel = smoother.iterate(model, ys)
    assert set(seen) == {"pallas"} and len(seen) == 2
    np.testing.assert_allclose(kernel.mean.numpy(), plain.mean.numpy(),
                               **PATH_TOL)
    # Another shape of the same spec stays unmeasured.
    seen.clear()
    smoother.iterate(model, ys[:2])
    assert set(seen) == {"fused"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_unmeasured_auto_call_launches_kernels_on_card(cuda):
    """On the card an ``"auto"`` pass at a shape nothing measured launches
    both combine kernels."""
    from repro_torch.kernels.kalman_combine import kalman_combine as kc

    model = t_scenario("coordinated_turn").make_model(torch.float64, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    _, ys = simulate_trajectory(model, 64, gen, batch=(3,))
    smoother = tapi.build_smoother(n_iter=1, lm_lambda=1.0, device=cuda)
    assert tat.lookup(smoother.spec_id, 3, 64, 5, device=cuda) is None
    kc.reset_launch_counts()
    smoother.iterate(model, ys)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["filtering_combine"] > 0
    assert kc.LAUNCHES["smoothing_combine"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 256), (64, 512)])
def test_auto_call_launches_kernels_iff_choice_is_pallas(cuda, B, n):
    """On the card: measure a shape, then one ``"auto"`` pass at it
    launches both combine kernels if and only if the choice is "pallas";
    with the entry flipped the other way, the reverse."""
    from repro_torch.kernels.kalman_combine import kalman_combine as kc

    model = t_scenario("coordinated_turn").make_model(torch.float64, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    _, ys = simulate_trajectory(model, n, gen, batch=(B,))
    smoother = tapi.build_smoother(n_iter=1, lm_lambda=1.0, device=cuda,
                                   autotune_for=(B, n, 5))
    entry = smoother.autotune(B, n, 5)
    assert entry["backend"] == "gpu"
    assert entry["choice"] == ("pallas" if entry["kernel_us"]
                               < entry["fused_us"] else "fused")
    for choice in (entry["choice"],
                   "fused" if entry["choice"] == "pallas" else "pallas"):
        entry["choice"] = choice
        kc.reset_launch_counts()
        smoother.iterate(model, ys)
        torch.cuda.synchronize()
        launched = kc.LAUNCHES["filtering_combine"] > 0 and \
            kc.LAUNCHES["smoothing_combine"] > 0
        assert launched == (choice == "pallas")
        assert any(kc.LAUNCHES.values()) == (choice == "pallas")
