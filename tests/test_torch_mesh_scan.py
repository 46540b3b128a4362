"""Port parity on a mesh: the collectives of `repro_torch.distributed`,
`device_exclusive_scan`, `sharded_associative_scan` and every
``axis_name`` driver of `repro_torch.core`, on four gloo ranks on the CPU.

The ranks are spawned once for the module (`run_ranks`) and run every
case (`_mesh_cases.scan_session`, torch and the port only); the oracles
are computed here. The collectives are held to their definitions, on
the 1 x 4 and 2 x 2 ("data", "model") meshes; the exclusive scan of a
non-commutative combine (matrix products) to a sequential fold; the
sharded scans (filtering, smoothing and the linear recurrence; ``batch_dims``
0 and 1; forward and reverse; n = 64 and n = 4, one element per rank;
``combine_impl`` "jnp" and "pallas", whose CPU path is the kernels' plain
versions) to JAX's unsharded ``associative_scan`` at the reference test's
tolerance (rtol 1e-8, atol 1e-9, float64); every sharded driver, its
time shards gathered (the smoother's row 0 of every shard but the first
dropped), to JAX's unsharded driver at the suite's float64 TOL. JAX is
imported on first use; the `cuda` twin spawns its ranks on the card."""
import concurrent.futures
import functools
import types

import numpy as np
import pytest
import torch

import _mesh_cases as cases
from repro_torch.launch.mesh import run_ranks
from _torch_jax import release_jax_caches  # noqa: F401

RANKS = 4
SCAN_TOL = dict(rtol=1e-8, atol=1e-9)
TOL = dict(rtol=1e-9, atol=1e-10)
NX, NY, B, N = 3, 2, 2, 64
IMPLS = ("jnp", "fused", "pallas")
SCAN_CASES = [(kind, bd, n, rev, impl)
              for kind in ("filtering", "smoothing", "linrec")
              for bd in (0, 1) for n in (64, 4) for rev in (False, True)
              for impl in ("jnp", "pallas")]


@functools.lru_cache(maxsize=None)
def jx():
    import jax
    import jax.numpy as jnp

    from repro import core

    return types.SimpleNamespace(jax=jax, jnp=jnp, core=core)


def _elements(kind, n, rng):
    lead = (B, n)
    C = jx().core
    if kind == "filtering":
        return C.FilteringElement(
            rng.standard_normal(lead + (NX, NX)) / np.sqrt(NX),
            rng.standard_normal(lead + (NX,)), cases.psd(rng, lead, NX),
            rng.standard_normal(lead + (NX,)), cases.psd(rng, lead, NX))
    if kind == "smoothing":
        return C.SmoothingElement(
            rng.standard_normal(lead + (NX, NX)) / np.sqrt(NX),
            rng.standard_normal(lead + (NX,)), cases.psd(rng, lead, NX))
    return C.LinearRecurrenceElement(rng.uniform(0.5, 1.0, lead + (5,)),
                                     rng.standard_normal(lead + (5,)))


def _port_elems(kind, elems):
    import repro_torch.core as T

    cls = {"filtering": T.FilteringElement, "smoothing": T.SmoothingElement,
           "linrec": T.LinearRecurrenceElement}[kind]
    return cls(*(np.asarray(x) for x in elems))


@functools.lru_cache(maxsize=None)
def _inputs():
    """Every case's numpy inputs. A ``batch_dims=0`` case scans lane 0 of
    its ``batch_dims=1`` twin's elements, so one JAX program (the
    batched scan) is the oracle of both."""
    rng = np.random.default_rng(0)
    scans = {}
    for kind, bd, n, rev, impl in SCAN_CASES:
        if (kind, n, rev) not in scans:
            scans[(kind, n, rev)] = _elements(kind, n, rng)
    lane = lambda e, bd: type(e)(*(x if bd else x[0]  # noqa: E731
                                   for x in e))
    return {"mats": rng.standard_normal((RANKS, 3, 3)),
            "scans": {c: _port_elems(c[0], lane(scans[(c[0], c[2], c[3])],
                                                c[1]))
                      for c in SCAN_CASES},
            "jax_scans": scans,
            "ssm": cases.random_ssm(rng, B, N), "impls": IMPLS,
            "linrec": {"a": rng.uniform(0.5, 1.0, (N, 3, 4)),
                       "b": rng.standard_normal((N, 3, 4)),
                       "h0": rng.standard_normal((3, 4))}}


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results; the JAX oracles compile while the ranks
    run."""
    inp = dict(_inputs())
    inp.pop("jax_scans")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        res = pool.submit(run_ranks, cases.scan_session, RANKS, inp,
                          device="cpu", emit=None)
        for kind, n, rev in _inputs()["jax_scans"]:
            _jax_scan(kind, n, rev)
        _jax_drivers()
        return res.result()


def _rank_of(shape, data, model):
    return data * shape[1] + model


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _expected(shape, r):
    """The collectives' results on rank ``r`` by their definitions."""
    xs = [cases.rank_input(j).numpy() for j in range(RANKS)]
    dr, mr = divmod(r, shape[1])
    D = shape[1]
    line = [xs[_rank_of(shape, dr, j)] for j in range(D)]
    x = xs[r]
    chunks = lambda a: np.split(a, D, axis=0)  # noqa: E731
    return {
        "index": (dr, mr), "size": (shape[0], D, RANKS),
        "shift": line[(mr - 1) % D],
        "partial": line[mr - 1] if mr > 0 else np.zeros_like(x),
        "pair": (line[(mr + 1) % D], 2 * line[(mr + 1) % D]),
        "psum": sum(line), "psum_all": sum(xs), "pmean": sum(line) / D,
        "pmax": np.max([-a for a in line], axis=0),
        "gather": np.stack(line), "gather_tiled": np.concatenate(line, 1),
        "scatter_tiled": chunks(sum(line))[mr],
        "scatter": sum(a[:D] for a in line)[mr],
        "scatter_tiled_dim1": np.split(sum(line)[:, :4], D, axis=1)[mr],
        "a2a_tiled": np.concatenate([chunks(a)[mr] for a in line], axis=1),
        "a2a": np.stack([a[:D][mr] for a in line], axis=1),
        "input_kept": True,
    }


COLLECTIVES = ["index", "size", "shift", "partial", "pair", "psum",
               "psum_all", "pmean", "pmax", "gather", "gather_tiled",
               "scatter_tiled", "scatter", "scatter_tiled_dim1", "a2a_tiled",
               "a2a", "input_kept"]


@pytest.mark.parametrize("shape", cases.SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_definition(ranks, shape, name):
    for r in range(RANKS):
        got = ranks[r]["collectives"][shape][name]
        want = _expected(shape, r)[name]
        if not isinstance(want, tuple):
            got, want = (got,), (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            # The reductions sum in the backend's order.
            np.testing.assert_allclose(g, w, rtol=1e-15, atol=0)


@pytest.mark.parametrize("shape", cases.SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_unbound_axis_raises(ranks, shape):
    for r in range(RANKS):
        res = ranks[r]["collectives"][shape]
        assert "unbound axis name: 'pod'" in res["unbound_axis"]
        assert "no mesh is active" in res["outside_mesh"]
    assert "unbound axis name: 'seq'" in ranks[0]["drivers"]["unbound"]


@pytest.mark.parametrize("reverse", [False, True])
def test_device_exclusive_scan_matches_fold(ranks, reverse):
    mats = _inputs()["mats"]
    for r in range(RANKS):
        idx = range(r + 1, RANKS) if reverse else range(r)
        want = np.eye(3)
        for j in idx:
            want = want @ mats[j]
        np.testing.assert_allclose(ranks[r]["exclusive"][reverse], want,
                                   rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# Sharded scans against JAX's unsharded associative_scan
# ---------------------------------------------------------------------------

_JAX_COMBINES = {"filtering": "filtering_combine",
                 "smoothing": "smoothing_combine",
                 "linrec": "linear_recurrence_combine"}


@functools.lru_cache(maxsize=None)
def _jax_scan(kind, n, rev):
    """JAX's batched ``associative_scan`` of the case's two lanes."""
    j = jx()
    scan = j.jax.jit(functools.partial(
        j.core.associative_scan, getattr(j.core, _JAX_COMBINES[kind]),
        reverse=rev, batch_dims=1))
    return scan(_inputs()["jax_scans"][(kind, n, rev)])


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_sharded_scan_matches_jax(ranks, case):
    kind, bd, n, rev, impl = case
    want = [w if bd else w[0] for w in _jax_scan(kind, n, rev)]
    for f, w in enumerate(want):
        got = np.concatenate([ranks[r]["scans"][case][f]
                              for r in range(RANKS)], axis=bd)
        np.testing.assert_allclose(got, np.asarray(w), **SCAN_TOL)


# ---------------------------------------------------------------------------
# The axis_name drivers against JAX's unsharded drivers
# ---------------------------------------------------------------------------

def _gather(parts, smoothed, axis):
    """Shards of one Gaussian field joined along time; a smoother's row 0
    on every shard but the first is the previous shard's last row."""
    if smoothed:
        parts = [parts[0]] + [np.take(p, range(1, p.shape[axis]), axis)
                              for p in parts[1:]]
    return np.concatenate(parts, axis=axis)


@functools.lru_cache(maxsize=None)
def _jax_drivers():
    j = jx()
    s = _inputs()["ssm"]
    return j.jax.jit(_jax_drivers_of)(
        *(s[k] for k in ("F", "c", "Qp", "H", "d", "Rp", "ys", "m0", "P0")))


def _jax_drivers_of(F, c, Qp, H, d, Rp, ys, m0, P0):
    """JAX's unsharded batched drivers on the same inputs (one program);
    a single-trajectory driver's oracle is lane 0 of its batched twin
    (the same algebra lane by lane)."""
    C = jx().core
    lin = C.LinearizedSSM(F, c, Qp, H, d, Rp)
    fb = C.parallel_filter_batched(lin, ys, m0, P0)
    smb = C.parallel_smoother_batched(lin, fb, m0, P0)
    qfb = C.sqrt_parallel_filter_batched(lin, ys, m0, P0)
    qsb = C.sqrt_parallel_smoother_batched(lin, qfb, m0, P0)
    one = lambda g: type(g)(*(x[0] for x in g))  # noqa: E731
    return {"parallel_filter": (one(fb),), "parallel_smoother": (one(smb),),
            "parallel_filter_smoother": (one(fb), one(smb)),
            "parallel_filter_batched": (fb,),
            "parallel_smoother_batched": (smb,),
            "parallel_filter_smoother_batched": (fb, smb),
            "sqrt_parallel_filter": (one(qfb),),
            "sqrt_parallel_smoother": (one(qsb),),
            "sqrt_parallel_filter_batched": (qfb,),
            "sqrt_parallel_smoother_batched": (qsb,)}


DRIVERS = [(name, impl) for name in (
    "parallel_filter", "parallel_smoother", "parallel_filter_smoother",
    "parallel_filter_batched", "parallel_smoother_batched",
    "parallel_filter_smoother_batched") for impl in IMPLS] + [
    (name, "sqrt") for name in (
        "sqrt_parallel_filter", "sqrt_parallel_smoother",
        "sqrt_parallel_filter_batched", "sqrt_parallel_smoother_batched")]


@pytest.mark.parametrize("name,impl", DRIVERS)
def test_sharded_driver_matches_unsharded_jax(ranks, name, impl):
    want = _jax_drivers()[name]
    got = [ranks[r]["drivers"][(name, impl)] for r in range(RANKS)]
    if len(want) == 1:
        got = [(g,) for g in got]
    axis = 1 if "batched" in name else 0
    for i, w in enumerate(want):
        smoothed = "smoother" in name and (i == 1 or "filter_smoother"
                                           not in name)
        for field in range(2):
            g = _gather([got[r][i][field] for r in range(RANKS)], smoothed,
                        axis)
            np.testing.assert_allclose(g, np.asarray(w[field]), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("h0", [False, True])
def test_sharded_linear_recurrence_matches_jax(ranks, impl, h0):
    j = jx()
    lr = _inputs()["linrec"]
    want = j.jax.jit(j.core.linear_recurrence_scan)(
        lr["a"], lr["b"], h0=lr["h0"] if h0 else None)
    got = np.concatenate([ranks[r]["linrec"][(impl, h0)]
                          for r in range(RANKS)])
    np.testing.assert_allclose(got, np.asarray(want), **SCAN_TOL)


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

def _card_session(ctx, inputs):
    """The sharded filter and smoother through the combine kernels on one
    card shared by four ranks: per-rank launches and the gathered
    result."""
    import repro_torch.core as T
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.launch import mesh as M

    lin, ys, m0, P0 = (x.to(ctx.device) if not isinstance(x, tuple) else
                       type(x)(*(t.to(ctx.device) for t in x))
                       for x in cases._shard_lin(inputs, ctx.rank,
                                                 ctx.world_size))
    with M.make_debug_mesh(1, ctx.world_size):
        kc.reset_launch_counts()
        f, s = T.parallel_filter_smoother(
            type(lin)(*(x[0] for x in lin)), ys[0], m0, P0,
            combine_impl="pallas", axis_name="model")
        torch.cuda.synchronize()
        return {"launches": dict(kc.LAUNCHES), "plain": dict(kc.PLAIN_CALLS),
                "cuda": f.mean.is_cuda and s.mean.is_cuda,
                "f": cases._np(f), "s": cases._np(s)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sharded_driver_on_the_card(cuda):
    import repro_torch.core as T
    from repro_torch.core.types import LinearizedSSM

    from repro_torch.kernels.kalman_combine import kalman_combine as kc

    kc._library()  # built once here; the ranks load it
    s = cases.random_ssm(np.random.default_rng(3), 1, 256)
    res = run_ranks(_card_session, RANKS, s, emit=None)
    lin = LinearizedSSM(*(torch.as_tensor(s[k][0]) for k in
                          LinearizedSSM._fields))
    f, sm = T.parallel_filter_smoother(lin, torch.as_tensor(s["ys"][0]),
                                       torch.as_tensor(s["m0"]),
                                       torch.as_tensor(s["P0"]))
    # Per rank and combine kernel: the local scan of 64 elements (six
    # levels of two combine calls, the last one empty) and the fix-up.
    want = 2 * 6 - 1 + 1
    for r in range(RANKS):
        assert res[r]["cuda"]
        assert set(res[r]["launches"].values()) == {want}
        assert not any(res[r]["plain"].values())
    for field, ref in ((0, f.mean), (1, f.cov)):
        got = np.concatenate([res[r]["f"][field] for r in range(RANKS)])
        np.testing.assert_allclose(got, ref.numpy(), **TOL)
    got = _gather([res[r]["s"][0] for r in range(RANKS)], True, 0)
    np.testing.assert_allclose(got, sm.mean.numpy(), **TOL)
