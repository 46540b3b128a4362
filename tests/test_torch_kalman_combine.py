"""Port parity: the batched Kalman combines (paper Eq. 15 / Eq. 19).

The port's plain versions are held against the JAX package's
`filtering_combine_math`/`smoothing_combine_math` and against its Pallas
kernels run in interpret mode (as the JAX suite runs them on the CPU), at
the suite's TOL. The CUDA kernels themselves run only on a card: those
tests carry the `cuda` marker and skip here. JAX is imported inside the
parity tests only, so on a card's machine without JAX the marked tests
run with ``pytest --noconftest -m cuda``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import parallel as tpar
from repro_torch.core import scan as tscan
from repro_torch.core.types import (FilteringElement as TF,
                                    SmoothingElement as TS)
from repro_torch.kernels.kalman_combine import kalman_combine as kc
from repro_torch.kernels.kalman_combine import ops as tops
from repro_torch.kernels.kalman_combine import ref as tref
from _torch_jax import release_jax_caches  # noqa: F401

TOL = {np.float32: dict(rtol=2e-4, atol=2e-5),
       np.float64: dict(rtol=1e-9, atol=1e-10)}
DTYPES = [np.float32, np.float64]


def _psd(rng, B, nx):
    a = rng.standard_normal((B, nx, nx))
    return a @ np.swapaxes(a, -1, -2) / nx + 0.1 * np.eye(nx)


def filtering_pair(rng, B, nx):
    def one():
        return [rng.standard_normal((B, nx, nx)) / np.sqrt(nx),
                rng.standard_normal((B, nx)), _psd(rng, B, nx),
                rng.standard_normal((B, nx)), _psd(rng, B, nx)]
    return one(), one()


def smoothing_pair(rng, B, nx):
    def one():
        return [rng.standard_normal((B, nx, nx)) / np.sqrt(nx),
                rng.standard_normal((B, nx)), _psd(rng, B, nx)]
    return one(), one()


def to_torch(cls, fields, dtype, device="cpu"):
    return cls(*(torch.tensor(np.asarray(f, dtype), device=device)
                 for f in fields))


def assert_close(got, want, dtype):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().cpu().numpy(), np.asarray(w),
                                   **TOL[dtype])


#: Port side of each combine: (random pair, element type, plain version,
#: textbook oracle, kernel wrapper).
KINDS = {
    "filtering": (filtering_pair, TF, kc.filtering_combine_math,
                  tref.filtering_combine_batched_ref,
                  kc.filtering_combine_cuda),
    "smoothing": (smoothing_pair, TS, kc.smoothing_combine_math,
                  tref.smoothing_combine_batched_ref,
                  kc.smoothing_combine_cuda),
}


@functools.lru_cache(maxsize=None)
def jax_side(kind):
    """JAX side of a combine: (element type, `*_combine_math`, Pallas
    kernel, vmapped textbook oracle, dispatching op). Imported here, not
    at module level, so the `cuda` tests also run where JAX is absent."""
    import jax

    from repro.core.types import FilteringElement, SmoothingElement
    from repro.kernels.kalman_combine import kalman_combine as jk
    from repro.kernels.kalman_combine import ops as jops
    from repro.kernels.kalman_combine import ref as jref

    if kind == "filtering":
        return (FilteringElement, jax.jit(jk.filtering_combine_math),
                jk.filtering_combine_batched,
                jax.jit(jref.filtering_combine_batched_ref),
                jops.filtering_combine_op)
    return (SmoothingElement, jax.jit(jk.smoothing_combine_math),
            jk.smoothing_combine_batched,
            jax.jit(jref.smoothing_combine_batched_ref),
            jops.smoothing_combine_op)


def to_jax(cls, fields, dtype):
    import jax.numpy as jnp
    return cls(*(jnp.asarray(np.asarray(f, dtype)) for f in fields))


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx", [1, 5, 8])
@pytest.mark.parametrize("B", [0, 1, 7, 513])
def test_plain_combine_matches_jax(kind, B, nx, dtype):
    """Plain version vs the JAX kernel body (`*_combine_math`); on CPU
    tensors the kernel wrapper takes the plain version and launches
    nothing."""
    pair, tcls, tmath, _, wrapper = KINDS[kind]
    jcls, jmath, *_ = jax_side(kind)
    rng = np.random.default_rng(1000 * B + 10 * nx + (kind == "smoothing"))
    fi, fj = pair(rng, B, nx)
    ti, tj = to_torch(tcls, fi, dtype), to_torch(tcls, fj, dtype)
    want = jmath(*to_jax(jcls, fi, dtype), *to_jax(jcls, fj, dtype))

    got = tmath(*ti, *tj)
    assert all(g.dtype == ti[0].dtype and g.shape == t.shape
               for g, t in zip(got, ti))
    assert_close(got, want, dtype)
    before = dict(kc.LAUNCHES)
    assert_close(wrapper(ti, tj), want, dtype)
    assert kc.LAUNCHES == before


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("nx", [1, 5, 8])
@pytest.mark.parametrize("B", [0, 1, 7, 513])
def test_plain_combine_matches_pallas_interpret(kind, B, nx):
    """Plain version vs the JAX Pallas kernel in interpret mode, in f64
    (the JAX dispatch sends B = 0 to its textbook ref: so does this)."""
    pair, tcls, tmath, _, _ = KINDS[kind]
    jcls, _, pallas_fn, _, jop = jax_side(kind)
    rng = np.random.default_rng(1000 * B + 10 * nx + (kind == "smoothing"))
    fi, fj = pair(rng, B, nx)
    ji, jj = to_jax(jcls, fi, np.float64), to_jax(jcls, fj, np.float64)
    want = pallas_fn(ji, jj, interpret=True) if B else jop(ji, jj)
    got = tmath(*to_torch(tcls, fi, np.float64),
                *to_torch(tcls, fj, np.float64))
    assert_close(got, want, np.float64)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_textbook_oracle_matches_jax(kind, dtype):
    """ref.py (LU-solve textbook combines) vs the JAX vmapped oracle."""
    pair, tcls, _, tref_fn, _ = KINDS[kind]
    jcls, _, _, jref_fn, _ = jax_side(kind)
    fi, fj = pair(np.random.default_rng(3), 33, 5)
    want = jref_fn(to_jax(jcls, fi, dtype), to_jax(jcls, fj, dtype))
    assert_close(tref_fn(to_torch(tcls, fi, dtype), to_torch(tcls, fj, dtype)),
                 want, dtype)


def test_dispatch_policy():
    from repro_torch.core.parallel import filtering_combine, smoothing_combine
    assert tops.batched_combine_for(filtering_combine) == (
        kc.filtering_combine_cuda, True)
    assert tops.batched_combine_for(smoothing_combine) == (
        kc.smoothing_combine_cuda, True)
    assert tops.plain_batched_combine_for(filtering_combine) is \
        kc.filtering_combine_plain
    user = lambda a, b: b  # noqa: E731
    assert tops.batched_combine_for(user) == (user, False)
    assert tops.resolve_backend(None) == "gpu"
    with pytest.raises(ValueError, match="tpu"):
        tops.resolve_backend("tpu")
    with pytest.raises(ValueError):
        tops.resolve_backend("interpret")


def level_set(kind, rng, L, T, nx, dtype, device="cpu"):
    """An ``[L, T]`` element set (one scan level's elements)."""
    pair, tcls = KINDS[kind][:2]
    fields = pair(rng, L * T, nx)[0]
    return tcls(*(torch.tensor(np.asarray(f, dtype).reshape(
        (L, T) + f.shape[1:]), device=device) for f in fields))


def sliced(x, *index):
    return type(x)(*(t[index] for t in x))


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_strided_scan_matches_jax_fused(kind, dtype, reverse, monkeypatch):
    """The kernel route of the scan (``combine_impl="pallas"``,
    ``batch_dims=1``) on a ``[4, 33]`` element set (odd T) hands the
    wrapper strided ``[4, P]`` views of each level, and its results match
    the JAX package's fused scan on the same numpy inputs."""
    from repro.core import parallel as jpar
    from repro.core import scan as jscan

    pair, tcls, _, _, wrapper = KINDS[kind]
    jcls = jax_side(kind)[0]
    rng = np.random.default_rng(33 + 2 * reverse + (kind == "smoothing"))
    fields = [np.asarray(f, dtype).reshape((4, 33) + f.shape[1:])
              for f in pair(rng, 4 * 33, 5)[0]]
    seen = []

    def spy(ei, ej):
        seen.append([(t.shape[:2], t.is_contiguous()) for t in ei + ej])
        return wrapper(ei, ej)

    monkeypatch.setattr(kc, f"{kind}_combine_cuda", spy)
    before = tscan.PACK_COPIES
    got = tscan.associative_scan(
        getattr(tpar, f"{kind}_combine"), tcls(*map(torch.from_numpy, fields)),
        reverse=reverse, combine_impl="pallas", batch_dims=1)
    assert tscan.PACK_COPIES == before
    assert seen and all(g[0] == 4 for call in seen for g, _ in call)
    assert any(not contig for call in seen for _, contig in call)
    want = jscan.associative_scan(
        getattr(jpar, f"{kind}_combine"), to_jax(jcls, fields, dtype),
        reverse=reverse, combine_impl="fused", batch_dims=1)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_wrapper_checks_accept_strided_grids(kind):
    """The wrapper's checks (pure Python, run before any pointer reaches
    C) accept ``[L, P]`` and ``[P]`` grids with any strides over the pairs
    and reject a non-dense trailing block, mixed dtypes, unsupported
    dtypes and nx > 16."""
    blocks = (kc._FILTERING_BLOCKS if kind == "filtering"
              else kc._SMOOTHING_BLOCKS) * 2
    x = level_set(kind, np.random.default_rng(0), 3, 9, 5, np.float64)
    lo, hi = sliced(x, slice(None), slice(0, -1, 2)), \
        sliced(x, slice(None), slice(1, None, 2))
    # Grid and each field's (lead, pair) strides: element i's A of the
    # [3, 9] set sliced x[:, 0:-1:2] steps 9 blocks per row, 2 per pair.
    grid, lead, pair = kc._check(list(lo) + list(hi), blocks, kind)
    assert grid == (3, 4)
    assert (lead[0], pair[0], lead[1], pair[1]) == (9 * 25, 2 * 25, 9 * 5,
                                                     2 * 5)
    grid, lead, pair = kc._check(list(sliced(x, 1)) + list(sliced(x, 2)),
                                 blocks, kind)
    assert grid == (9,) and lead[0] == 0 and pair[0] == 25
    # An empty grid reads nothing: any strides pass (numpy's empty arrays
    # come to torch with zero strides).
    empty = level_set(kind, np.random.default_rng(0), 0, 9, 5, np.float64)
    assert kc._check(list(empty) + list(empty), blocks, kind)[0] == (0, 9)
    transposed = type(x)(*(t.transpose(-1, -2) if t.ndim == 4 else t
                           for t in lo))
    with pytest.raises(ValueError, match="non-dense trailing block"):
        kc._check(list(transposed) + list(hi), blocks, kind)
    with pytest.raises(TypeError, match="mixed"):
        kc._check(list(lo) + [t.float() for t in hi], blocks, kind)
    with pytest.raises(TypeError, match="float32/float64"):
        kc._check([t.half() for t in list(lo) + list(hi)], blocks, kind)
    big = level_set(kind, np.random.default_rng(1), 1, 2, 17, np.float64)
    with pytest.raises(ValueError, match="nx"):
        kc._check(list(big) + list(big), blocks, kind)


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,nx", [(0, 5), (1, 1), (7, 16), (513, 8),
                                  (16384, 5)])
def test_kernel_matches_plain_on_card(cuda, kind, B, nx, dtype):
    pair, tcls, tmath, _, wrapper = KINDS[kind]
    rng = np.random.default_rng(B + nx)
    fi, fj = pair(rng, B, nx)
    ti, tj = to_torch(tcls, fi, dtype, cuda), to_torch(tcls, fj, dtype, cuda)
    before = kc.LAUNCHES[f"{kind}_combine"]
    got = wrapper(ti, tj)
    torch.cuda.synchronize()
    assert kc.LAUNCHES[f"{kind}_combine"] == before + (1 if B else 0)
    assert_close(got, [t.cpu().numpy() for t in tmath(*ti, *tj)], dtype)


#: Strided in-place cases: (what, L, T, nx, slices of element i, slices of
#: element j). "second" pairs the contiguous result of the first call
#: (``odd``) with ``x[:, 2::2]``; at T = 513 every other row starts off a
#: 16-byte boundary, so the slices are only 8-byte aligned at f64.
STRIDED = [("top level", 64, 512, 5), ("odd T", 64, 513, 5),
           ("nx=1", 8, 33, 1), ("nx=8", 8, 33, 8), ("nx=16", 4, 33, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("what,L,T,nx", STRIDED)
def test_kernel_reads_level_slices_in_place_on_card(cuda, kind, dtype, what,
                                                    L, T, nx):
    """The kernel on a scan level's strided slices (first call
    ``x[:, 0:-1:2]``/``x[:, 1::2]``, second call ``odd[:, :-1]``/
    ``x[:, 2::2]``), each launching once, against the plain version."""
    wrapper, tmath = KINDS[kind][4], KINDS[kind][2]
    x = level_set(kind, np.random.default_rng(T + nx), L, T, nx, dtype,
                  cuda)
    name = f"{kind}_combine"

    def launch_once(ei, ej):
        assert not ej[0].is_contiguous()
        before = kc.LAUNCHES[name]
        got = wrapper(ei, ej)
        torch.cuda.synchronize()
        assert kc.LAUNCHES[name] == before + 1
        assert all(g.is_contiguous() for g in got)
        assert_close(got, [t.cpu().numpy() for t in tmath(*ei, *ej)], dtype)
        return got

    odd = launch_once(sliced(x, slice(None), slice(0, -1, 2)),
                      sliced(x, slice(None), slice(1, None, 2)))
    launch_once(sliced(odd, slice(None), slice(0, -1)) if T % 2 == 0 else odd,
                sliced(x, slice(None), slice(2, None, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernel_wrapper_rejects_bad_inputs(cuda, kind):
    """On the card the wrapper takes strided pair slices and an empty
    grid (no launch), and raises only on what the kernel cannot read: a
    non-dense trailing block, mixed or unsupported dtypes, nx > 16."""
    wrapper = KINDS[kind][4]
    x = level_set(kind, np.random.default_rng(0), 2, 9, 5, np.float64, cuda)
    lo = sliced(x, slice(None), slice(0, -1, 2))
    hi = sliced(x, slice(None), slice(1, None, 2))
    name = f"{kind}_combine"
    before = kc.LAUNCHES[name]
    assert wrapper(lo, hi)[0].shape == (2, 4, 5, 5)
    empty = sliced(x, slice(None), slice(0, 0))
    assert wrapper(empty, empty)[0].shape == (2, 0, 5, 5)
    assert kc.LAUNCHES[name] == before + 1
    transposed = type(x)(*(t.transpose(-1, -2) if t.ndim == 4 else t
                           for t in lo))
    with pytest.raises(ValueError, match="non-dense trailing block"):
        wrapper(transposed, hi)
    with pytest.raises(TypeError):
        wrapper(type(x)(*(t.half() for t in lo)),
                type(x)(*(t.half() for t in hi)))
    with pytest.raises(TypeError):
        wrapper(lo, type(x)(*(t.float() for t in hi)))
    big = level_set(kind, np.random.default_rng(0), 1, 2, 17, np.float64,
                    cuda)
    with pytest.raises(ValueError, match="nx"):
        wrapper(big, big)
    assert kc.LAUNCHES[name] == before + 1
