"""Port parity: repro_torch.core.scan.associative_scan vs
``jax.lax.associative_scan`` (through the JAX package's ``associative_scan``).

The port writes JAX's odd/even recursion by hand, so every level combines
the same pairs in the same order: outputs agree to rounding (the suite's
f64 TOL) for an affine-map combine and for the Eq. 15 filtering combine,
forward and reverse, with ``batch_dims`` 0 and 1, at lengths 1, 2, 3, 7
and 64. A recording combine pins the level structure itself.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel as jpar
from repro.core import scan as jscan
from repro.core.types import FilteringElement as JF
from repro_torch.core import parallel as tpar
from repro_torch.core import scan as tscan
from repro_torch.core.types import FilteringElement as TF
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-10)
LENGTHS = [1, 2, 3, 7, 64]


class Affine(NamedTuple):
    """``x -> a x + b`` with ``a [d, d]``, ``b [d]``."""
    a: object
    b: object


def affine_jax(e, l):
    """Unbatched (earlier, later) composition: later after earlier."""
    return Affine(l.a @ e.a, l.a @ e.b + l.b)


def affine_torch(e, l):
    """The same composition, broadcasting over leading axes."""
    return Affine(l.a @ e.a, (l.a @ e.b[..., None])[..., 0] + l.b)


def _affine_elems(rng, lead, d=3):
    return (rng.standard_normal(lead + (d, d)) / np.sqrt(d),
            rng.standard_normal(lead + (d,)))


def _filtering_elems(rng, lead, nx=4):
    def psd():
        a = rng.standard_normal(lead + (nx, nx))
        return a @ np.swapaxes(a, -1, -2) / nx + 0.1 * np.eye(nx)
    return (rng.standard_normal(lead + (nx, nx)) / np.sqrt(nx),
            rng.standard_normal(lead + (nx,)), psd(),
            rng.standard_normal(lead + (nx,)), psd())


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch_dims", [0, 1])
@pytest.mark.parametrize("T", LENGTHS)
def test_affine_scan_matches_jax(T, batch_dims, reverse):
    rng = np.random.default_rng(T + 10 * batch_dims + 100 * reverse)
    lead = (3, T) if batch_dims else (T,)
    fields = _affine_elems(rng, lead)
    want = jax.jit(lambda e: jscan.associative_scan(
        affine_jax, e, reverse=reverse, batch_dims=batch_dims))(
            Affine(*map(jnp.asarray, fields)))
    got = tscan.associative_scan(
        affine_torch, Affine(*map(torch.from_numpy, fields)),
        reverse=reverse, batch_dims=batch_dims)
    _assert_close(got, want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch_dims", [0, 1])
@pytest.mark.parametrize("T", LENGTHS)
def test_filtering_scan_matches_jax(T, batch_dims, reverse):
    """The Eq. 15 combine under each port impl ("jnp" textbook, "fused"
    plain kernel math, "pallas" — the plain version on CPU tensors) vs
    the JAX textbook scan."""
    rng = np.random.default_rng(T + 10 * batch_dims + 100 * reverse)
    lead = (2, T) if batch_dims else (T,)
    fields = _filtering_elems(rng, lead)
    want = jax.jit(lambda e: jscan.associative_scan(
        jpar.filtering_combine, e, reverse=reverse, combine_impl="jnp",
        batch_dims=batch_dims))(JF(*map(jnp.asarray, fields)))
    for impl in ("jnp", "fused", "pallas"):
        got = tscan.associative_scan(
            tpar.filtering_combine, TF(*map(torch.from_numpy, fields)),
            reverse=reverse, combine_impl=impl, batch_dims=batch_dims)
        _assert_close(got, want)


@pytest.mark.parametrize("T", [1, 2, 3, 7, 64, 512])
def test_level_structure_matches_jax(T):
    """Same combine calls, in the same order, with the same pair counts —
    including the empty call of the n=2 level (18 calls, 17 non-empty at
    n=512: the launch count per scan the port's kernels see)."""
    seen_j, seen_t = [], []

    def rec_jax(e, l):
        seen_j.append(int(e.a.shape[0]))
        return Affine(jnp.einsum("tij,tjk->tik", l.a, e.a),
                      jnp.einsum("tij,tj->ti", l.a, e.b) + l.b)

    def rec_torch(e, l):
        seen_t.append(int(e.a.shape[0]))
        return affine_torch(e, l)

    fields = _affine_elems(np.random.default_rng(T), (T,), d=2)
    jax.make_jaxpr(lambda e: jax.lax.associative_scan(rec_jax, e))(
        Affine(*map(jnp.asarray, fields)))
    tscan.associative_scan(rec_torch, Affine(*map(torch.from_numpy, fields)))
    assert seen_t == seen_j
    if T == 512:
        assert len(seen_t) == 18 and sum(1 for s in seen_t if s) == 17


def _recording_pair_op(nlead):
    """`_pair_grid_op` over a combine that records what it is handed."""
    calls = []

    def on_grid(e, l):
        calls.append((tuple(e.a.shape), tuple(l.a.shape), e.a, l.a))
        return affine_torch(e, l)

    return tscan._pair_grid_op(on_grid, nlead), calls


def test_kernel_route_packs_pairs_contiguously():
    """The kernel route hands the wrapper each level's strided slices as
    ``[L, P, ...]`` views of the level's elements — no packing copy, no
    count in PACK_COPIES — and restores the lead axes."""
    op, calls = _recording_pair_op(2)
    a, b = _affine_elems(np.random.default_rng(0), (4, 8))
    x = Affine(torch.from_numpy(a), torch.from_numpy(b))
    before = tscan.PACK_COPIES
    out = op(Affine(*(t[:, 0:-1:2] for t in x)),
             Affine(*(t[:, 1::2] for t in x)))
    assert tscan.PACK_COPIES == before
    [(ei_shape, ej_shape, ei_a, ej_a)] = calls
    assert ei_shape == ej_shape == (4, 4, 3, 3)
    for view, start in ((ei_a, 0), (ej_a, 1)):
        assert view.untyped_storage().data_ptr() == \
            x.a.untyped_storage().data_ptr()
        assert view.data_ptr() == x.a[:, start].data_ptr()
        assert view.stride() == (8 * 9, 2 * 9, 3, 1)
    assert out.a.shape == (4, 4, 3, 3) and out.b.shape == (4, 4, 3)
    want = affine_torch(Affine(*(t[:, 0:-1:2] for t in x)),
                        Affine(*(t[:, 1::2] for t in x)))
    _assert_close(out, want)


def test_kernel_route_merges_two_batch_axes_as_views():
    """Two leading batch axes merge into L as a view (``[2, 3, P]`` ->
    ``[6, P]``), with the pair stride of the slice."""
    op, calls = _recording_pair_op(3)
    a, b = _affine_elems(np.random.default_rng(1), (2, 3, 9))
    x = Affine(torch.from_numpy(a), torch.from_numpy(b))
    before = tscan.PACK_COPIES
    out = op(Affine(*(t[:, :, 0:-1:2] for t in x)),
             Affine(*(t[:, :, 2::2] for t in x)))
    assert tscan.PACK_COPIES == before
    [(ei_shape, _, ei_a, ej_a)] = calls
    assert ei_shape == (6, 4, 3, 3)
    assert ei_a.data_ptr() == x.a.data_ptr()
    assert ej_a.data_ptr() == x.a[:, :, 2].data_ptr()
    assert ej_a.stride() == (9 * 9, 2 * 9, 3, 1)
    assert out.a.shape == (2, 3, 4, 3, 3)
    _assert_close(out, affine_torch(Affine(*(t[:, :, 0:-1:2] for t in x)),
                                    Affine(*(t[:, :, 2::2] for t in x))))


def test_kernel_route_counts_the_copy_it_cannot_avoid():
    """Batch axes whose strides do not merge (here transposed) are copied,
    and each copied field is counted in PACK_COPIES."""
    op, calls = _recording_pair_op(3)
    a, b = _affine_elems(np.random.default_rng(2), (3, 2, 6))
    x = Affine(*(torch.from_numpy(t).transpose(0, 1) for t in (a, b)))
    before = tscan.PACK_COPIES
    out = op(Affine(*(t[:, :, 0:-1:2] for t in x)),
             Affine(*(t[:, :, 1::2] for t in x)))
    assert tscan.PACK_COPIES == before + 4
    assert calls[0][0] == (6, 3, 3, 3)
    _assert_close(out, affine_torch(Affine(*(t[:, :, 0:-1:2] for t in x)),
                                    Affine(*(t[:, :, 1::2] for t in x))))


def test_unknown_impl_raises():
    fields = _affine_elems(np.random.default_rng(0), (4,))
    x = Affine(*map(torch.from_numpy, fields))
    with pytest.raises(ValueError):
        tscan.associative_scan(affine_torch, x, combine_impl="bogus")
    with pytest.raises(ValueError, match="tpu"):
        tscan.associative_scan(affine_torch, x, combine_impl="pallas:tpu")
