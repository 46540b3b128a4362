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


def test_kernel_route_packs_pairs_contiguously():
    """The kernel route hands the wrapper one flat, contiguous batch per
    level (the CUDA kernels read dense rows) and restores the lead axes."""
    calls = []

    def flat_only(e, l):
        calls.append((tuple(e.a.shape), e.a.is_contiguous(),
                      l.a.is_contiguous()))
        return affine_torch(e, l)

    op = tscan._flattening_op(flat_only, 2)
    a, b = _affine_elems(np.random.default_rng(0), (4, 8))
    x = Affine(torch.from_numpy(a), torch.from_numpy(b))
    strided = Affine(*(t[:, 0:-1:2] for t in x))
    out = op(strided, Affine(*(t[:, 1::2] for t in x)))
    assert calls == [((16, 3, 3), True, True)]
    assert out.a.shape == (4, 4, 3, 3) and out.b.shape == (4, 4, 3)


def test_unknown_impl_raises():
    fields = _affine_elems(np.random.default_rng(0), (4,))
    x = Affine(*map(torch.from_numpy, fields))
    with pytest.raises(ValueError):
        tscan.associative_scan(affine_torch, x, combine_impl="bogus")
    with pytest.raises(ValueError, match="tpu"):
        tscan.associative_scan(affine_torch, x, combine_impl="pallas:tpu")
