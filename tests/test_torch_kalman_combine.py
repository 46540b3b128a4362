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

from repro_torch.core.types import (FilteringElement as TF,
                                    SmoothingElement as TS)
from repro_torch.kernels.kalman_combine import kalman_combine as kc
from repro_torch.kernels.kalman_combine import ops as tops
from repro_torch.kernels.kalman_combine import ref as tref

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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernel_wrapper_rejects_bad_inputs(cuda, kind):
    pair, tcls, _, _, wrapper = KINDS[kind]
    fi, fj = pair(np.random.default_rng(0), 8, 5)
    ti, tj = (to_torch(tcls, fi, np.float64, cuda),
              to_torch(tcls, fj, np.float64, cuda))
    strided = tcls(*(torch.cat([t, t])[::2] for t in ti))
    assert not strided[0].is_contiguous()
    with pytest.raises(ValueError, match="non-contiguous"):
        wrapper(strided, tj)
    with pytest.raises(TypeError):
        wrapper(tcls(*(t.half() for t in ti)), tcls(*(t.half() for t in tj)))
    with pytest.raises(TypeError):
        wrapper(ti, tcls(*(t.float() for t in tj)))
    big = pair(np.random.default_rng(0), 2, 17)
    with pytest.raises(ValueError, match="nx"):
        wrapper(to_torch(tcls, big[0], np.float64, cuda),
                to_torch(tcls, big[1], np.float64, cuda))
