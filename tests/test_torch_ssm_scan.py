"""Port parity: the linear-recurrence scan (kernel ssm_scan) and
`linear_recurrence_scan`.

The port's plain version, its dispatching ``ops.ssm_scan`` and its oracle
are held against the JAX package's Pallas kernel ``ssm_scan_batched`` in
interpret mode (as the JAX suite runs it on the CPU) and its
``ssm_scan_ref``, on the JAX suite's shape sweep, chunk sizes, ``h0`` and
2-D interface cases, at the suite's TOL. ``linear_recurrence_scan`` is
held against the JAX entry point: both paths for 2-D input, the ``"jnp"``
path for other ranks (the JAX ``"pallas"`` path scans the wrong axis of a
3-D input; one test pins that). The CUDA kernel runs only on a card:
those tests carry the `cuda` marker and skip here. JAX is imported on
first use, not at module level, so on a card's machine without JAX the
marked tests run with ``pytest --noconftest -m cuda``.
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.core import (LinearRecurrenceElement,
                              linear_recurrence_combine,
                              linear_recurrence_scan)
from repro_torch.kernels.ssm_scan import ops, ref
from repro_torch.kernels.ssm_scan import ssm_scan as kss
from _torch_jax import release_jax_caches  # noqa: F401


@functools.lru_cache(maxsize=None)
def jx():
    """The JAX side: ``jnp``, the entry point ``lrs``, its element and
    combine, the kernel's ``ops``/``ref`` and the Pallas kernel."""
    import jax.numpy as jnp

    from repro.core import linear_recurrence_scan
    from repro.core.scan import LinearRecurrenceElement, \
        linear_recurrence_combine
    from repro.kernels.ssm_scan import ops, ref
    from repro.kernels.ssm_scan.ssm_scan import ssm_scan_batched

    return types.SimpleNamespace(
        jnp=jnp, lrs=linear_recurrence_scan, Elem=LinearRecurrenceElement,
        combine=linear_recurrence_combine, ops=ops, ref=ref,
        pallas=ssm_scan_batched)


TOL = {np.float32: dict(rtol=2e-4, atol=1e-5),
       np.float64: dict(rtol=1e-10, atol=1e-11),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
SHAPES = [(1, 8, 4), (2, 100, 16), (3, 128, 40), (1, 257, 512), (2, 64, 130)]


def _rand(rng, shape):
    # Decays in (0.2, 1.0): stable recurrences, like trained SSM gates.
    return rng.uniform(0.2, 1.0, shape), rng.standard_normal(shape)


def _t(x, dtype=np.float64, device="cpu"):
    if dtype == "bfloat16":
        return torch.tensor(np.asarray(x, np.float32), device=device
                            ).to(torch.bfloat16)
    return torch.tensor(np.asarray(x, dtype), device=device)


def _np(x):
    return x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 \
        else x.detach().cpu().numpy()


@pytest.mark.parametrize("B,T,D", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_matches_pallas_interpret(B, T, D, dtype):
    """Plain version (and the wrapper and ``ops.ssm_scan``, which take it
    for CPU tensors, launching nothing) vs the Pallas kernel in interpret
    mode."""
    a, b = _rand(np.random.default_rng(T + D), (B, T, D))
    J = jx()
    want = np.asarray(J.pallas(J.jnp.asarray(a, dtype),
                               J.jnp.asarray(b, dtype), chunk=32,
                               d_block=64, interpret=True))
    before = dict(kss.LAUNCHES)
    for fn in (kss.ssm_scan_plain, kss.ssm_scan_cuda, ops.ssm_scan):
        got = fn(_t(a, dtype), _t(b, dtype))
        assert got.dtype == _t(a, dtype).dtype and got.shape == (B, T, D)
        np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    assert kss.LAUNCHES == before


def test_bfloat16_close_to_f32_oracle():
    """bf16 in, bf16 out, carried in f32: within the JAX suite's bf16 TOL
    of the f32 oracle, as the JAX kernel is."""
    J, jnp = jx(), jx().jnp
    a, b = _rand(np.random.default_rng(0), (2, 64, 32))
    want = np.asarray(J.ref.ssm_scan_ref(jnp.asarray(a, jnp.float32),
                                         jnp.asarray(b, jnp.float32)))
    jax_bf16 = J.pallas(jnp.asarray(a, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16), chunk=16, d_block=32,
                        interpret=True)
    np.testing.assert_allclose(np.asarray(jax_bf16, np.float32), want,
                               **TOL["bfloat16"])
    got = kss.ssm_scan_plain(_t(a, "bfloat16"), _t(b, "bfloat16"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **TOL["bfloat16"])


@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_chunk_invariance(chunk):
    """``chunk``/``d_block`` are the TPU's tiles: the port's result does
    not depend on them and matches the JAX kernel at each chunk."""
    J = jx()
    a, b = _rand(np.random.default_rng(1), (2, 96, 24))
    want = np.asarray(J.pallas(J.jnp.asarray(a), J.jnp.asarray(b),
                               chunk=chunk, d_block=24, interpret=True))
    got = ops.ssm_scan(_t(a), _t(b), chunk=chunk, d_block=24)
    np.testing.assert_allclose(_np(got), want, **TOL[np.float64])
    np.testing.assert_array_equal(_np(got), _np(ops.ssm_scan(_t(a), _t(b))))


def test_h0_folding_and_2d_interface():
    J, jnp = jx(), jx().jnp
    rng = np.random.default_rng(2)
    a, b = _rand(rng, (1, 50, 8))
    h0 = rng.standard_normal((1, 8))
    want = np.asarray(J.ops.ssm_scan(jnp.asarray(a), jnp.asarray(b),
                                     h0=jnp.asarray(h0), chunk=16))
    got = ops.ssm_scan(_t(a), _t(b), h0=_t(h0), chunk=16)
    np.testing.assert_allclose(_np(got), want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        _np(ref.ssm_scan_ref(_t(a), _t(b), h0=_t(h0))),
        np.asarray(J.ref.ssm_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                      h0=jnp.asarray(h0))),
        rtol=1e-10, atol=1e-12)
    got2 = ops.ssm_scan(_t(a[0]), _t(b[0]), h0=_t(h0[0]), chunk=16)
    assert got2.shape == (50, 8)
    np.testing.assert_allclose(_np(got2), want[0], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("B,T,D", [(1, 1, 1), (3, 257, 40), (1, 300, 3)])
def test_ref_matches_jax_ref(B, T, D):
    J = jx()
    a, b = _rand(np.random.default_rng(B * T * D), (B, T, D))
    want = np.asarray(J.ref.ssm_scan_ref(J.jnp.asarray(a), J.jnp.asarray(b)))
    np.testing.assert_allclose(_np(ref.ssm_scan_ref(_t(a), _t(b))), want,
                               **TOL[np.float64])


@pytest.mark.parametrize("shape", [(2, 0, 3), (0, 5, 3), (1, 4, 0)])
def test_empty_inputs(shape):
    before = dict(kss.LAUNCHES)
    a = torch.zeros(shape, dtype=torch.float64)
    assert kss.ssm_scan_cuda(a, a).shape == shape
    assert ops.ssm_scan(a, a, h0=torch.zeros(shape[0], shape[2],
                                             dtype=torch.float64)
                        ).shape == shape
    assert kss.LAUNCHES == before


@pytest.mark.parametrize("B,T,D", [(1, 4096, 16), (2, 1000, 3),
                                   (3, 257, 40)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_matches_sequential_ref(B, T, D, dtype):
    """The plain version (the on-card reference of the kernel) against the
    port's sequential oracle at the card tests' few-channel, long-T
    shapes."""
    a, b = _rand(np.random.default_rng(B * T + D), (B, T, D))
    ta, tb = _t(a, dtype), _t(b, dtype)
    np.testing.assert_allclose(_np(kss.ssm_scan_plain(ta, tb)),
                               _np(ref.ssm_scan_ref(ta, tb)), **TOL[dtype])


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        kss.ssm_scan_cuda(a, torch.zeros(2, 3, 5))
    with pytest.raises(TypeError):
        kss.ssm_scan_cuda(a.half(), a.half())
    with pytest.raises(TypeError):
        kss.ssm_scan_cuda(a, a.double())
    with pytest.raises(ValueError, match="non-contiguous"):
        kss.ssm_scan_cuda(a.mT.contiguous().mT, a)


# ---------------------------------------------------------------------------
# linear_recurrence_scan
# ---------------------------------------------------------------------------

def test_combine_matches_jax():
    J = jx()
    rng = np.random.default_rng(5)
    x = [rng.standard_normal((6, 3)) for _ in range(4)]
    want = J.combine(J.Elem(*map(J.jnp.asarray, x[:2])),
                     J.Elem(*map(J.jnp.asarray, x[2:])))
    got = linear_recurrence_combine(LinearRecurrenceElement(*map(_t, x[:2])),
                                    LinearRecurrenceElement(*map(_t, x[2:])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-12)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_2d_matches_jax_both_paths(impl, with_h0):
    """[T, D] input: the JAX entry point's "jnp" and "pallas" paths agree,
    and the port's two paths match them."""
    J, jnp = jx(), jx().jnp
    rng = np.random.default_rng(3)
    a, b = _rand(rng, (200, 12))
    h0 = rng.standard_normal(12) if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else _t(h0)
    want = np.asarray(J.lrs(jnp.asarray(a), jnp.asarray(b), h0=jh0,
                            combine_impl=impl))
    got = linear_recurrence_scan(_t(a), _t(b), h0=th0, combine_impl=impl)
    np.testing.assert_allclose(_np(got), want, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("shape", [(50,), (1,), (50, 3, 4), (64, 2, 5, 3)])
@pytest.mark.parametrize("impl", ["jnp", "fused", "pallas", "pallas:gpu"])
def test_any_rank_matches_jax_jnp(shape, impl):
    """Every rank, every port path: the states along the leading axis, as
    the JAX "jnp" path (and the docstring) computes them."""
    J, jnp = jx(), jx().jnp
    rng = np.random.default_rng(len(shape))
    a, b = _rand(rng, shape)
    h0 = rng.standard_normal(shape[1:])
    want = np.asarray(J.lrs(jnp.asarray(a), jnp.asarray(b),
                            h0=jnp.asarray(h0), combine_impl="jnp"))
    got = linear_recurrence_scan(_t(a), _t(b), h0=_t(h0), combine_impl=impl)
    assert got.shape == shape
    np.testing.assert_allclose(_np(got), want, rtol=1e-9, atol=1e-10)


def test_jax_pallas_path_scans_wrong_axis_for_3d():
    """Reference fault (recorded in ROADMAP C): the JAX "pallas" path reads
    a 3-D ``[T, ...]`` input as ``[B, T, D]``. The port follows the
    docstring and matches the JAX "jnp" path instead."""
    J, jnp = jx(), jx().jnp
    a, b = _rand(np.random.default_rng(0), (50, 3, 4))
    jnp_path = np.asarray(J.lrs(jnp.asarray(a), jnp.asarray(b),
                                combine_impl="jnp"))
    pallas_path = np.asarray(J.lrs(jnp.asarray(a), jnp.asarray(b),
                                   combine_impl="pallas"))
    assert np.abs(pallas_path - jnp_path).max() > 1.0
    got = linear_recurrence_scan(_t(a), _t(b), combine_impl="pallas")
    np.testing.assert_allclose(_np(got), jnp_path, rtol=1e-9, atol=1e-10)


def test_linear_recurrence_scan_rejects():
    a = torch.ones(4, 2, dtype=torch.float64)
    # No mesh around the call: the axis is unbound (the sharded scan on a
    # mesh is held in test_torch_mesh_scan.py).
    with pytest.raises(NameError, match="unbound axis name: 'seq'"):
        linear_recurrence_scan(a, a, axis_name="seq")
    with pytest.raises(ValueError):
        linear_recurrence_scan(a, a, combine_impl="bogus")
    with pytest.raises(ValueError, match="tpu"):
        linear_recurrence_scan(a, a, combine_impl="pallas:tpu")


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64, "bfloat16"])
@pytest.mark.parametrize("B,T,D", [(1, 1, 1), (3, 257, 40), (1, 4096, 16),
                                   (2, 100, 130), (2, 0, 8), (2, 1000, 3),
                                   (1, 600, 32768)])
def test_kernel_matches_plain_on_card(cuda, dtype, B, T, D):
    """The kernel against the plain version, from one channel to many and
    from few channels with a long T to many with a short one."""
    a, b = _rand(np.random.default_rng(B + T + D), (B, T, D))
    ta, tb = _t(a, dtype, cuda), _t(b, dtype, cuda)
    before = kss.LAUNCHES["ssm_scan"]
    got = kss.ssm_scan_cuda(ta, tb)
    torch.cuda.synchronize()
    assert kss.LAUNCHES["ssm_scan"] == before + (1 if B * T * D else 0)
    assert got.dtype == ta.dtype and got.shape == ta.shape
    np.testing.assert_allclose(_np(got), _np(kss.ssm_scan_plain(ta, tb)),
                               **TOL[dtype])


@pytest.mark.cuda
def test_entry_point_launches_kernel_on_card(cuda):
    rng = np.random.default_rng(7)
    a, b = _rand(rng, (300, 2, 5, 3))
    h0 = rng.standard_normal((2, 5, 3))
    before = kss.LAUNCHES["ssm_scan"]
    got = linear_recurrence_scan(_t(a, device=cuda), _t(b, device=cuda),
                                 h0=_t(h0, device=cuda), combine_impl="pallas")
    torch.cuda.synchronize()
    assert kss.LAUNCHES["ssm_scan"] == before + 1
    want = linear_recurrence_scan(_t(a), _t(b), h0=_t(h0))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[np.float64])


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda):
    a = torch.rand(2, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="non-contiguous"):
        kss.ssm_scan_cuda(a.mT.contiguous().mT, a)
    with pytest.raises(TypeError):
        kss.ssm_scan_cuda(a.half(), a.half())
