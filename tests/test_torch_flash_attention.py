"""Port parity: blocked causal GQA attention (kernel flash_attention).

The port's plain version (through ``ops.flash_attention`` on CPU tensors)
is held against the JAX package's Pallas kernel
``flash_attention_batched`` in interpret mode (as the JAX suite runs it on
the CPU) on the JAX suite's cases — prefill MHA/GQA/MQA/padding, decode
Tq in {1, 7}, non-causal, block sizes, scale — at the suite's TOL, and the
port's oracle against the JAX oracle. For Tq > Tk (causal rows that see
no key) the port follows the oracle ``attention_ref``, not the JAX kernel,
which averages its block padding there; one test pins that difference.
The CUDA kernel runs only on a card: those tests carry the `cuda` marker
and skip here. JAX is imported on first use, not at module level, so on a
card's machine without JAX the marked tests run with
``pytest --noconftest -m cuda``.
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as kfa
from repro_torch.kernels.flash_attention import ops, ref


@functools.lru_cache(maxsize=None)
def jx():
    """The JAX side: ``jnp``, the oracle ``ref`` and the Pallas kernel."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ref as jref
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention_batched

    return types.SimpleNamespace(jnp=jnp, ref=jref,
                                 pallas=flash_attention_batched)


TOL = {np.float32: dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _rand_qkv(rng, B, Hq, Hkv, Tq, Tk, Dh):
    return (rng.standard_normal((B, Hq, Tq, Dh)),
            rng.standard_normal((B, Hkv, Tk, Dh)),
            rng.standard_normal((B, Hkv, Tk, Dh)))


def _jax(arrays, dtype):
    jnp = jx().jnp
    jdt = jnp.bfloat16 if dtype == "bfloat16" else dtype
    return [jnp.asarray(np.asarray(x, np.float32), jdt) for x in arrays]


def _torch(arrays, dtype, device="cpu"):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [torch.tensor(np.asarray(x, np.float32), device=device).to(tdt)
            for x in arrays]


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy() if
                      isinstance(x, torch.Tensor) else x, np.float32)


def _check_vs_pallas(arrays, dtype, *, causal=True, scale=None, bq=32,
                     bk=32):
    want = jx().pallas(*_jax(arrays, dtype), causal=causal, scale=scale,
                       block_q=bq, block_k=bk, interpret=True)
    tq = _torch(arrays, dtype)
    before = dict(kfa.LAUNCHES)
    got = ops.flash_attention(*tq, causal=causal, scale=scale, block_q=bq,
                              block_k=bk)
    assert kfa.LAUNCHES == before
    assert got.dtype == tq[0].dtype and got.shape == tq[0].shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("B,Hq,Hkv,T,Dh", [
    (1, 2, 2, 64, 32),     # MHA
    (2, 4, 2, 96, 64),     # GQA 2:1
    (1, 8, 1, 128, 64),    # MQA
    (1, 2, 2, 100, 64),    # non-multiple sequence (padding path)
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_prefill_causal(B, Hq, Hkv, T, Dh, dtype):
    rng = np.random.default_rng(T + Hq)
    _check_vs_pallas(_rand_qkv(rng, B, Hq, Hkv, T, T, Dh), dtype)


@pytest.mark.parametrize("Tq,Tk", [(1, 128), (1, 100), (7, 128)])
def test_decode_right_aligned(Tq, Tk):
    rng = np.random.default_rng(Tq + Tk)
    _check_vs_pallas(_rand_qkv(rng, 2, 4, 2, Tq, Tk, 64), np.float32)


def test_non_causal():
    rng = np.random.default_rng(9)
    _check_vs_pallas(_rand_qkv(rng, 1, 2, 2, 64, 80, 32), np.float32,
                     causal=False, bq=16, bk=32)


@pytest.mark.parametrize("bq,bk", [(16, 16), (32, 64), (128, 32)])
def test_block_size_invariance(bq, bk):
    rng = np.random.default_rng(11)
    _check_vs_pallas(_rand_qkv(rng, 1, 2, 1, 128, 128, 64), np.float32,
                     bq=bq, bk=bk)


def test_softmax_scale_override():
    rng = np.random.default_rng(13)
    _check_vs_pallas(_rand_qkv(rng, 1, 1, 1, 32, 32, 16), np.float32,
                     scale=0.5, bq=16, bk=16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,Dh", [
    (1, 2, 2, 64, 64, 32), (2, 6, 2, 7, 50, 16), (1, 4, 1, 40, 24, 16)])
def test_ref_matches_jax_ref(B, Hq, Hkv, Tq, Tk, Dh, dtype, causal):
    arrays = _rand_qkv(np.random.default_rng(Tq * Tk), B, Hq, Hkv, Tq, Tk,
                       Dh)
    want = jx().ref.attention_ref(*_jax(arrays, dtype), causal=causal)
    got = ops.attention_ref(*_torch(arrays, dtype), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("bq,bk", [(16, 16), (32, 8), (128, 128)])
def test_rows_seeing_no_key_follow_the_oracle(bq, bk):
    """Causal with Tq > Tk: the first Tq - Tk rows see no key and average
    v over the Tk keys, as `attention_ref` does, at every block size."""
    arrays = _rand_qkv(np.random.default_rng(0), 1, 2, 1, 40, 24, 16)
    want = _np(jx().ref.attention_ref(*_jax(arrays, np.float32), causal=True))
    got = _np(ops.flash_attention(*_torch(arrays, np.float32), causal=True,
                                  block_q=bq, block_k=bk))
    np.testing.assert_allclose(got, want, **TOL[np.float32])
    np.testing.assert_allclose(got[:, :, :16], np.broadcast_to(
        arrays[2].mean(axis=2, keepdims=True), (1, 2, 16, 16)),
        **TOL[np.float32])


def test_jax_kernel_averages_its_padding_for_rows_seeing_no_key():
    """Reference fault (recorded in ROADMAP C): at Tq=40, Tk=24, bq=bk=16
    the JAX kernel's rows 0-15 average v over 32 padded keys, zeros
    included; rows 16-39 agree with the oracle."""
    arrays = _rand_qkv(np.random.default_rng(0), 1, 2, 1, 40, 24, 16)
    jq = _jax(arrays, np.float32)
    kernel = _np(jx().pallas(*jq, causal=True, block_q=16, block_k=16,
                             interpret=True))
    oracle = _np(jx().ref.attention_ref(*jq, causal=True))
    assert np.abs(kernel[:, :, :16] - oracle[:, :, :16]).max() > 1e-2
    np.testing.assert_allclose(kernel[:, :, 16:], oracle[:, :, 16:],
                               **TOL[np.float32])


def test_empty_and_bad_shapes():
    q = torch.zeros(1, 2, 0, 16)
    k = torch.zeros(1, 1, 5, 16)
    assert ops.flash_attention(q, k, k).shape == q.shape
    assert kfa.flash_attention_cuda(q, k, k).shape == q.shape
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention(torch.zeros(1, 3, 4, 16), torch.zeros(1, 2, 4, 16),
                            torch.zeros(1, 2, 4, 16))
    with pytest.raises(ValueError, match="Tk = 0"):
        ops.flash_attention(torch.zeros(1, 2, 4, 16), torch.zeros(1, 1, 0, 16),
                            torch.zeros(1, 1, 0, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros(1, 2, 4, 16), torch.zeros(1, 1, 4, 8),
                            torch.zeros(1, 1, 4, 8))


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,Dh,causal", [
    (2, 4, 2, 96, 96, 64, True), (1, 8, 1, 100, 100, 128, True),
    (3, 4, 2, 1, 300, 32, True), (1, 2, 2, 64, 80, 16, False),
    (1, 2, 1, 40, 24, 16, True), (1, 4, 2, 70, 70, 256, True)])
def test_kernel_matches_plain_on_card(cuda, dtype, B, Hq, Hkv, Tq, Tk, Dh,
                                      causal):
    arrays = _rand_qkv(np.random.default_rng(Tq + Dh), B, Hq, Hkv, Tq, Tk,
                       Dh)
    tq = _torch(arrays, dtype, cuda)
    before = kfa.LAUNCHES["flash_attention"]
    got = ops.flash_attention(*tq, causal=causal)
    torch.cuda.synchronize()
    assert kfa.LAUNCHES["flash_attention"] == before + 1
    want = kfa.flash_attention_plain(*tq, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref.attention_ref(
        *tq, causal=causal)), **TOL[dtype])


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kfa.flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(TypeError):
        kfa.flash_attention_cuda(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="non-contiguous"):
        kfa.flash_attention_cuda(q.mT.contiguous().mT, q, q)
