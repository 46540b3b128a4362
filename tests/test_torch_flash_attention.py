"""Port parity: blocked causal GQA attention (kernel flash_attention).

The port's plain version (through ``ops.flash_attention`` on CPU tensors)
is held against the JAX package's Pallas kernel
``flash_attention_batched`` in interpret mode (as the JAX suite runs it on
the CPU) on the JAX suite's cases — prefill MHA/GQA/MQA/padding, decode
Tq in {1, 7}, non-causal, block sizes, scale — at the suite's TOL, and the
port's oracle against the JAX oracle. For Tq > Tk (causal rows that see
no key) the port follows the oracle ``attention_ref``, not the JAX kernel,
which averages its block padding there; one test pins that difference.
A sliding window (the plain version's and the kernels' ``window``) is
held against the JAX model's ``blockwise_causal_attention(window=...)``.
The split-K decode kernel's two passes (per-split partials, then the
merge) are mirrored by a test-only plain function, held against the JAX
kernel and the oracle, and the dispatch between the three CUDA kernels is
a function of shapes and type, checked here. The CUDA kernels run only on
a card: those tests carry the `cuda` marker and skip here. JAX is imported on first use, not at module level, so on a
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
from _torch_jax import release_jax_caches  # noqa: F401


@functools.lru_cache(maxsize=None)
def jx():
    """The JAX side: ``jnp``, the oracle ``ref`` and the Pallas kernel."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ref as jref
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention_batched
    from repro.models.attention import blockwise_causal_attention

    return types.SimpleNamespace(jnp=jnp, ref=jref,
                                 pallas=flash_attention_batched,
                                 blockwise=blockwise_causal_attention)


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
# Sliding window
# ---------------------------------------------------------------------------

def _jax_windowed(arrays, dtype, window, chunk):
    """The JAX model's ``blockwise_causal_attention`` on ``[B, H, T, Dh]``
    arrays, k/v expanded to the query heads by the GQA map."""
    jnp = jx().jnp
    q, k, v = _jax(arrays, dtype)
    g = q.shape[1] // k.shape[1]
    k, v = jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1)
    out = jx().blockwise(*(x.transpose(0, 2, 1, 3) for x in (q, k, v)),
                         chunk=chunk, window=window)
    return out.transpose(0, 2, 1, 3)


#: (B, Hq, Hkv, T, Dh, window, JAX chunk, plain block_q/block_k): a
#: window of one key, windows inside, across and past a block, hymba's
#: GQA group of 5, and a window past T (plain causal attention).
WINDOW_CASES = [(2, 4, 2, 100, 16, 1, 32, 32),
                (1, 6, 2, 100, 32, 16, 32, 16),
                (1, 10, 2, 130, 64, 33, 64, 128),
                (1, 10, 2, 150, 16, 100, 64, 32),
                (2, 4, 1, 96, 16, 64, 32, 64),
                (1, 2, 2, 64, 16, 200, 64, 16)]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,Dh,window,chunk,block", WINDOW_CASES)
def test_window_matches_jax_blockwise(B, Hq, Hkv, T, Dh, window, chunk,
                                      block, dtype):
    arrays = _rand_qkv(np.random.default_rng(T + window), B, Hq, Hkv, T, T,
                       Dh)
    want = _jax_windowed(arrays, dtype, window, chunk)
    tq = _torch(arrays, dtype)
    got = kfa.flash_attention_cuda(*tq, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    blocked = kfa.flash_attention_plain(*tq, window=window, block_q=block,
                                        block_k=block)
    np.testing.assert_allclose(_np(blocked), _np(want), **TOL[dtype])
    if window >= T:
        np.testing.assert_array_equal(_np(blocked), _np(
            kfa.flash_attention_plain(*tq, block_q=block, block_k=block)))


def test_window_skips_whole_blocks_below_it():
    """Key blocks wholly below the window are never visited: NaN keys
    there change nothing."""
    arrays = _rand_qkv(np.random.default_rng(1), 1, 4, 2, 256, 256, 16)
    q, k, v = _torch(arrays, np.float32)
    want = kfa.flash_attention_plain(q, k, v, window=64, block_q=64,
                                     block_k=64)
    k[:, :, :64], v[:, :, :64] = float("nan"), float("nan")
    got = kfa.flash_attention_plain(q, k, v, window=64, block_q=64,
                                    block_k=64)
    assert torch.isnan(got[:, :, :128]).any()
    np.testing.assert_array_equal(_np(got[:, :, 128:]),
                                  _np(want[:, :, 128:]))


def test_bad_windows_raise():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention_plain(q, q, q, window=-1)
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention_cuda(q, q, q, window=2, causal=False)


# ---------------------------------------------------------------------------
# The decode kernel's algorithm: per-split partials, then the merge
# ---------------------------------------------------------------------------

_LOG2E = 1.4426950408889634


def _split_k_decode(q, k, v, *, causal, split):
    """What ``csrc/flash_attention.cu``'s decode and merge kernels compute,
    in float32 tensor ops: the keys in splits of ``split``; per split and
    query row, m = the max of the log2-scaled scores (causally masked ones
    at -1e30), l = sum exp2(s - m) and acc = sum exp2(s - m) v; then each
    split weighted by exp2(m - max m) and the sum divided by the weighted
    l (a row with no key in any split: every weight 1, the Tk-average)."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1:3]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, Dh)
    qpos = (Tk - Tq) + torch.arange(Tq)[:, None]
    ms, ls, accs = [], [], []
    for s0 in range(0, Tk, split):
        ks, vs = k[:, :, None, s0:s0 + split].float(), \
            v[:, :, None, s0:s0 + split].float()
        s = (qf @ ks.mT) * (Dh ** -0.5 * _LOG2E)
        if causal:
            kpos = torch.arange(s0, s0 + ks.shape[3])[None, :]
            s = torch.where(qpos >= kpos, s, s.new_tensor(-1e30))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(p @ vs)
    m_all = torch.stack(ms)
    w = torch.exp2(m_all - m_all.amax(dim=0))
    l = (w * torch.stack(ls)).sum(dim=0)
    acc = (w * torch.stack(accs)).sum(dim=0)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(B, Hq, Tq, Dh).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _decode_case(Tq, Tk, Hq, Hkv):
    """Inputs and the JAX kernel's output (interpret mode) for one decode
    shape, and the JAX oracle's."""
    arrays = _rand_qkv(np.random.default_rng(Tq * 1000 + Tk + Hq), 2, Hq,
                       Hkv, Tq, Tk, 32)
    jq = _jax(arrays, np.float32)
    pallas = None
    if Tq <= Tk:  # the JAX kernel averages its padding for rows seeing no key
        pallas = _np(jx().pallas(*jq, causal=True, block_q=32, block_k=32,
                                 interpret=True))
    return arrays, pallas, _np(jx().ref.attention_ref(*jq, causal=True))


@pytest.mark.parametrize("Hq,Hkv", [(6, 2), (4, 1)])  # GQA group 3, MQA
@pytest.mark.parametrize("split", [4, 64, 256])
@pytest.mark.parametrize("Tk", [1, 300, 513])
@pytest.mark.parametrize("Tq", [1, 7])
def test_split_k_decode_matches_jax(Tq, Tk, split, Hq, Hkv):
    """Ragged last splits (300 = 4 x 64 + 44, 513 = 2 x 256 + 1), splits
    fully masked for some rows (split 4: row 0 of Tq=7 sees no key of the
    last split) and rows seeing no key at all (Tq=7 > Tk=1, against the
    oracle)."""
    arrays, pallas, oracle = _decode_case(Tq, Tk, Hq, Hkv)
    got = _np(_split_k_decode(*_torch(arrays, np.float32), causal=True,
                              split=split))
    np.testing.assert_allclose(got, oracle, **TOL[np.float32])
    if pallas is not None:
        np.testing.assert_allclose(got, pallas, **TOL[np.float32])
    np.testing.assert_allclose(got, _np(ref.attention_ref(
        *_torch(arrays, np.float32), causal=True)), **TOL[np.float32])


@pytest.mark.parametrize("shape,dtype,kernel", [
    ((16, 24, 8, 1, 4096, 128), torch.bfloat16, "decode"),
    ((2, 4, 2, 7, 128, 64), torch.float32, "decode"),   # 14 rows
    ((2, 4, 2, 7, 128, 64), torch.bfloat16, "wgmma"),
    ((2, 4, 2, 4, 128, 64), torch.bfloat16, "decode"),  # 8 rows
    ((2, 4, 2, 7, 128, 256), torch.bfloat16, "decode"),
    ((1, 16, 1, 1, 50, 16), torch.float32, "decode"),    # MQA, 16 rows
    ((1, 17, 1, 1, 50, 16), torch.float32, "fma"),       # 17 rows
    ((3, 6, 2, 7, 300, 64), torch.bfloat16, "wgmma"),    # 21 rows
    ((2, 24, 8, 4096, 4096, 128), torch.bfloat16, "wgmma"),
    ((1, 4, 2, 100, 100, 64), torch.bfloat16, "wgmma"),
    ((1, 4, 2, 100, 100, 32), torch.bfloat16, "fma"),
    ((1, 4, 2, 100, 100, 256), torch.bfloat16, "fma"),
    ((2, 24, 8, 4096, 4096, 128), torch.float32, "fma"),
])
def test_kernel_dispatch(shape, dtype, kernel):
    B, Hq, Hkv, Tq, Tk, Dh = shape
    q = torch.empty((B, Hq, Tq, Dh), dtype=dtype, device="meta")
    k = torch.empty((B, Hkv, Tk, Dh), dtype=dtype, device="meta")
    assert kfa.select_kernel(q, k) == kernel


@pytest.mark.parametrize("B,Hkv,Tk,want", [
    (16, 8, 4096, 512),   # 1,024 CTAs of 512 keys
    (1, 8, 4096, 64),     # 512 CTAs of 64 keys: as many as it gets
    (4, 8, 4096, 128),    # 256 keys give 512 CTAs (< 4 x 132): 1,024
    (1, 1, 300, 64)])
def test_decode_split_keys(B, Hkv, Tk, want):
    assert kfa.decode_split_keys(B, Hkv, Tk, 132) == want


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: Card cases: (B, Hq, Hkv, Tq, Tk, Dh, causal). Every kernel serves some
#: of them in each dtype it takes (`test_card_cases_reach_every_kernel`).
CARD_CASES = [
    (2, 4, 2, 96, 96, 64, True), (1, 8, 1, 100, 100, 128, True),
    (3, 4, 2, 1, 300, 32, True), (1, 2, 2, 64, 80, 16, False),
    (1, 2, 1, 40, 24, 16, True), (1, 4, 2, 70, 70, 256, True),
    # bf16 wgmma at both head dims, ragged and long T
    (1, 4, 2, 100, 100, 64, True), (1, 4, 2, 130, 130, 64, True),
    (1, 4, 2, 130, 130, 128, True), (1, 2, 1, 4096, 4096, 64, True),
    (1, 2, 1, 4096, 4096, 128, True),
    (1, 2, 2, 100, 230, 128, False),    # non-causal
    (1, 24, 1, 200, 200, 128, True),    # MQA
    (1, 6, 2, 300, 200, 64, True),      # Tq > Tk
    # decode (group 3): Tk 1 (no key for rows 0-3 of Tq=5), ragged, long
    (2, 6, 2, 1, 1, 128, True), (2, 6, 2, 5, 1, 64, True),
    (2, 6, 2, 1, 300, 128, True), (2, 6, 2, 2, 300, 64, True),
    (2, 6, 2, 5, 300, 64, True), (1, 8, 1, 2, 1, 64, True),
    (4, 24, 8, 1, 4096, 128, True), (2, 4, 1, 4, 777, 256, False),
]


def _expected_kernel(dtype, Hq, Hkv, Tq, Dh):
    rows = Hq // Hkv * Tq
    if dtype == "bfloat16" and Dh in (64, 128):
        return "decode" if rows <= 8 else "wgmma"
    return "decode" if rows <= 16 else "fma"


def test_card_cases_reach_every_kernel():
    for dtype, kernels in (("bfloat16", {"decode", "wgmma", "fma"}),
                           (np.float32, {"decode", "fma"})):
        assert {_expected_kernel(dtype, c[1], c[2], c[3], c[5])
                for c in CARD_CASES} == kernels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,Dh,causal", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda, dtype, B, Hq, Hkv, Tq, Tk, Dh,
                                      causal):
    """The kernel the dispatch picks — and only it — serves the call, and
    agrees with the plain version and the oracle."""
    arrays = _rand_qkv(np.random.default_rng(Tq + Dh), B, Hq, Hkv, Tq, Tk,
                       Dh)
    tq = _torch(arrays, dtype, cuda)
    kernel = _expected_kernel(dtype, Hq, Hkv, Tq, Dh)
    before = dict(kfa.LAUNCHES)
    got = ops.flash_attention(*tq, causal=causal)
    torch.cuda.synchronize()
    assert {k: kfa.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == kfa.KERNEL_COUNTERS[kernel]) for k in before}
    want = kfa.flash_attention_plain(*tq, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref.attention_ref(
        *tq, causal=causal)), **TOL[dtype])


def _force_split(monkeypatch, split):
    monkeypatch.setattr(kfa, "DECODE_MAX_SPLIT", split)
    monkeypatch.setattr(kfa, "DECODE_MIN_SPLIT", split)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 7, 64, 512])
def test_decode_splits_on_card(cuda, monkeypatch, split):
    """Any split size gives the plain version's output (ragged last
    splits, splits fully masked for some rows)."""
    _force_split(monkeypatch, split)
    arrays = _rand_qkv(np.random.default_rng(split), 2, 6, 2, 5, 300, 64)
    tq = _torch(arrays, np.float32, cuda)
    got = kfa.flash_attention_cuda(*tq, kernel="decode")
    np.testing.assert_allclose(_np(got), _np(kfa.flash_attention_plain(*tq)),
                               **TOL[np.float32])


@pytest.mark.cuda
def test_failed_launches_raise_on_card(cuda, monkeypatch):
    """A kernel that cannot take its inputs raises; nothing falls back."""
    q = torch.zeros(1, 6, 1, 64, device=cuda)
    with monkeypatch.context() as m:
        _force_split(m, 1024)  # over the kernel's 512-key limit
        with pytest.raises(RuntimeError, match="decode kernel launch failed"):
            kfa.flash_attention_cuda(q, q[:, :2], q[:, :2])
    q = torch.zeros(1, 65536, 1, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 1, 64, device=cuda, dtype=torch.bfloat16)
    before = dict(kfa.LAUNCHES)
    with pytest.raises(RuntimeError, match="wgmma kernel launch failed"):
        kfa.flash_attention_cuda(q, k, k)  # grid out of range (Hq > 65535)
    with pytest.raises(RuntimeError, match="fma kernel launch failed"):
        kfa.flash_attention_cuda(q.float(), k.float(), k.float())
    assert kfa.LAUNCHES == before
    q = torch.zeros(1, 8, 100, 64, device=cuda)
    with pytest.raises(ValueError, match="wgmma"):
        kfa.flash_attention_cuda(q, q, q, kernel="wgmma")  # float32
    with pytest.raises(ValueError, match="decode"):
        kfa.flash_attention_cuda(q, q, q, kernel="decode")  # 100 rows


#: Windowed card cases: (B, Hq, Hkv, Tq, Tk, Dh, window). hymba-1.5b's
#: head layout (25 query heads, 5 kv heads, Dh 64) in prefill and decode,
#: a wgmma prefill whose early Q tiles skip whole key tiles (window 1024 at
#: T = 1100, Dh 128), a window of one key, windowed rows seeing no key
#: (Tq > Tk), decode rows over splits below the window, and a window past
#: T.
WINDOW_CARD_CASES = [(1, 25, 5, 300, 300, 64, 128),
                     (2, 25, 5, 1, 300, 64, 128),
                     (2, 6, 2, 5, 300, 64, 7),
                     (1, 4, 2, 1100, 1100, 128, 1024),
                     (1, 4, 2, 260, 260, 16, 1),
                     (1, 6, 2, 300, 200, 64, 50),
                     (1, 4, 2, 200, 200, 64, 500)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,Dh,window", WINDOW_CARD_CASES)
def test_window_kernels_match_plain_on_card(cuda, dtype, B, Hq, Hkv, Tq, Tk,
                                            Dh, window):
    """The kernel the dispatch picks serves a windowed call (every one of
    the three in some case) and agrees with the plain version."""
    arrays = _rand_qkv(np.random.default_rng(Tq + window), B, Hq, Hkv, Tq,
                       Tk, Dh)
    tq = _torch(arrays, dtype, cuda)
    kernel = _expected_kernel(dtype, Hq, Hkv, Tq, Dh)
    before = dict(kfa.LAUNCHES)
    got = kfa.flash_attention_cuda(*tq, window=window)
    torch.cuda.synchronize()
    assert {k: kfa.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == kfa.KERNEL_COUNTERS[kernel]) for k in before}
    want = kfa.flash_attention_plain(*tq, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if window < Tk:
        causal = kfa.flash_attention_plain(*tq)
        assert np.abs(_np(causal) - _np(want)).max() > 1e-2


def test_window_card_cases_reach_every_kernel():
    assert {_expected_kernel(d, c[1], c[2], c[3], c[5])
            for c in WINDOW_CARD_CASES for d in ("bfloat16", np.float32)
            } == {"decode", "wgmma", "fma"}


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


# ---------------------------------------------------------------------------
# Decode against a KV cache read in place
# ---------------------------------------------------------------------------

def _split_k_decode_cache(q, k, v, length, *, split):
    """What the decode and merge kernels compute on a cache (k/v [B, Hkv,
    S, Dh], the first min(length, S) rows keys, not causal): the split
    grid covers S; a split starting past the keys contributes m = -inf,
    l = 0, acc = 0 (weight 0 in the merge)."""
    B, Hq, Tq, Dh = q.shape
    Hkv, S = k.shape[1:3]
    L = min(length, S)
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, Dh)
    ms, ls, accs = [], [], []
    for s0 in range(0, S, split):
        if s0 >= L:
            ms.append(qf.new_full(qf.shape[:-1] + (1,), -float("inf")))
            ls.append(torch.zeros_like(ms[-1]))
            accs.append(torch.zeros_like(qf))
            continue
        ks = k[:, :, None, s0:min(s0 + split, L)].float()
        vs = v[:, :, None, s0:min(s0 + split, L)].float()
        s = (qf @ ks.mT) * (Dh ** -0.5 * _LOG2E)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(p @ vs)
    m_all = torch.stack(ms)
    w = torch.exp2(m_all - m_all.amax(dim=0))
    out = (w * torch.stack(accs)).sum(dim=0) / (w * torch.stack(ls)).sum(dim=0)
    return out.reshape(B, Hq, Tq, Dh).to(q.dtype)


#: (B, Hq, Hkv, Tq, S, Dh, length): length 1, S/2, S, a wrapped ring
#: (length > S: every row valid) and a ragged fill.
CACHE_CASES = [(2, 6, 2, 1, 64, 32, 1), (2, 6, 2, 1, 64, 32, 32),
               (2, 6, 2, 1, 64, 32, 64), (2, 6, 2, 1, 64, 32, 100),
               (1, 4, 1, 2, 300, 16, 157)]


@functools.lru_cache(maxsize=None)
def _cache_case(B, Hq, Hkv, Tq, S, Dh, length):
    """Inputs and the JAX model's ``decode_attention`` on them."""
    from repro.models.attention import KVCache, decode_attention

    arrays = _rand_qkv(np.random.default_rng(S + length), B, Hq, Hkv, Tq, S,
                       Dh)
    jnp = jx().jnp
    q, k, v = (jnp.asarray(np.asarray(a, np.float32)) for a in arrays)
    want = decode_attention(q.transpose(0, 2, 1, 3), KVCache(
        k, v, jnp.asarray(length, jnp.int32)))
    return arrays, _np(want.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("split", [4, 16, 512])
@pytest.mark.parametrize("case", CACHE_CASES)
def test_cache_decode_matches_jax(case, split):
    """The plain version (and the kernel wrapper on CPU tensors) and the
    kernels' split-K algorithm over the capacity, splits past the keys
    included, agree with the reference's masked decode softmax."""
    arrays, want = _cache_case(*case)
    q, k, v = _torch(arrays, np.float32)
    length = torch.tensor(case[-1], dtype=torch.int32)
    before = dict(kfa.LAUNCHES)
    got = kfa.decode_attention_cuda(q, k, v, length)
    assert kfa.LAUNCHES == before
    np.testing.assert_allclose(_np(got), want, **TOL[np.float32])
    np.testing.assert_allclose(
        _np(kfa.decode_attention_plain(q, k, v, length)), want,
        **TOL[np.float32])
    np.testing.assert_allclose(
        _np(_split_k_decode_cache(q, k, v, case[-1], split=split)), want,
        **TOL[np.float32])


def test_cache_decode_rejects_bad_length():
    q = torch.zeros(1, 2, 1, 16)
    k = torch.zeros(1, 1, 8, 16)
    with pytest.raises(TypeError, match="int32"):
        kfa.decode_attention_cuda(q, k, k, torch.tensor(3))
    with pytest.raises(TypeError, match="int32"):
        kfa.decode_attention_cuda(q, k, k, torch.tensor([3, 4],
                                                        dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("case", CACHE_CASES + [
    (4, 12, 2, 1, 512, 128, 1), (4, 12, 2, 1, 512, 128, 256),
    (4, 12, 2, 1, 512, 128, 512), (4, 12, 2, 1, 512, 128, 700),
    (3, 24, 8, 1, 1000, 64, 999), (2, 8, 1, 1, 40, 256, 17)])
def test_cache_decode_kernel_on_card(cuda, dtype, case):
    """The decode kernel reads the cache in place (one launch, length on
    the card) and agrees with the plain version, on a layer's slice of a
    stacked cache as on a cache of its own."""
    arrays = _rand_qkv(np.random.default_rng(case[4] + case[-1]),
                       *case[:-1])
    q, k, v = _torch(arrays, dtype, cuda)
    length = torch.tensor(case[-1], dtype=torch.int32, device=cuda)
    want = kfa.decode_attention_plain(q, k, v, length)
    before = kfa.LAUNCHES["flash_attention_decode"]
    got = kfa.decode_attention_cuda(q, k, v, length)
    torch.cuda.synchronize()
    assert kfa.LAUNCHES["flash_attention_decode"] == before + 1
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    stacked_k = torch.stack([torch.zeros_like(k), k, torch.zeros_like(k)])
    stacked_v = torch.stack([torch.zeros_like(v), v, torch.zeros_like(v)])
    lengths = torch.tensor([0, case[-1], 0], dtype=torch.int32, device=cuda)
    got = kfa.decode_attention_cuda(q, stacked_k[1], stacked_v[1],
                                    lengths[1])
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 7, 64, 512])
def test_cache_decode_splits_on_card(cuda, monkeypatch, split):
    """Any split size, splits past the keys included."""
    _force_split(monkeypatch, split)
    arrays = _rand_qkv(np.random.default_rng(split), 2, 6, 2, 1, 300, 64)
    q, k, v = _torch(arrays, np.float32, cuda)
    for length in (1, 150, 300, 301):
        n = torch.tensor(length, dtype=torch.int32, device=cuda)
        np.testing.assert_allclose(
            _np(kfa.decode_attention_cuda(q, k, v, n)),
            _np(kfa.decode_attention_plain(q, k, v, n)), **TOL[np.float32])


@pytest.mark.cuda
def test_cache_decode_rejects_bad_inputs_on_card(cuda):
    q = torch.zeros(1, 17, 1, 64, device=cuda)
    k = torch.zeros(1, 1, 8, 64, device=cuda)
    n = torch.tensor(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rows per kv head"):
        kfa.decode_attention_cuda(q, k, k, n)
    with pytest.raises(ValueError, match="head_dim"):
        kfa.decode_attention_cuda(q[..., :48].contiguous(),
                                  k[..., :48].contiguous(),
                                  k[..., :48].contiguous(), n)
    with pytest.raises(ValueError, match="non-contiguous"):
        kfa.decode_attention_cuda(q[:, :2], k.mT.contiguous().mT, k, n)
    with pytest.raises(TypeError, match="device"):
        kfa.decode_attention_cuda(q[:, :2], k, k, n.cpu())


#: The encoder-decoder's cross-attention shapes (seamless-m4t-medium: 16/16
#: heads, Dh 64, a memory of 1,024 keys), non-causal on contiguous k/v that
#: are no cache: (B, Tq, kernel). Prefill takes the ``wgmma`` kernel, a
#: decode step (1 row per kv head) the split-K decode kernel.
CROSS_CARD_CASES = [(2, 256, "wgmma"), (4, 1, "decode")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,kernel", CROSS_CARD_CASES)
def test_cross_attention_shapes_on_card(cuda, B, Tq, kernel):
    """bf16 q against a 1,024-key memory, non-causal: the expected kernel
    alone serves the call, within the tight bf16 bound of the plain
    version in float32 on the same values, 2^-8 (sum_j p_j |v_j| / l +
    |o|) + 1e-5 (the weights and the output each rounded to bf16 once).
    q is scaled by 4 so that each row's weights peak on a few keys."""
    rng = np.random.default_rng(B + Tq)
    arrays = _rand_qkv(rng, B, 16, 16, Tq, 1024, 64)
    arrays = (arrays[0] * 4,) + tuple(arrays[1:])
    q, k, v = _torch(arrays, "bfloat16", cuda)
    assert kfa.select_kernel(q, k) == kernel
    before = dict(kfa.LAUNCHES)
    got = kfa.flash_attention_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert {n: kfa.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n == kfa.KERNEL_COUNTERS[kernel]) for n in before}
    qf, kf, vf = q.float(), k.float(), v.float()
    want = kfa.flash_attention_plain(qf, kf, vf, causal=False)
    tol = 2.0 ** -8 * (kfa.flash_attention_plain(qf, kf, vf.abs(),
                                                 causal=False)
                       + want.abs()) + 1e-5
    assert float(((got.float() - want).abs() / tol).amax()) <= 1.0
