"""Port parity: the LM substrate's layers (configs, layers, rope, mlp,
attention), each held against the JAX package's function on the same
numpy inputs at the suite's float32 tolerance, on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.configs import reduced_config as jreduced_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro_torch.configs import (get_config, list_configs, reduced_config)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import rope as trope
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
#: bf16 results: one bf16 rounding step (2^-8 relative) apart at most.
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def test_registry_equals_the_reference():
    ours, theirs = list_configs(), jlist_configs()
    assert sorted(ours) == sorted(theirs) and len(ours) == 10
    for name in ours:
        assert dataclasses.asdict(ours[name]) == \
            dataclasses.asdict(theirs[name]), name
        assert dataclasses.asdict(reduced_config(ours[name])) == \
            dataclasses.asdict(jreduced_config(theirs[name])), name
        for prop in ("resolved_head_dim", "padded_heads", "padded_vocab",
                     "shard_kv_heads", "d_ff_per_expert"):
            assert getattr(ours[name], prop) == getattr(theirs[name], prop)
        assert ours[name].param_count() == theirs[name].param_count()
        assert ours[name].active_param_count() == \
            theirs[name].active_param_count()


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


# ---------------------------------------------------------------------------
# Layers and rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    """The mean square in float32, the multiply in the input dtype: in
    bf16 both packages round at the same places."""
    rng = _rng(0)
    x = rng.standard_normal((3, 5, 64)) * 3
    w = 1 + 0.1 * rng.standard_normal(64)
    jdt = jlayers.dtype_of(dtype)
    tdt = tlayers.dtype_of(dtype)
    want = jlayers.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-5)
    got = tlayers.rms_norm(_t(x, tdt), _t(w, tdt), 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want),
                               **(TOL if dtype == "float32" else BF16_TOL))


def test_embedding_and_silu():
    rng = _rng(1)
    table = rng.standard_normal((40, 8))
    ids = rng.integers(0, 40, (3, 7))
    np.testing.assert_allclose(
        _np(tlayers.embedding_lookup(_t(table), torch.tensor(ids))),
        _np(jlayers.embedding_lookup(jnp.asarray(table, jnp.float32),
                                     jnp.asarray(ids))), **TOL)
    x = rng.standard_normal((4, 9)) * 4
    np.testing.assert_allclose(_np(tlayers.silu(_t(x))),
                               _np(jlayers.silu(jnp.asarray(x, jnp.float32))),
                               **TOL)


def test_normal_init_draws_on_the_generators_device():
    gen = torch.Generator(device="cpu").manual_seed(0)
    w = tlayers.normal_init(gen, (256, 64), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 64)
    assert abs(float(w.float().std()) - 0.02) < 2e-3
    lin = tlayers.init_linear(gen, 64, 32, torch.float32, bias=True)
    assert lin.weight.shape == (32, 64) and not lin.bias.abs().any()


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rng = _rng(2)
    q = rng.standard_normal((2, 7, 4, 16))
    k = rng.standard_normal((2, 7, 2, 16))
    pos = rng.integers(0, 500, (2, 7))
    jq, jk = jrope.apply_rope(jnp.asarray(q, jnp.float32),
                              jnp.asarray(k, jnp.float32),
                              jnp.asarray(pos, jnp.int32), theta)
    tq, tk = trope.apply_rope(_t(q), _t(k),
                              torch.tensor(pos, dtype=torch.int32), theta)
    np.testing.assert_allclose(_np(tq), _np(jq), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)


def test_apply_mrope_and_positions():
    rng = _rng(3)
    q = rng.standard_normal((2, 6, 4, 16))
    k = rng.standard_normal((2, 6, 2, 16))
    pos = rng.integers(0, 50, (3, 2, 6))
    jq, jk = jrope.apply_mrope(jnp.asarray(q, jnp.float32),
                               jnp.asarray(k, jnp.float32),
                               jnp.asarray(pos, jnp.int32), 1e6, (4, 2, 2))
    tq, tk = trope.apply_mrope(_t(q), _t(k),
                               torch.tensor(pos, dtype=torch.int32), 1e6,
                               (4, 2, 2))
    np.testing.assert_allclose(_np(tq), _np(jq), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_array_equal(
        trope.text_mrope_positions(2, 5, offset=3).numpy(),
        np.asarray(jrope.text_mrope_positions(2, 5, offset=3)))
    np.testing.assert_array_equal(
        trope.vision_mrope_positions(2, 2, 3, 4).numpy(),
        np.asarray(jrope.vision_mrope_positions(2, 2, 3, 4)))
    # Text positions reduce M-RoPE to RoPE exactly.
    text = trope.text_mrope_positions(2, 6)
    mq, _ = trope.apply_mrope(_t(q), _t(k), text, 1e6, (4, 2, 2))
    rq, _ = trope.apply_rope(_t(q), _t(k), text[0], 1e6)
    torch.testing.assert_close(mq, rq)


def test_mlp():
    rng = _rng(4)
    params, _ = jmlp.init_mlp(jax.random.PRNGKey(0), 32, 48, jnp.float32)
    params = {k: np.asarray(v) for k, v in params.items()}
    x = rng.standard_normal((3, 5, 32))
    want = jmlp.mlp({k: jnp.asarray(v) for k, v in params.items()},
                    jnp.asarray(x, jnp.float32))
    gen = torch.Generator().manual_seed(0)
    block = tmlp.init_mlp(gen, 32, 48, torch.float32)
    block.load_state_dict({f"{k}.weight": _t(v).T for k, v in params.items()})
    np.testing.assert_allclose(_np(tmlp.mlp(block, _t(x))), _np(want), **TOL)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hq_orig,hkv", [(8, 6, 2), (6, 6, 2), (4, 4, 4),
                                            (16, 12, 2)])
def test_expand_kv_heads(hq, hq_orig, hkv):
    rng = _rng(hq)
    k = rng.standard_normal((2, 3, hkv, 8))
    v = rng.standard_normal((2, 3, hkv, 8))
    jk, jv = jattn.expand_kv_heads(jnp.asarray(k), jnp.asarray(v), hq,
                                   hq_orig)
    tk, tv = tattn.expand_kv_heads(_t(k), _t(v), hq, hq_orig)
    np.testing.assert_array_equal(_np(tk), _np(jk))
    np.testing.assert_array_equal(_np(tv), _np(jv))


@pytest.mark.parametrize("T,chunk,window,causal,softcap", [
    (50, 16, 0, True, 0.0),      # T not a multiple of the chunk
    (50, 16, 20, True, 0.0),     # sliding window
    (33, 8, 0, False, 0.0),      # non-causal
    (40, 16, 0, True, 5.0)])     # logit softcap
def test_blockwise_causal_attention(T, chunk, window, causal, softcap):
    rng = _rng(T + chunk)
    q, k, v = (rng.standard_normal((2, T, 4, 16)) for _ in range(3))
    want = jattn.blockwise_causal_attention(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)), chunk=chunk,
        window=window, softcap=softcap, causal=causal)
    before = tattn.PLAIN_CALLS["blockwise_causal_attention"]
    got = tattn.blockwise_causal_attention(
        _t(q), _t(k), _t(v), chunk=chunk, window=window, softcap=softcap,
        causal=causal)
    assert tattn.PLAIN_CALLS["blockwise_causal_attention"] == before + 1
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("length,softcap", [(1, 0.0), (5, 0.0), (16, 0.0),
                                            (9, 3.0)])
def test_decode_attention_partly_filled_cache(length, softcap):
    """Rows at or past ``length`` hold garbage and must not count."""
    rng = _rng(length)
    q = rng.standard_normal((2, 1, 6, 16))
    k, v = (rng.standard_normal((2, 2, 16, 16)) * 5 for _ in range(2))
    jc = jattn.KVCache(jnp.asarray(k, jnp.float32),
                       jnp.asarray(v, jnp.float32),
                       jnp.asarray(length, jnp.int32))
    want = jattn.decode_attention(jnp.asarray(q, jnp.float32), jc,
                                  softcap=softcap)
    tc = tattn.KVCache(_t(k), _t(v), torch.tensor(length, dtype=torch.int32))
    got = tattn.decode_attention(_t(q), tc, softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_update_cache_linear_and_ring(window):
    """12 steps into 8 rows: the linear cache overwrites its last row,
    the ring (``reduced_config(cfg, sliding_window=8)``) wraps."""
    jcfg = jreduced_config(jget_config("qwen2-1.5b"), sliding_window=window)
    cfg = reduced_config(get_config("qwen2-1.5b"), sliding_window=window)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jc = jattn.init_kv_cache(jcfg, 2, 8, jnp.float32)
    tc = tattn.init_kv_cache(cfg, 2, 8, torch.float32, "cpu")
    rng = _rng(window)
    for _ in range(12):
        kn, vn = (rng.standard_normal((2, 1, cfg.num_kv_heads, 16))
                  for _ in range(2))
        jc = jattn.update_cache(jc, jnp.asarray(kn, jnp.float32),
                                jnp.asarray(vn, jnp.float32),
                                window=cfg.sliding_window)
        tc = tattn.update_cache(tc, _t(kn), _t(vn),
                                window=cfg.sliding_window)
        np.testing.assert_array_equal(_np(tc.k), _np(jc.k))
        np.testing.assert_array_equal(_np(tc.v), _np(jc.v))
        assert int(tc.length) == int(jc.length)
        assert tc.length.dtype == torch.int32 and tc.length.ndim == 0


def test_attention_impl_on_cpu_runs_the_plain_versions():
    from repro_torch.kernels.flash_attention import flash_attention as kfa

    cfg = reduced_config(get_config("llama3.2-3b"))
    gen = torch.Generator().manual_seed(0)
    layer = tattn.init_attention(cfg, gen, torch.float32)
    x = torch.randn(2, 5, cfg.d_model, generator=gen)
    pos = torch.arange(5).expand(2, 5)
    before, launches = dict(tattn.PLAIN_CALLS), dict(kfa.LAUNCHES)
    out, cache = tattn.attention_layer(layer, x, cfg, pos)
    assert cache is None and out.shape == x.shape
    cache = tattn.init_kv_cache(cfg, 2, 8, torch.float32, "cpu")
    _, cache = tattn.attention_layer(layer, x[:, :1], cfg, pos[:, :1],
                                     cache=cache)
    assert int(cache.length) == 1
    assert {k: tattn.PLAIN_CALLS[k] - before[k] for k in before} == {
        "blockwise_causal_attention": 1, "decode_attention": 1,
        "chunked_cross": 0}
    assert kfa.LAUNCHES == launches
    with pytest.raises(ValueError, match="impl"):
        tattn.attention_layer(layer, x, cfg, pos, impl="kernel")
