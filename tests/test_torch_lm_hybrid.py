"""Port parity: the hybrid LM family (Hymba: attention and a selective SSM
in every block). On ``reduced_config(hymba-1.5b)`` (4 layers, global
layers 0 and 3, a 32-row sliding window in layers 1-2, SSM state 8, scan
chunks of 32) the JAX ``init_model`` parameters, with the norms and the
SSM's ``dt_bias``, ``A_log`` and ``D`` perturbed so that every leaf
matters, are carried across with ``convert.lm_params``. Held against the
JAX package at the suite's float32 tolerance: ``ssm_layer`` in prefill
(T not a multiple of the chunk) and in one decode step from a nonzero
cache, the hybrid ``apply_block`` in both modes, ``prefill`` and 44
teacher-forced ``decode_step``s (the windowed layers' rings wrap at 32),
and the greedy tokens of the service. On the card (marker ``cuda``) the
SSM prefill on the ``ssm_scan`` kernel is held against the plain scan.
JAX is imported on first use, not at module level, so on a card's
machine without JAX the marked tests run with ``pytest --noconftest -m
cuda``."""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.ssm_scan import ssm_scan as kss
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import decode_step, init_caches, init_model, prefill
from repro_torch.models import ssm as tssm
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
ARCH = "hymba-1.5b"
#: Batch, prompt length (not a multiple of the 32-step chunk), decode
#: steps past the ring's wrap at 32, cache capacity.
B, T, STEPS, S = 2, 45, 44, 48


@functools.lru_cache(maxsize=None)
def jx():
    """The JAX side: ``jax``, ``jnp``, the configs, models and service."""
    import jax
    import jax.numpy as jnp

    from repro import configs, models
    from repro.launch import serve
    from repro.models import attention, blocks, ssm

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 models=models, attention=attention,
                                 blocks=blocks, ssm=ssm, serve=serve)


def _perturb(rng, a, scale=0.1, base=0.0):
    return (base + a + scale * rng.standard_normal(a.shape)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_model():
    """JAX config, numpy parameters (perturbed) and JAX parameters."""
    j = jx()
    jcfg = j.configs.reduced_config(j.configs.get_config(ARCH))
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    out = j.jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   params)
    rng = np.random.default_rng(1)
    out["final_norm"] = _perturb(rng, out["final_norm"])
    for run in out["runs"]:
        for name in ("ln1", "ln2", "ln_ssm"):
            run[name] = _perturb(rng, run[name])
        for name in ("dt_bias", "A_log", "D"):
            run["ssm"][name] = _perturb(rng, run["ssm"][name])
    return jcfg, out, j.jax.tree_util.tree_map(j.jnp.asarray, out)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here on one thread. Beside the suite's other
    workers a thread pool per process oversubscribes the cores: the
    32-layer prefill of `test_bf16_noise_matches_jax` took 30.9 s on
    eight threads and 1.3 s on one, on a loaded 8-core machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = reduced_config(get_config(ARCH))
    return cfg, convert.lm_params(_jax_model()[1], cfg, device="cpu")


def _layer(np_params, ri, li):
    """JAX parameters of layer ``li`` of run ``ri``."""
    j = jx()
    return j.jax.tree_util.tree_map(lambda a: j.jnp.asarray(a[li]),
                                    np_params["runs"][ri])


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def test_config_is_the_reduced_hybrid():
    cfg = reduced_config(get_config(ARCH))
    assert (cfg.family, cfg.global_layers, cfg.sliding_window,
            cfg.ssm_state, cfg.scan_chunk) == ("hybrid", (0, 3), 32, 8, 32)
    assert T % cfg.scan_chunk and STEPS + T > S > cfg.sliding_window
    assert [(r.kind, r.count, r.window) for r in
            tblocks.layer_schedule(cfg)] == [
        ("hybrid", 1, 0), ("hybrid", 2, 32), ("hybrid", 1, 0)]


def test_ssm_parameters_carried_across(model):
    cfg, m = model
    jp = _jax_model()[1]["runs"][1]["ssm"]
    ssm = m.runs[1][1].ssm
    for name in ("in_proj", "x_proj", "dt_w", "out_proj"):
        np.testing.assert_array_equal(_np(getattr(ssm, name).weight),
                                      jp[name][1].T)
    for name in ("conv_w", "dt_bias", "A_log", "D"):
        np.testing.assert_array_equal(_np(getattr(ssm, name)), jp[name][1])
    assert ssm.dt_w.in_features == max(cfg.d_model // 16, 1)


def test_init_ssm_matches_reference_shapes_and_a_log():
    """The port's own random init: the reference's parameter shapes and
    its initial ``A_log`` (log 1..n per channel), ``dt_bias`` 0, ``D``
    1."""
    j = jx()
    jcfg = j.configs.reduced_config(j.configs.get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    want, _ = j.ssm.init_ssm(jcfg, j.jax.random.PRNGKey(0), j.jnp.float32)
    got = tssm.init_ssm(cfg, torch.Generator().manual_seed(0),
                        torch.float32)
    for name, w in want.items():
        t = getattr(got, name)
        t = t.weight.T if isinstance(t, torch.nn.Linear) else t
        assert tuple(t.shape) == w.shape, name
        if name in ("A_log", "dt_bias", "D"):
            np.testing.assert_allclose(_np(t), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("ri,li", [(0, 0), (1, 1)])
def test_ssm_prefill_matches_jax(model, ri, li):
    """T = 45: a 32-step chunk and a 13-step one (the reference pads the
    last chunk; the port scans it short)."""
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    x = np.random.default_rng(3).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    want, _ = jx().ssm.ssm_layer(_layer(np_params, ri, li)["ssm"],
                                 jx().jnp.asarray(x), jcfg)
    tssm.reset_plain_calls()
    got, cache = tssm.ssm_layer(m.runs[ri][li].ssm, torch.tensor(x), cfg)
    assert cache is None
    assert tssm.PLAIN_CALLS["ssm_scan"] == -(-T // cfg.scan_chunk)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _ssm_cache_arrays(cfg, seed):
    rng = np.random.default_rng(seed)
    din = cfg.ssm_expand * cfg.d_model
    return (rng.standard_normal((B, din, cfg.ssm_state)).astype(np.float32),
            rng.standard_normal((B, cfg.ssm_conv - 1, din)).astype(
                np.float32))


def test_ssm_decode_step_matches_jax(model):
    """One step from a nonzero state and conv history; the port writes
    the step into the cache's buffers in place."""
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    j = jx()
    h, conv = _ssm_cache_arrays(cfg, 4)
    x = np.random.default_rng(5).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    want, wcache = j.ssm.ssm_layer(
        _layer(np_params, 1, 0)["ssm"], j.jnp.asarray(x), jcfg,
        cache=j.ssm.SSMCache(h=j.jnp.asarray(h), conv=j.jnp.asarray(conv)))
    cache = tssm.SSMCache(torch.tensor(h), torch.tensor(conv))
    got, gcache = tssm.ssm_layer(m.runs[1][0].ssm, torch.tensor(x), cfg,
                                 cache=cache)
    assert gcache.h is cache.h and gcache.conv is cache.conv
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(cache.h), _np(wcache.h), **TOL)
    np.testing.assert_allclose(_np(cache.conv), _np(wcache.conv), **TOL)


@pytest.mark.parametrize("ri,window", [(0, 0), (1, 32)])
def test_hybrid_block_prefill_matches_jax(model, ri, window):
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    j = jx()
    x = np.random.default_rng(6).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, _, _ = j.blocks.apply_block(
        _layer(np_params, ri, 0), j.jnp.asarray(x), jcfg, "hybrid",
        positions=j.jnp.asarray(pos), window=window)
    got, cache, aux = tblocks.apply_block(
        m.runs[ri][0], torch.tensor(x), cfg, "hybrid",
        positions=torch.tensor(pos), window=window)
    assert cache is None and aux == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_hybrid_block_decode_matches_jax(model):
    """A windowed layer's step against a full ring (length 40 > 32 rows)
    and a nonzero SSM state: output, ring row, state and conv history."""
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    j = jx()
    rng = np.random.default_rng(7)
    W, length = cfg.sliding_window, 40
    kv = [rng.standard_normal((B, cfg.num_kv_heads, W,
                               cfg.resolved_head_dim)).astype(np.float32)
          for _ in range(2)]
    h, conv = _ssm_cache_arrays(cfg, 8)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((B, 1), length, np.int32)
    jcache = dict(
        attn=j.attention.KVCache(j.jnp.asarray(kv[0]),
                                        j.jnp.asarray(kv[1]),
                                        j.jnp.asarray(length, j.jnp.int32)),
        ssm=j.ssm.SSMCache(j.jnp.asarray(h), j.jnp.asarray(conv)))
    want, wc, _ = j.blocks.apply_block(
        _layer(np_params, 1, 1), j.jnp.asarray(x), jcfg, "hybrid",
        positions=j.jnp.asarray(pos), window=W, cache=jcache)
    tcache = dict(
        attn=tattn.KVCache(torch.tensor(kv[0]),
                                      torch.tensor(kv[1]),
                                      torch.tensor(length, dtype=torch.int32)),
        ssm=tssm.SSMCache(torch.tensor(h), torch.tensor(conv)))
    got, gc, _ = tblocks.apply_block(
        m.runs[1][1], torch.tensor(x), cfg, "hybrid",
        positions=torch.tensor(pos), window=W, cache=tcache)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert int(gc["attn"].length) == int(wc["attn"].length) == length + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(getattr(gc["attn"], name)),
                                   _np(getattr(wc["attn"], name)), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(getattr(gc["ssm"], name)),
                                   _np(getattr(wc["ssm"], name)), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_logits():
    """JAX prefill logits over the first T tokens, and the logits of
    T + STEPS teacher-forced decode steps (caches of S)."""
    j = jx()
    jcfg, _, jparams = _jax_model()
    tokens = np.random.default_rng(9).integers(0, jcfg.vocab_size,
                                               (B, T + STEPS))
    pre = np.asarray(j.models.prefill(jparams, jcfg,
                                      j.jnp.asarray(tokens[:, :T])))
    caches = j.models.init_caches(jcfg, B, S)
    step = j.jax.jit(lambda c, t, p: j.models.decode_step(jparams, jcfg, c,
                                                          t, p))
    dec = []
    for i in range(T + STEPS):
        logits, caches = step(caches, j.jnp.asarray(tokens[:, i:i + 1]),
                              j.jnp.asarray(i, j.jnp.int32))
        dec.append(np.asarray(logits))
    return tokens, pre, dec


def test_prefill_logits_match_jax(model):
    cfg, m = model
    tokens, pre, _ = _jax_logits()
    tssm.reset_plain_calls()
    got = prefill(m, cfg, torch.tensor(tokens[:, :T]))
    assert got.shape == (B, 1, cfg.padded_vocab)
    assert tssm.PLAIN_CALLS["ssm_scan"] == cfg.num_layers * -(
        -T // cfg.scan_chunk)
    np.testing.assert_allclose(got.numpy(), pre, **TOL)


def test_decode_logits_match_jax_past_the_ring_wrap(model):
    """Every logit of 89 teacher-forced steps: the windowed layers' rings
    (32 rows) wrap at step 32 and again at 64; the global layers' caches
    fill to 48 and keep their last row rewritten, as the reference's."""
    cfg, m = model
    tokens, _, dec = _jax_logits()
    caches = init_caches(cfg, B, S, device="cpu")
    rings = [c["attn"].k.shape[3] for c in caches]
    assert rings == [S, cfg.sliding_window, S]
    for i in range(T + STEPS):
        logits, caches = decode_step(m, cfg, caches,
                                     torch.tensor(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(logits.numpy(), dec[i], **TOL,
                                   err_msg=f"step {i}")
    assert [c["attn"].length.tolist() for c in caches] == [
        [T + STEPS] * r.count for r in tblocks.layer_schedule(cfg)]
    assert all(bool(c["ssm"].h.abs().sum() > 0) for c in caches)


def test_decode_matches_own_prefill(model):
    cfg, m = model
    tokens = torch.tensor(_jax_logits()[0][:, :T])
    caches = init_caches(cfg, B, S, device="cpu")
    for i in range(T):
        logits, caches = decode_step(m, cfg, caches, tokens[:, i:i + 1],
                                     torch.tensor(i))
    np.testing.assert_allclose(logits.numpy(),
                               prefill(m, cfg, tokens).numpy(), **TOL)


def test_plain_impl_is_the_cpu_path(model):
    cfg, m = model
    tokens = torch.tensor(_jax_logits()[0][:, :T])
    np.testing.assert_array_equal(
        prefill(m, cfg, tokens, impl="plain").numpy(),
        prefill(m, cfg, tokens).numpy())
    with pytest.raises(ValueError, match="impl"):
        tssm.ssm_layer(m.runs[0][0].ssm, torch.zeros(1, 2, cfg.d_model),
                       cfg, impl="pallas")


@pytest.mark.parametrize("prompt_len,gen,max_len", [(30, 14, 40),
                                                    (8, 6, 16)])
def test_greedy_tokens_equal_jax_serve(prompt_len, gen, max_len):
    """The JAX service (its weights from seed 0, its prompts from seed 1)
    and the port's loop on the same weights and prompts; at max_len 40
    the rings wrap at step 32."""
    j = jx()
    scfg = j.serve.ServeConfig(arch=ARCH, batch=2, prompt_len=prompt_len,
                               gen=gen, max_len=max_len)
    want = np.asarray(j.serve.serve(scfg, emit=lambda _: None)["tokens"])
    jcfg = j.configs.reduced_config(j.configs.get_config(ARCH))
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    prompts = j.jax.random.randint(j.jax.random.PRNGKey(1),
                                   (2, prompt_len), 0, jcfg.vocab_size)
    cfg = reduced_config(get_config(ARCH))
    m = convert.lm_params(j.jax.tree_util.tree_map(np.asarray, params), cfg,
                          device="cpu")
    out = tserve.generate(m, cfg, torch.tensor(np.asarray(prompts)), gen,
                          max_len)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    assert out["logits"].shape == (2, 1, cfg.padded_vocab)


def test_cli_serves_the_hybrid_family_on_cpu(capsys):
    tserve.main(["--workload", "decode", "--arch", ARCH, "--batch", "2",
                 "--prompt-len", "36", "--gen", "4", "--device", "cpu"])
    assert "[serve] 2 seqs x 40 steps" in capsys.readouterr().out


def test_run_cache_layout():
    cfg = reduced_config(get_config(ARCH))
    run = tblocks.layer_schedule(cfg)[1]
    rc = tblocks.init_run_cache(cfg, run, B, S, torch.float32, "cpu")
    din = cfg.ssm_expand * cfg.d_model
    assert rc["attn"].k.shape == (2, B, cfg.num_kv_heads,
                                  cfg.sliding_window, cfg.resolved_head_dim)
    assert rc["ssm"].h.shape == (2, B, din, cfg.ssm_state)
    assert rc["ssm"].h.dtype == torch.float32
    assert rc["ssm"].conv.shape == (2, B, cfg.ssm_conv - 1, din)
    lc = tblocks.layer_cache(rc, 1)
    lc["ssm"].h.fill_(1.0)
    assert bool((rc["ssm"].h[1] == 1).all()) and not rc["ssm"].h[0].any()


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [1, 45, 300])
def test_ssm_prefill_kernel_matches_plain_on_card(cuda, T_):
    """The SSM prefill with the ``ssm_scan`` kernel (one launch per
    chunk, no plain scan) against the plain scan, float32, at the reduced
    width and at hymba-1.5b's SSM width with short sequences."""
    for cfg in (reduced_config(get_config(ARCH)),
                reduced_config(get_config(ARCH), d_model=1600,
                               ssm_state=16, scan_chunk=256)):
        layer = tssm.init_ssm(cfg, torch.Generator(cuda).manual_seed(0),
                              torch.float32)
        x = torch.randn((2, T_, cfg.d_model), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
        tssm.reset_plain_calls()
        before = kss.LAUNCHES["ssm_scan"]
        with torch.no_grad():
            got, _ = tssm.ssm_layer(layer, x, cfg)
            torch.cuda.synchronize()
            assert kss.LAUNCHES["ssm_scan"] - before == -(
                -T_ // cfg.scan_chunk)
            assert tssm.PLAIN_CALLS["ssm_scan"] == 0
            want, _ = tssm.ssm_layer(layer, x, cfg, impl="plain")
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL)


def test_bf16_noise_matches_jax():
    """bfloat16 against float32 on the same (bf16-rounded) weights, at a
    32-layer reduced width (the full config's global layers 0, 16, 31,
    state 16): the port's largest logit error is JAX's own within 1.5x
    either way. The hybrid family's bf16 noise is several times the
    dense family's in both packages, which the card's logit gates at
    full width take as their yardstick."""
    import dataclasses

    j = jx()
    over = dict(num_layers=32, d_model=256, d_ff=512, ssm_state=16,
                global_layers=(0, 16, 31))
    jcfg = j.configs.reduced_config(j.configs.get_config(ARCH), **over)
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    p16 = j.jax.tree_util.tree_map(lambda a: a.astype(j.jnp.bfloat16),
                                   params)
    p32 = j.jax.tree_util.tree_map(lambda a: a.astype(j.jnp.float32), p16)
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    tokens = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 48))
    jt = j.jnp.asarray(tokens)
    want32 = np.asarray(j.models.prefill(p32, jcfg, jt))
    want16 = np.asarray(j.models.prefill(
        p16, dataclasses.replace(jcfg, **bf16), jt).astype(j.jnp.float32))
    cfg = reduced_config(get_config(ARCH), **over)
    np32 = j.jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p32)
    tt = torch.tensor(tokens)
    got32 = prefill(convert.lm_params(np32, cfg, device="cpu"), cfg,
                    tt).numpy()
    cfg16 = dataclasses.replace(cfg, **bf16)
    got16 = prefill(convert.lm_params(np32, cfg16, device="cpu"), cfg16,
                    tt).float().numpy()
    np.testing.assert_allclose(got32, want32, **TOL)
    jax_noise = np.abs(want16 - want32).max()
    port_noise = np.abs(got16 - got32).max()
    assert jax_noise / 1.5 <= port_noise <= 1.5 * jax_noise, (
        port_noise, jax_noise)
