"""Port parity: the xLSTM family (mLSTM and sLSTM blocks, no attention).
On ``reduced_config(xlstm-350m)`` (4 layers, d_model 64, 4 heads, mLSTM
inner width 128 so dh = 32, chunks of 32, the sLSTM in the last layer)
the JAX ``init_model`` parameters, with the norms and the sLSTM's gate
bias perturbed so that every leaf matters (and its up-projection scaled,
so that the tanh-approximate GELU the reference uses differs from the
exact one by far more than the tolerance), are carried across with
``convert.lm_params``. Held against the JAX package at the suite's
float32 tolerance: ``_mlstm_chunked`` (h and the final ``(C, n)``) and
``mlstm_layer`` in prefill at T in {1, 32, 45, 96} (45 pads the last
chunk), ``_mlstm_chunked`` also on gates whose memory outlasts a chunk
(the model's random gates forget within one, so only there does the
chunk-to-chunk carry matter); one mLSTM and one sLSTM decode step from a
nonzero state; the sLSTM prefill; both block kinds; ``prefill``, 40
teacher-forced ``decode_step``s and the greedy tokens of the service.
The port's own prefill equals its teacher-forced decode (the chunkwise
and recurrent forms are one function). On the card (marker ``cuda``)
the chunk scan on the ``ssm_scan`` kernel is held against the plain
scan at the xLSTM layout, and a decode step makes no host sync. JAX is
imported on first use, not at module level, so on a card's machine
without JAX the marked tests run with ``pytest --noconftest -m cuda``."""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.ssm_scan import ssm_scan as kss
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import decode_step, init_caches, init_model, prefill
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
ARCH = "xlstm-350m"
#: Batch, prompt length (not a multiple of the 32-step chunk), decode
#: steps, cache capacity (unused by the recurrent state).
B, T, STEPS, S = 2, 45, 40, 64
PREFILL_TS = [1, 32, 45, 96]


@functools.lru_cache(maxsize=None)
def jx():
    """The JAX side: ``jax``, ``jnp``, the configs, models and service."""
    import jax
    import jax.numpy as jnp

    from repro import configs, models
    from repro.launch import serve
    from repro.models import blocks, xlstm

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 models=models, blocks=blocks, xlstm=xlstm,
                                 serve=serve)


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
        run["ln1"] = _perturb(rng, run["ln1"])
        mixer = run.get("mlstm", run.get("slstm"))
        mixer["norm_w"] = _perturb(rng, mixer["norm_w"])
    sl = out["runs"][1]["slstm"]
    sl["b"] = _perturb(rng, sl["b"])
    # GELU inputs of O(1) and more, where the tanh approximation and the
    # exact GELU differ by far more than the tolerance.
    sl["up"] = sl["up"] * np.float32(30.0)
    return jcfg, out, j.jax.tree_util.tree_map(j.jnp.asarray, out)


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


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _dims(cfg):
    din = int(cfg.mlstm_proj_factor * cfg.d_model)
    return din, din // cfg.num_heads


def test_config_is_the_reduced_xlstm():
    cfg = reduced_config(get_config(ARCH))
    assert (cfg.family, cfg.slstm_layers, cfg.scan_chunk, cfg.num_heads,
            _dims(cfg)) == ("ssm", (3,), 32, 4, (128, 32))
    assert T % cfg.scan_chunk and max(PREFILL_TS) > 2 * cfg.scan_chunk
    assert [(r.kind, r.count) for r in tblocks.layer_schedule(cfg)] == [
        ("mlstm", 3), ("slstm", 1)]


def test_parameters_carried_across(model):
    cfg, m = model
    jp = _jax_model()[1]["runs"]
    ml, sl = m.runs[0][2].mlstm, m.runs[1][0].slstm
    for name in ("in_proj", "wq", "wk", "wv", "w_gates", "out_proj"):
        np.testing.assert_array_equal(_np(getattr(ml, name).weight),
                                      jp[0]["mlstm"][name][2].T)
    for name in ("conv_w", "norm_w"):
        np.testing.assert_array_equal(_np(getattr(ml, name)),
                                      jp[0]["mlstm"][name][2])
    for name in ("w_in", "up", "down"):
        np.testing.assert_array_equal(_np(getattr(sl, name).weight),
                                      jp[1]["slstm"][name][0].T)
    for name in ("r", "b", "norm_w"):
        np.testing.assert_array_equal(_np(getattr(sl, name)),
                                      jp[1]["slstm"][name][0])
    np.testing.assert_array_equal(_np(m.runs[1][0].ln1), jp[1]["ln1"][0])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_matches_reference_shapes(kind):
    """The port's own random init: the reference's parameter shapes,
    norms 1, the sLSTM's gate bias 0."""
    j = jx()
    jcfg = j.configs.reduced_config(j.configs.get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    init = {"mlstm": (j.xlstm.init_mlstm, txl.init_mlstm),
            "slstm": (j.xlstm.init_slstm, txl.init_slstm)}[kind]
    want, _ = init[0](jcfg, j.jax.random.PRNGKey(0), j.jnp.float32)
    got = init[1](cfg, torch.Generator().manual_seed(0), torch.float32)
    assert sorted(n.split(".")[0] for n, _ in got.named_parameters()) == \
        sorted(want)
    for name, w in want.items():
        t = getattr(got, name)
        t = t.weight.T if isinstance(t, torch.nn.Linear) else t
        assert tuple(t.shape) == w.shape, name
        if name in ("norm_w", "b"):
            np.testing.assert_array_equal(_np(t), np.asarray(w))


def _qkv_gates(cfg, T_, seed, memory):
    """q, k, v ``[B, H, T, dh]`` and the log gates ``lf, li [B, H, T]``.
    ``memory="model"``: forget gates like the random model's (about half
    the state kept per step, so a 32-step chunk forgets); ``"long"``:
    forget gates near 1 (the state carried across chunks)."""
    H, dh = cfg.num_heads, _dims(cfg)[1]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T_, dh)).astype(np.float32)
               for _ in range(3))
    g = rng.standard_normal((2, B, H, T_)).astype(np.float32)
    if memory == "long":
        g[0] = 4.0 + g[0]
    lf, li = (-np.logaddexp(0.0, -a).astype(np.float32) for a in g)
    return q / np.sqrt(dh).astype(np.float32), k, v, lf, li


@pytest.mark.parametrize("memory", ["model", "long"])
@pytest.mark.parametrize("T_", PREFILL_TS)
def test_mlstm_chunked_matches_jax(T_, memory):
    cfg = reduced_config(get_config(ARCH))
    CT = min(cfg.scan_chunk, T_)
    ins = _qkv_gates(cfg, T_, 2, memory)
    j = jx()
    want_h, (want_C, want_n) = j.xlstm._mlstm_chunked(
        *(j.jnp.asarray(a) for a in ins), CT)
    tssm.reset_plain_calls()
    got_h, (got_C, got_n) = txl._mlstm_chunked(
        *(torch.tensor(a) for a in ins), CT)
    assert tssm.PLAIN_CALLS["ssm_scan"] == 1
    assert got_h.dtype == torch.float32
    for got, want in ((got_h, want_h), (got_C, want_C), (got_n, want_n)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if memory == "long" and T_ > CT:
        # The carry is far above the tolerance: a dropped one would show.
        lf = ins[3][..., :CT].sum(-1)
        assert np.exp(lf).min() > 0.05


@pytest.mark.parametrize("T_", PREFILL_TS)
def test_mlstm_prefill_matches_jax(model, T_):
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    x = _x((B, T_, cfg.d_model), 3)
    want, _ = jx().xlstm.mlstm_layer(_layer(np_params, 0, 1)["mlstm"],
                                     jx().jnp.asarray(x), jcfg)
    tssm.reset_plain_calls()
    got, cache = txl.mlstm_layer(m.runs[0][1].mlstm, torch.tensor(x), cfg)
    assert cache is None and tssm.PLAIN_CALLS["ssm_scan"] == 1
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _mlstm_state(cfg, seed):
    din, dh = _dims(cfg)
    rng = np.random.default_rng(seed)
    H = cfg.num_heads
    return (rng.standard_normal((B, H, dh, dh)).astype(np.float32),
            rng.standard_normal((B, H, dh)).astype(np.float32),
            rng.standard_normal((B, cfg.ssm_conv - 1, din)).astype(
                np.float32))


def _slstm_state(cfg, seed):
    """c, n (> 0), h and a finite stabiliser m."""
    rng = np.random.default_rng(seed)
    c, h, m = (rng.standard_normal((B, cfg.d_model)).astype(np.float32)
               for _ in range(3))
    n = rng.uniform(0.5, 2.0, (B, cfg.d_model)).astype(np.float32)
    return c, n, h, m


def test_mlstm_decode_step_matches_jax(model):
    """One step from a nonzero ``C``, ``n`` and conv history; the port
    writes the step into the cache's buffers in place."""
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    j = jx()
    state = _mlstm_state(cfg, 4)
    x = _x((B, 1, cfg.d_model), 5)
    want, wcache = j.xlstm.mlstm_layer(
        _layer(np_params, 0, 0)["mlstm"], j.jnp.asarray(x), jcfg,
        cache=j.xlstm.MLSTMCache(*(j.jnp.asarray(a) for a in state)))
    cache = txl.MLSTMCache(*(torch.tensor(a) for a in state))
    ptrs = [t.data_ptr() for t in cache]
    got, gcache = txl.mlstm_layer(m.runs[0][0].mlstm, torch.tensor(x), cfg,
                                  cache=cache)
    assert gcache is cache and [t.data_ptr() for t in gcache] == ptrs
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for name in ("C", "n", "conv"):
        np.testing.assert_allclose(_np(getattr(cache, name)),
                                   _np(getattr(wcache, name)), **TOL)


def test_slstm_decode_step_matches_jax(model):
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    j = jx()
    state = _slstm_state(cfg, 6)
    x = _x((B, 1, cfg.d_model), 7)
    want, wcache = j.xlstm.slstm_layer(
        _layer(np_params, 1, 0)["slstm"], j.jnp.asarray(x), jcfg,
        cache=j.xlstm.SLSTMCache(*(j.jnp.asarray(a) for a in state)))
    cache = txl.SLSTMCache(*(torch.tensor(a) for a in state))
    got, gcache = txl.slstm_layer(m.runs[1][0].slstm, torch.tensor(x), cfg,
                                  cache=cache)
    assert gcache is cache
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for name in ("c", "n", "h", "m"):
        np.testing.assert_allclose(_np(getattr(cache, name)),
                                   _np(getattr(wcache, name)), **TOL)


@pytest.mark.parametrize("T_", [1, 45])
def test_slstm_prefill_matches_jax(model, T_):
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    x = _x((B, T_, cfg.d_model), 8)
    want, _ = jx().xlstm.slstm_layer(_layer(np_params, 1, 0)["slstm"],
                                     jx().jnp.asarray(x), jcfg)
    got, cache = txl.slstm_layer(m.runs[1][0].slstm, torch.tensor(x), cfg)
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("ri,kind", [(0, "mlstm"), (1, "slstm")])
def test_xlstm_block_prefill_matches_jax(model, ri, kind):
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    j = jx()
    x = _x((B, T, cfg.d_model), 9)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, _, _ = j.blocks.apply_block(
        _layer(np_params, ri, 0), j.jnp.asarray(x), jcfg, kind,
        positions=j.jnp.asarray(pos), window=0)
    got, cache, aux = tblocks.apply_block(
        m.runs[ri][0], torch.tensor(x), cfg, kind,
        positions=torch.tensor(pos), window=0)
    assert cache is None and aux == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("ri,kind", [(0, "mlstm"), (1, "slstm")])
def test_xlstm_block_decode_matches_jax(model, ri, kind):
    cfg, m = model
    jcfg, np_params, _ = _jax_model()
    j = jx()
    state = (_mlstm_state if kind == "mlstm" else _slstm_state)(cfg, 10)
    jcache_t = j.xlstm.MLSTMCache if kind == "mlstm" else j.xlstm.SLSTMCache
    tcache_t = txl.MLSTMCache if kind == "mlstm" else txl.SLSTMCache
    x = _x((B, 1, cfg.d_model), 11)
    pos = np.full((B, 1), 7, np.int32)
    want, wc, _ = j.blocks.apply_block(
        _layer(np_params, ri, 0), j.jnp.asarray(x), jcfg, kind,
        positions=j.jnp.asarray(pos), window=0,
        cache=jcache_t(*(j.jnp.asarray(a) for a in state)))
    got, gc, _ = tblocks.apply_block(
        m.runs[ri][0], torch.tensor(x), cfg, kind,
        positions=torch.tensor(pos), window=0,
        cache=tcache_t(*(torch.tensor(a) for a in state)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for g, w in zip(gc, wc):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_logits():
    """JAX prefill logits over the first T tokens, and the logits of
    STEPS teacher-forced decode steps."""
    j = jx()
    jcfg, _, jparams = _jax_model()
    tokens = np.random.default_rng(12).integers(0, jcfg.vocab_size,
                                                (B, T))
    pre = np.asarray(j.models.prefill(jparams, jcfg, j.jnp.asarray(tokens)))
    caches = j.models.init_caches(jcfg, B, S)
    step = j.jax.jit(lambda c, t, p: j.models.decode_step(jparams, jcfg, c,
                                                          t, p))
    dec = []
    for i in range(STEPS):
        logits, caches = step(caches, j.jnp.asarray(tokens[:, i:i + 1]),
                              j.jnp.asarray(i, j.jnp.int32))
        dec.append(np.asarray(logits))
    return tokens, pre, dec


def test_prefill_logits_match_jax(model):
    cfg, m = model
    tokens, pre, _ = _jax_logits()
    tssm.reset_plain_calls()
    got = prefill(m, cfg, torch.tensor(tokens))
    assert got.shape == (B, 1, cfg.padded_vocab)
    mlstm_layers = cfg.num_layers - len(cfg.slstm_layers)
    assert tssm.PLAIN_CALLS["ssm_scan"] == mlstm_layers
    np.testing.assert_allclose(got.numpy(), pre, **TOL)


def test_decode_logits_match_jax(model):
    """Every logit of 40 teacher-forced steps; the state is written in
    place, so the caches returned are the buffers passed in."""
    cfg, m = model
    tokens, _, dec = _jax_logits()
    caches = init_caches(cfg, B, S, device="cpu")
    bufs = [[t.data_ptr() for t in c] for c in caches]
    for i in range(STEPS):
        logits, caches = decode_step(m, cfg, caches,
                                     torch.tensor(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(logits.numpy(), dec[i], **TOL,
                                   err_msg=f"step {i}")
    assert [[t.data_ptr() for t in c] for c in caches] == bufs
    assert bool(caches[0].C.abs().sum() > 0)
    assert bool(torch.isfinite(caches[1].m).all())


@pytest.mark.parametrize("T_", [T, 96])
def test_decode_matches_own_prefill(model, T_):
    """The chunkwise prefill and the recurrent decode are one function:
    the last of ``T_`` teacher-forced steps equals the prefill's logits."""
    cfg, m = model
    tokens = torch.tensor(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (B, T_)))
    caches = init_caches(cfg, B, S, device="cpu")
    for i in range(T_):
        logits, caches = decode_step(m, cfg, caches, tokens[:, i:i + 1],
                                     torch.tensor(i))
    np.testing.assert_allclose(logits.numpy(),
                               prefill(m, cfg, tokens).numpy(), **TOL)


def test_plain_impl_is_the_cpu_path(model):
    cfg, m = model
    tokens = torch.tensor(_jax_logits()[0])
    np.testing.assert_array_equal(
        prefill(m, cfg, tokens, impl="plain").numpy(),
        prefill(m, cfg, tokens).numpy())
    with pytest.raises(ValueError, match="impl"):
        txl.mlstm_layer(m.runs[0][0].mlstm, torch.zeros(1, 2, cfg.d_model),
                        cfg, impl="pallas")


@pytest.mark.parametrize("prompt_len,gen", [(30, 14), (8, 6)])
def test_greedy_tokens_equal_jax_serve(prompt_len, gen):
    """The JAX service (its weights from seed 0, its prompts from seed 1)
    and the port's loop on the same weights and prompts."""
    j = jx()
    scfg = j.serve.ServeConfig(arch=ARCH, batch=2, prompt_len=prompt_len,
                               gen=gen, max_len=S)
    want = np.asarray(j.serve.serve(scfg, emit=lambda _: None)["tokens"])
    jcfg = j.configs.reduced_config(j.configs.get_config(ARCH))
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    prompts = j.jax.random.randint(j.jax.random.PRNGKey(1),
                                   (2, prompt_len), 0, jcfg.vocab_size)
    cfg = reduced_config(get_config(ARCH))
    m = convert.lm_params(j.jax.tree_util.tree_map(np.asarray, params), cfg,
                          device="cpu")
    out = tserve.generate(m, cfg, torch.tensor(np.asarray(prompts)), gen, S)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    assert out["logits"].shape == (2, 1, cfg.padded_vocab)


def test_cli_serves_the_xlstm_family_on_cpu(capsys):
    tserve.main(["--workload", "decode", "--arch", ARCH, "--batch", "2",
                 "--prompt-len", "36", "--gen", "4", "--device", "cpu"])
    assert "[serve] 2 seqs x 40 steps" in capsys.readouterr().out


def test_run_cache_layout():
    cfg = reduced_config(get_config(ARCH))
    din, dh = _dims(cfg)
    H = cfg.num_heads
    mrun, srun = tblocks.layer_schedule(cfg)
    mc = tblocks.init_run_cache(cfg, mrun, B, S, torch.float32, "cpu")
    assert isinstance(mc, txl.MLSTMCache)
    assert mc.C.shape == (3, B, H, dh, dh) and mc.C.dtype == torch.float32
    assert mc.n.shape == (3, B, H, dh)
    assert mc.conv.shape == (3, B, cfg.ssm_conv - 1, din)
    sc = tblocks.init_run_cache(cfg, srun, B, S, torch.bfloat16, "cpu")
    assert all(t.shape == (1, B, cfg.d_model) and t.dtype == torch.float32
               for t in sc)
    assert bool((sc.m == -1e30).all()) and not sc.c.any()
    lc = tblocks.layer_cache(mc, 1)
    lc.C.fill_(1.0)
    assert bool((mc.C[1] == 1).all()) and not mc.C[0].any()


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("memory", ["model", "long"])
@pytest.mark.parametrize("T_", [1, 45, 300])
def test_mlstm_chunk_scan_kernel_matches_plain_on_card(cuda, T_, memory):
    """``_mlstm_chunked`` with the ``ssm_scan`` kernel (one launch over
    ``[B, nc, H (dh^2 + dh)]``, no plain scan) against the plain scan,
    float32, at the reduced width and at xlstm-350m's (4 heads, dh 512,
    chunks of 256)."""
    for cfg in (reduced_config(get_config(ARCH)),
                reduced_config(get_config(ARCH), d_model=1024,
                               scan_chunk=256)):
        CT = min(cfg.scan_chunk, T_)
        ins = [torch.tensor(a, device=cuda)
               for a in _qkv_gates(cfg, T_, 14, memory)]
        tssm.reset_plain_calls()
        before = kss.LAUNCHES["ssm_scan"]
        got = txl._mlstm_chunked(*ins, CT)
        torch.cuda.synchronize()
        assert kss.LAUNCHES["ssm_scan"] - before == 1
        assert tssm.PLAIN_CALLS["ssm_scan"] == 0
        want = txl._mlstm_chunked(*ins, CT, impl="plain")
        for g, w in ((got[0], want[0]), *zip(got[1], want[1])):
            np.testing.assert_allclose(_np(g.cpu()), _np(w.cpu()), **TOL)


@pytest.mark.cuda
def test_decode_step_makes_no_host_sync_on_card(cuda):
    """A decode step of the reduced model (both block kinds) under
    ``set_sync_debug_mode("error")``, equal to the CPU's step on the same
    weights."""
    cfg = reduced_config(get_config(ARCH))
    cpu = init_model(cfg, 0, device="cpu")
    card = init_model(cfg, 0, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (B, 3),
                         generator=torch.Generator().manual_seed(15))
    cc, kc = (init_caches(cfg, B, S, device=d) for d in ("cpu", cuda))
    tc = toks.to(cuda)
    for i in range(3):
        want, cc = decode_step(cpu, cfg, cc, toks[:, i:i + 1], i)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, kc = decode_step(card, cfg, kc, tc[:, i:i + 1], i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        np.testing.assert_allclose(_np(got.cpu()), _np(want), **TOL)
