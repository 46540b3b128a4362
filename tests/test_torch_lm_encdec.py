"""Port parity: the encoder-decoder family (seamless-m4t-medium's backbone,
the audio frontend a stub that hands over frame embeddings). On its
``reduced_config`` (4 decoder and 2 encoder layers, d_model 64, 4/4
heads, head_dim 16, ``encoder_seq_len`` 32, float32) the JAX
``init_model`` parameters, with every norm perturbed (decoder and encoder
``ln1``/``ln2``, ``enc_norm``, each row of ``ln_cross``, ``final_norm``)
so that every leaf matters, are carried across with ``convert.lm_params``,
and the frontend embeddings are drawn from a numpy seed. Held against the
JAX package at the suite's float32 tolerance: ``encode``,
``cross_attention_layer`` (one query and more than ``attn_chunk`` of
them; with QKV biases, which cross-attention must ignore), the plain
``chunked_cross`` in bfloat16 (both products in float32),
``prefill(enc_emb=)``, 8 teacher-forced ``decode_step(memory=)``s and
the greedy tokens of the service (its zero memory) and of the same loop
on a random frontend. The port's teacher-forced decode equals its own
prefill. The service's memory is exactly zero, so no cross-attention
fault can show there: every other test runs on a random frontend. On the
card (marker ``cuda``) the kernel path is held against the plain path and
the launches of one encode and one decode step are counted. JAX is
imported on first use, not at module level, so on a card's machine
without JAX the marked tests run with ``pytest --noconftest -m cuda``."""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import flash_attention as kfa
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import (decode_step, encode, init_caches, init_model,
                                prefill)
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
#: bf16 outputs of the same float32 arithmetic summed in another order:
#: at most one bf16 rounding step (2^-8 relative) apart.
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
ARCH = "seamless-m4t-medium"
#: Batch, prompt length, decode steps, cache capacity.
B, T, STEPS, S = 2, 12, 8, 16


@functools.lru_cache(maxsize=None)
def jx():
    """The JAX side: ``jax``, ``jnp``, the configs, models and service."""
    import jax
    import jax.numpy as jnp

    from repro import configs, models
    from repro.launch import serve
    from repro.models import attention

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 models=models, attention=attention,
                                 serve=serve)


def _perturb(rng, a):
    return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)


def _cfgs(**over):
    j = jx()
    return (j.configs.reduced_config(j.configs.get_config(ARCH), **over),
            reduced_config(get_config(ARCH), **over))


@functools.lru_cache(maxsize=None)
def _jax_model(over=()):
    """JAX config, numpy parameters (norms perturbed; QKV biases too where
    the config has them) and JAX parameters."""
    j = jx()
    jcfg, _ = _cfgs(**dict(over))
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    out = j.jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   params)
    rng = np.random.default_rng(1)
    for name in ("final_norm", "enc_norm", "ln_cross"):
        out[name] = _perturb(rng, out[name])
    for run in out["runs"] + [out["encoder"]]:
        for name in ("ln1", "ln2"):
            run[name] = _perturb(rng, run[name])
    for attn in [r["attn"] for r in out["runs"]] + [out["cross_attn"]]:
        for name in ("bq", "bk", "bv"):
            if name in attn:
                attn[name] = _perturb(rng, attn[name])
    return jcfg, out, j.jax.tree_util.tree_map(j.jnp.asarray, out)


@pytest.fixture(scope="module")
def model():
    cfg = reduced_config(get_config(ARCH))
    return cfg, convert.lm_params(_jax_model()[1], cfg, device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(
        x, torch.Tensor) else x, np.float32)


def _frontend(cfg, seed=3, batch=B):
    """Random frame embeddings ``[batch, encoder_seq_len, d]`` (std 1)."""
    return _x((batch, cfg.encoder_seq_len, cfg.d_model), seed)


def _tokens(cfg, seed=2, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _jax_layer(tree, li):
    j = jx()
    return j.jax.tree_util.tree_map(lambda a: j.jnp.asarray(a[li]), tree)


def test_config_is_the_reduced_encdec():
    cfg = reduced_config(get_config(ARCH))
    assert (cfg.family, cfg.num_layers, cfg.encoder_layers,
            cfg.encoder_seq_len) == ("encdec", 4, 2, 32)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.qkv_bias) == (64, 4, 4, 16, False)


def test_parameters_carried_across(model):
    cfg, m = model
    _, np_params, _ = _jax_model()
    assert len(m.encoder) == cfg.encoder_layers
    assert len(m.cross_attn) == cfg.num_layers
    np.testing.assert_array_equal(_np(m.ln_cross), np_params["ln_cross"])
    np.testing.assert_array_equal(_np(m.enc_norm), np_params["enc_norm"])
    for li in range(cfg.encoder_layers):
        enc = np_params["encoder"]
        np.testing.assert_array_equal(_np(m.encoder[li].ln2), enc["ln2"][li])
        np.testing.assert_array_equal(_np(m.encoder[li].attn.wk.weight).T,
                                      enc["attn"]["wk"][li])
        np.testing.assert_array_equal(_np(m.encoder[li].mlp.w_down.weight).T,
                                      enc["mlp"]["w_down"][li])
    for li in range(cfg.num_layers):
        np.testing.assert_array_equal(_np(m.cross_attn[li].wv.weight).T,
                                      np_params["cross_attn"]["wv"][li])
    names = {n for n, _ in m.named_parameters()}
    assert {"ln_cross", "enc_norm", "encoder.1.attn.wo.weight",
            "cross_attn.3.wq.weight"} <= names


def test_encode_matches_jax(model):
    cfg, m = model
    jcfg, _, jparams = _jax_model()
    emb = _frontend(cfg)
    want = jx().models.encode(jparams, jcfg, jx().jnp.asarray(emb))
    got = encode(m, cfg, torch.tensor(emb))
    assert got.shape == (B, cfg.encoder_seq_len, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("over", [(), (("qkv_bias", True),)],
                         ids=["no-bias", "qkv-bias"])
@pytest.mark.parametrize("T_", [1, 80])   # 80 > attn_chunk 64: two chunks
def test_cross_attention_layer_matches_jax(T_, over):
    """One decoder layer's cross-attention sublayer on random ``x`` and a
    random memory. With QKV biases (set nonzero) the reference applies
    none in cross-attention, and neither may the port."""
    j = jx()
    jcfg, np_params, _ = _jax_model(over)
    cfg = reduced_config(get_config(ARCH), **dict(over))
    m = convert.lm_params(np_params, cfg, device="cpu")
    gl = 2
    x = _x((B, T_, cfg.d_model), 5)
    mem = _x((B, cfg.encoder_seq_len, cfg.d_model), 6)
    want = j.attention.cross_attention_layer(
        _jax_layer(np_params["cross_attn"], gl), j.jnp.asarray(x),
        j.jnp.asarray(mem), jcfg)
    before = tattn.PLAIN_CALLS["chunked_cross"]
    got = tattn.cross_attention_layer(m.cross_attn[gl], torch.tensor(x),
                                      torch.tensor(mem), cfg)
    assert tattn.PLAIN_CALLS["chunked_cross"] == before + 1
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_chunked_cross_widens_bf16_operands_like_jax():
    """bf16 q, k, v: both products in float32, as the reference casts
    them; only the final rounding to bf16 remains."""
    j = jx()
    q, k, v = (_x((2, 70, 4, 16), s) * 3 for s in (7, 8, 9))
    k, v = k[:, :40], v[:, :40]
    want = j.attention._chunked_cross(
        *(j.jnp.asarray(a, j.jnp.bfloat16) for a in (q, k, v)), chunk=32)
    got = tattn.chunked_cross(
        *(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)), chunk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@functools.lru_cache(maxsize=None)
def _jax_logits():
    """JAX prefill logits and 8 teacher-forced decode logits on a random
    frontend."""
    j = jx()
    jcfg, _, jparams = _jax_model()
    cfg = reduced_config(get_config(ARCH))
    jnp = j.jnp
    tokens, emb = _tokens(cfg), _frontend(cfg)
    pre = np.asarray(j.models.prefill(jparams, jcfg, jnp.asarray(tokens),
                                      enc_emb=jnp.asarray(emb)))
    memory = j.models.encode(jparams, jcfg, jnp.asarray(emb))
    caches = j.models.init_caches(jcfg, B, S)
    step = j.jax.jit(lambda c, t, p: j.models.decode_step(
        jparams, jcfg, c, t, p, memory=memory))
    dec = []
    for i in range(STEPS):
        logits, caches = step(caches, jnp.asarray(tokens[:, i:i + 1]),
                              jnp.asarray(i, jnp.int32))
        dec.append(np.asarray(logits))
    return pre, dec


def test_prefill_logits_match_jax(model):
    cfg, m = model
    pre, _ = _jax_logits()
    got = prefill(m, cfg, torch.tensor(_tokens(cfg)),
                  torch.tensor(_frontend(cfg)))
    assert got.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), pre, **TOL)


def test_decode_logits_match_jax(model):
    cfg, m = model
    _, dec = _jax_logits()
    tokens = torch.tensor(_tokens(cfg))
    memory = encode(m, cfg, torch.tensor(_frontend(cfg)))
    caches = init_caches(cfg, B, S, device="cpu")
    for i in range(STEPS):
        logits, caches = decode_step(m, cfg, caches, tokens[:, i:i + 1], i,
                                     memory)
        np.testing.assert_allclose(_np(logits), dec[i], **TOL)
    assert [int(c["attn"].length[0]) for c in caches] == [STEPS]


def test_decode_matches_own_prefill(model):
    """Teacher-forced decode reproduces the port's own prefill at the last
    prompt position (the cache path against the no-cache path)."""
    cfg, m = model
    toks, emb = torch.tensor(_tokens(cfg)), torch.tensor(_frontend(cfg))
    memory = encode(m, cfg, emb)
    caches = init_caches(cfg, B, S, device="cpu")
    for i in range(T):
        logits, caches = decode_step(m, cfg, caches, toks[:, i:i + 1],
                                     torch.tensor(i), memory=memory)
    np.testing.assert_allclose(_np(logits), _np(prefill(m, cfg, toks, emb)),
                               **TOL)


def _jax_greedy(jparams, jcfg, prompts, gen, memory):
    """``repro.launch.serve.serve``'s loop on given params, prompts and
    encoder memory."""
    j = jx()
    jnp = j.jnp
    caches = j.models.init_caches(jcfg, prompts.shape[0], S)
    step = j.jax.jit(lambda c, t, p: j.models.decode_step(
        jparams, jcfg, c, t, p, memory=memory))
    for i in range(prompts.shape[1]):
        logits, caches = step(caches, prompts[:, i:i + 1],
                              jnp.asarray(i, jnp.int32))
    tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
    out = []
    for k in range(gen):
        out.append(tok)
        logits, caches = step(caches, tok,
                              jnp.asarray(prompts.shape[1] + k, jnp.int32))
        tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(
            jnp.int32)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("frontend", ["zero", "random"])
def test_greedy_tokens_equal_jax(frontend):
    """``zero``: the JAX service itself (weights from seed 0, prompts from
    seed 1, the zero memory) against the port's loop on the same weights,
    prompts and zero frontend. ``random``: the same loop on a random
    frontend, where cross-attention acts."""
    j = jx()
    jcfg, _ = _cfgs()
    cfg = reduced_config(get_config(ARCH))
    prompt_len, gen = 6, 5
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    prompts = j.jax.random.randint(j.jax.random.PRNGKey(1), (2, prompt_len),
                                   0, jcfg.vocab_size)
    if frontend == "zero":
        scfg = j.serve.ServeConfig(arch=ARCH, batch=2, prompt_len=prompt_len,
                                   gen=gen, max_len=S)
        want = np.asarray(j.serve.serve(scfg, emit=lambda _: None)["tokens"])
        emb = np.zeros((2, cfg.encoder_seq_len, cfg.d_model), np.float32)
    else:
        emb = _frontend(cfg, seed=4, batch=2)
        want = _jax_greedy(params, jcfg, prompts, gen, j.models.encode(
            params, jcfg, j.jnp.asarray(emb)))
    m = convert.lm_params(j.jax.tree_util.tree_map(np.asarray, params), cfg,
                          device="cpu")
    memory = encode(m, cfg, torch.tensor(emb))
    out = tserve.generate(m, cfg, torch.tensor(np.asarray(prompts)), gen, S,
                          memory)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    assert out["logits"].shape == (2, 1, cfg.padded_vocab)


def test_the_service_memory_is_exactly_zero(model):
    """No QKV bias: every encoder block maps a zero frontend to zero, so
    the service's memory, and every cross-attention output against it, is
    exactly 0 (why the other tests use a random frontend)."""
    cfg, m = model
    memory = encode(m, cfg, torch.zeros((B, cfg.encoder_seq_len,
                                         cfg.d_model)))
    assert not memory.any()
    x = torch.tensor(_x((B, 3, cfg.d_model), 9))
    assert not tattn.cross_attention_layer(m.cross_attn[0], x, memory,
                                           cfg).any()


def test_decode_without_memory_raises(model):
    cfg, m = model
    caches = init_caches(cfg, B, S, device="cpu")
    toks = torch.tensor(_tokens(cfg))
    with pytest.raises(ValueError, match="memory"):
        decode_step(m, cfg, caches, toks[:, :1], 0)
    with pytest.raises(ValueError, match="enc_emb"):
        prefill(m, cfg, toks)


def test_plain_calls_on_cpu(model):
    """On CPU tensors an encode runs the plain attention once per encoder
    layer, and a decode step the plain decode and the plain cross
    attention once per decoder layer; nothing launches."""
    cfg, m = model
    tattn.reset_plain_calls()
    launches = dict(kfa.LAUNCHES)
    memory = encode(m, cfg, torch.tensor(_frontend(cfg)))
    decode_step(m, cfg, init_caches(cfg, B, S, device="cpu"),
                torch.tensor(_tokens(cfg))[:, :1], 0, memory)
    assert tattn.PLAIN_CALLS == {
        "blockwise_causal_attention": cfg.encoder_layers,
        "decode_attention": cfg.num_layers, "chunked_cross": cfg.num_layers}
    assert kfa.LAUNCHES == launches


def test_serve_on_cpu():
    lines = []
    out = tserve.serve(tserve.ServeConfig(arch=ARCH, batch=2, prompt_len=4,
                                          gen=3), emit=lines.append,
                       device="cpu")
    assert out["tokens"].shape == (2, 3)
    assert lines and lines[0].startswith("[serve] 2 seqs x 7 steps")


def test_cli_serves_the_encdec_family_on_cpu(capsys):
    tserve.main(["--workload", "decode", "--arch", ARCH, "--batch", "2",
                 "--prompt-len", "5", "--gen", "3", "--device", "cpu"])
    assert "[serve] 2 seqs x 8 steps" in capsys.readouterr().out


def test_init_model_builds_the_encdec_leaves():
    """The port's random model has the reference's leaves, norms at one,
    and as many parameters."""
    cfg = reduced_config(get_config(ARCH))
    m = init_model(cfg, 0, device="cpu")
    assert m.ln_cross.shape == (cfg.num_layers, cfg.d_model)
    assert bool((m.ln_cross == 1).all()) and bool((m.enc_norm == 1).all())
    _, np_params, _ = _jax_model()
    want = sum(a.size for a in jx().jax.tree_util.tree_leaves(np_params))
    assert sum(p.numel() for p in m.parameters()) == want


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(cfg, device):
    gen = torch.Generator(device).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, T), device=device,
                         generator=gen)
    emb = torch.randn((B, cfg.encoder_seq_len, cfg.d_model), device=device,
                      generator=gen)
    return toks, emb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_path_matches_plain_on_card(cuda, dtype):
    """``encode``, ``prefill(enc_emb=)`` and 8 decode steps with the
    kernels against the plain attention on the card (random weights of the
    port's own, a random frontend)."""
    name = str(dtype).split(".")[1]
    cfg = reduced_config(get_config(ARCH), param_dtype=name,
                         compute_dtype=name)
    m = init_model(cfg, 0, device=cuda)
    toks, emb = _card_inputs(cfg, cuda)
    tol = TOL if dtype == torch.float32 else dict(rtol=5e-2, atol=5e-2)
    tattn.reset_plain_calls()
    mem = encode(m, cfg, emb)
    mem_plain = encode(m, cfg, emb, impl="plain")
    np.testing.assert_allclose(_np(mem.cpu()), _np(mem_plain.cpu()), **tol)
    got = prefill(m, cfg, toks, emb)
    want = prefill(m, cfg, toks, emb, impl="plain")
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol)
    kc = init_caches(cfg, B, S, device=cuda)
    pc = init_caches(cfg, B, S, device=cuda)
    for i in range(STEPS):
        lk, kc = decode_step(m, cfg, kc, toks[:, i:i + 1], i, mem)
        lp, pc = decode_step(m, cfg, pc, toks[:, i:i + 1], i, mem_plain,
                             impl="plain")
        np.testing.assert_allclose(_np(lk.cpu()), _np(lp.cpu()), **tol)
    L, E = cfg.num_layers, cfg.encoder_layers
    assert tattn.PLAIN_CALLS == {
        "blockwise_causal_attention": 2 * E + L,
        "decode_attention": L * STEPS, "chunked_cross": L * (1 + STEPS)}


@pytest.mark.cuda
def test_launch_counts_of_encode_and_decode_step_on_card(cuda):
    """One encode launches one kernel per encoder layer (32 non-causal
    rows per kv head at head_dim 16: the FMA kernel); one decode step two
    split-K decode kernels per decoder layer (self-attention on the cache,
    cross-attention on the memory's k/v); no plain call."""
    cfg = reduced_config(get_config(ARCH))
    m = init_model(cfg, 0, device=cuda)
    toks, emb = _card_inputs(cfg, cuda)
    tattn.reset_plain_calls()
    before = dict(kfa.LAUNCHES)
    mem = encode(m, cfg, emb)
    torch.cuda.synchronize()
    moved = {k: kfa.LAUNCHES[k] - before[k] for k in before}
    assert moved == {"flash_attention": cfg.encoder_layers,
                     "flash_attention_wgmma": 0, "flash_attention_decode": 0}
    before = dict(kfa.LAUNCHES)
    decode_step(m, cfg, init_caches(cfg, B, S, device=cuda), toks[:, :1], 0,
                mem)
    torch.cuda.synchronize()
    moved = {k: kfa.LAUNCHES[k] - before[k] for k in before}
    assert moved == {"flash_attention": 0, "flash_attention_wgmma": 0,
                     "flash_attention_decode": 2 * cfg.num_layers}
    assert not any(tattn.PLAIN_CALLS.values())
