"""Port parity: the causal LM of the dense family, and the hybrid family's
reduced config beside it (its own file, ``test_torch_lm_hybrid.py``, goes
further). For each dense architecture's ``reduced_config`` (and a
padded-heads and a sliding-window variant, and qwen2-vl-72b, whose M-RoPE
equals RoPE on text positions; its attention layer is also held to JAX's
on vision positions, where the sections act) the JAX ``init_model``
parameters, with the norms and QKV biases perturbed so that every leaf
matters, are carried across with
``convert.lm_params``; the port's ``prefill`` logits and 8 teacher-forced
``decode_step`` logits are held against JAX's at the suite's float32
tolerance, and the port's decode against its own prefill. On the card
(marker ``cuda``) the kernel path is held against the plain path, a
softcap runs the kernels, and a head dim no kernel takes raises. JAX is
imported on first use, not at module level, so on a card's machine
without JAX the marked tests run with ``pytest --noconftest -m cuda``."""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import flash_attention as kfa
from repro_torch.kernels.ssm_scan import ssm_scan as kss
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import rope as trope
from repro_torch.models import ssm as tssm
from repro_torch.models import (decode_step, init_caches, init_model,
                                prefill)
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
DENSE = ["qwen2-1.5b", "llama3.2-3b", "internlm2-1.8b", "codeqwen1.5-7b"]
#: (arch, reduced_config overrides): the four dense architectures, then
#: qwen2 with 4 query heads padded to 8 (tp_size 8, as 12 are padded to 16
#: at full width), with an 8-row sliding window (ring caches), and the
#: reduced hybrid (hymba-1.5b: an SSM beside attention in every block).
CASES = [(a, {}) for a in DENSE] + [
    ("qwen2-1.5b", {"tp_size": 8}), ("llama3.2-3b", {"sliding_window": 8}),
    ("hymba-1.5b", {}), ("qwen2-vl-72b", {})]
IDS = DENSE + ["qwen2-padded-heads", "llama-window-8", "hymba", "qwen2-vl"]
B, T, STEPS = 2, 12, 8


@functools.lru_cache(maxsize=None)
def jx():
    """The JAX side: ``jax``, ``jnp``, the configs and the model API."""
    import jax
    import jax.numpy as jnp

    from repro import configs, models

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 models=models)


def _perturbed(params, seed):
    """The JAX parameters as numpy, norms and biases (all ones and zeros
    at init) drawn at random, so the conversion of each leaf is tested."""
    rng = np.random.default_rng(seed)
    out = jx().jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      params)
    out["final_norm"] = 1 + 0.1 * rng.standard_normal(
        out["final_norm"].shape).astype(np.float32)
    for run in out["runs"]:
        for name in ("ln1", "ln2"):
            run[name] = 1 + 0.1 * rng.standard_normal(
                run[name].shape).astype(np.float32)
        for name in ("bq", "bk", "bv"):
            if name in run["attn"]:
                run["attn"][name] = 0.1 * rng.standard_normal(
                    run["attn"][name].shape).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _case(arch, overrides):
    """The JAX side of one case: configs, numpy params, tokens, prefill
    logits, teacher-forced decode logits."""
    j = jx()
    over = dict(overrides)
    jcfg = j.configs.reduced_config(j.configs.get_config(arch), **over)
    cfg = reduced_config(get_config(arch), **over)
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    np_params = _perturbed(params, 1)
    jparams = j.jax.tree_util.tree_map(j.jnp.asarray, np_params)
    jnp = j.jnp
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, T))
    pre = np.asarray(j.models.prefill(jparams, jcfg, jnp.asarray(tokens)))
    caches = j.models.init_caches(jcfg, B, 16)
    step = j.jax.jit(lambda c, t, p: j.models.decode_step(jparams, jcfg, c,
                                                          t, p))
    dec = []
    for i in range(STEPS):
        logits, caches = step(caches, jnp.asarray(tokens[:, i:i + 1]),
                              jnp.asarray(i, jnp.int32))
        dec.append(np.asarray(logits))
    return cfg, np_params, tokens, pre, dec


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    cfg, np_params, tokens, pre, dec = _case(request.param[0],
                                             tuple(request.param[1].items()))
    model = convert.lm_params(np_params, cfg, device="cpu")
    return cfg, model, tokens, pre, dec


def test_prefill_logits_match_jax(case):
    cfg, model, tokens, pre, _ = case
    got = prefill(model, cfg, torch.tensor(tokens))
    assert got.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), pre, **TOL)


def test_decode_logits_match_jax(case):
    cfg, model, tokens, _, dec = case
    caches = init_caches(cfg, B, 16, device="cpu")
    for i in range(STEPS):
        logits, caches = decode_step(model, cfg, caches,
                                     torch.tensor(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(logits.numpy(), dec[i], **TOL)
    assert [int(c["attn"].length[0]) for c in caches] == [STEPS] * len(caches)


def test_decode_matches_own_prefill(case):
    """Teacher-forced decode reproduces the port's own prefill at the last
    prompt position (the cache path against the no-cache path)."""
    cfg, model, tokens, _, _ = case
    toks = torch.tensor(tokens)
    caches = init_caches(cfg, B, 16, device="cpu")
    for i in range(T):
        logits, caches = decode_step(model, cfg, caches, toks[:, i:i + 1],
                                     torch.tensor(i))
    np.testing.assert_allclose(logits.numpy(),
                               prefill(model, cfg, toks).numpy(), **TOL)


def test_padded_heads_have_zero_weights():
    cfg = reduced_config(get_config("qwen2-1.5b"), tp_size=8)
    assert (cfg.num_heads, cfg.padded_heads) == (4, 8)
    model = init_model(cfg, 0, device="cpu")
    attn = model.runs[0][0].attn
    dh = cfg.resolved_head_dim
    assert not attn.wq.weight[cfg.num_heads * dh:].any()
    assert not attn.wo.weight[:, cfg.num_heads * dh:].any()
    assert attn.wq.weight[:cfg.num_heads * dh].any()


def test_init_model_is_seeded_and_tied():
    cfg = reduced_config(get_config("qwen2-1.5b"))
    a = init_model(cfg, 3, device="cpu")
    b = init_model(cfg, torch.Generator().manual_seed(3))
    assert a.lm_head is None  # tied embeddings
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    assert init_model(reduced_config(get_config("llama3.2-3b")), 0,
                      device="cpu").lm_head.weight.shape == (
        cfg.padded_vocab, cfg.d_model)


def test_mrope_attention_layer_matches_jax_on_vision_positions():
    """qwen2-vl-72b's layer-0 attention (M-RoPE sections (4, 2, 2), QKV
    biases perturbed) on vision positions of a 2 x 3 x 4 patch grid, whose
    three rows differ, against JAX's ``attention_layer``; and the same
    input on text positions (rows equal) gives another output."""
    j = jx()
    cfg, np_params, _, _, _ = _case("qwen2-vl-72b", ())
    jcfg = j.configs.reduced_config(j.configs.get_config("qwen2-vl-72b"))
    assert cfg.mrope_sections == (4, 2, 2) and cfg.rope_mode == "mrope"
    model = convert.lm_params(np_params, cfg, device="cpu")
    lp = j.jax.tree_util.tree_map(lambda a: j.jnp.asarray(a[0]),
                                  np_params["runs"][0]["attn"])
    x = np.random.default_rng(5).standard_normal(
        (B, 24, cfg.d_model)).astype(np.float32)
    pos = j.models.rope.vision_mrope_positions(B, 2, 3, 4)
    want, _ = j.models.attention.attention_layer(lp, j.jnp.asarray(x), jcfg,
                                                 pos)
    tpos = trope.vision_mrope_positions(B, 2, 3, 4)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    with torch.no_grad():
        got, cache = tattn.attention_layer(model.runs[0][0].attn,
                                           torch.tensor(x), cfg, tpos)
        text, _ = tattn.attention_layer(model.runs[0][0].attn,
                                        torch.tensor(x), cfg,
                                        trope.text_mrope_positions(B, 24))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.allclose(text.numpy(), np.asarray(want), **TOL)


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    cfg = reduced_config(get_config("qwen2-1.5b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params(_case("qwen2-1.5b", ())[1], cfg)


def test_layer_schedule_matches_jax():
    from repro.models.blocks import layer_schedule as jschedule

    for arch in ["qwen2-1.5b", "hymba-1.5b", "xlstm-350m",
                 "deepseek-moe-16b"]:
        got = [tuple(vars(r).values())
               for r in tblocks.layer_schedule(get_config(arch))]
        want = [tuple(vars(r).values())
                for r in jschedule(jx().configs.get_config(arch))]
        assert got == want, arch


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_path_matches_plain_on_card(cuda, arch, over, dtype):
    """Prefill and 8 decode steps with the kernels (one prefill launch
    and one decode launch per layer and step, a windowed layer's prefill
    with its window; a hybrid layer's prefill also one ``ssm_scan``
    launch; no plain call) against the plain attention and scan on the
    card (random weights of the port's own). The head dim of the reduced
    configs is 16: the prefill takes the FMA or decode kernel, the decode
    the split-K kernel. (JAX parity of the same functions: the CPU tests
    above.)"""
    name = str(dtype).split(".")[1]
    cfg = reduced_config(get_config(arch), **over, param_dtype=name,
                         compute_dtype=name)
    model = init_model(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (B, T), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(2))
    tol = TOL if dtype == torch.float32 else dict(rtol=5e-2, atol=5e-2)
    tattn.reset_plain_calls()
    tssm.reset_plain_calls()
    kfa_before = dict(kfa.LAUNCHES)
    ssm_before = kss.LAUNCHES["ssm_scan"]
    got = prefill(model, cfg, toks)
    want = prefill(model, cfg, toks, impl="plain")
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
    kc = init_caches(cfg, B, 16, device=cuda)
    pc = init_caches(cfg, B, 16, device=cuda)
    for i in range(STEPS):
        lk, kc = decode_step(model, cfg, kc, toks[:, i:i + 1], i)
        lp, pc = decode_step(model, cfg, pc, toks[:, i:i + 1], i,
                             impl="plain")
        np.testing.assert_allclose(lk.float().cpu().numpy(),
                                   lp.float().cpu().numpy(), **tol)
    torch.cuda.synchronize()
    moved = {k: kfa.LAUNCHES[k] - kfa_before[k] for k in kfa_before}
    assert sum(moved.values()) == cfg.num_layers * (1 + STEPS)
    assert moved["flash_attention_decode"] >= cfg.num_layers * STEPS
    assert tattn.PLAIN_CALLS == {
        "blockwise_causal_attention": cfg.num_layers,
        "decode_attention": cfg.num_layers * STEPS, "chunked_cross": 0}
    # T = 12 is one scan chunk: one kernel scan and one plain scan a layer.
    scans = cfg.num_layers if cfg.family == "hybrid" else 0
    assert kss.LAUNCHES["ssm_scan"] - ssm_before == scans
    assert tssm.PLAIN_CALLS["ssm_scan"] == scans


@pytest.mark.cuda
def test_configs_no_kernel_takes_raise_on_card(cuda):
    """A head dim without an instance raises on the card (prefill and
    decode); the plain impl runs it. A logit softcap and a window do not
    raise: their prefill and decode run the kernels (the softcap's with
    scores scaled past the cap), held to plain."""
    base = get_config("llama3.2-3b")
    x_tok = torch.zeros((1, 4), dtype=torch.long, device=cuda)
    cfg = reduced_config(base, head_dim=48)
    model = init_model(cfg, 0, device=cuda)
    with pytest.raises(ValueError):
        prefill(model, cfg, x_tok)
    caches = init_caches(cfg, 1, 8, device=cuda)
    with pytest.raises(ValueError):
        decode_step(model, cfg, caches, x_tok[:, :1], 0)
    prefill(model, cfg, x_tok, impl="plain")
    decode_step(model, cfg, init_caches(cfg, 1, 8, device=cuda),
                x_tok[:, :1], 0, impl="plain")
    # A softcap of 2 with q and k scaled up: the cap acts on most scores.
    cfg = reduced_config(base, attn_logit_softcap=2.0)
    model = init_model(cfg, 0, device=cuda)
    with torch.no_grad():
        for block in model.runs[0]:
            block.attn.wq.weight.mul_(40.0)
            block.attn.wk.weight.mul_(40.0)
    toks = x_tok + torch.arange(4, device=cuda)
    tattn.reset_plain_calls()
    before = dict(kfa.LAUNCHES)
    got = prefill(model, cfg, toks)
    kc = init_caches(cfg, 1, 8, device=cuda)
    pc = init_caches(cfg, 1, 8, device=cuda)
    for i in range(4):
        lk, kc = decode_step(model, cfg, kc, toks[:, i:i + 1], i)
        lp, pc = decode_step(model, cfg, pc, toks[:, i:i + 1], i,
                             impl="plain")
        np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(), **TOL)
    torch.cuda.synchronize()
    assert sum(kfa.LAUNCHES[k] - before[k] for k in before) == \
        cfg.num_layers * 5
    assert tattn.PLAIN_CALLS == {"blockwise_causal_attention": 0,
                                 "decode_attention": cfg.num_layers * 4,
                                 "chunked_cross": 0}
    want = prefill(model, cfg, toks, impl="plain")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    uncapped = dataclasses.replace(cfg, attn_logit_softcap=0.0)
    assert not np.allclose(prefill(model, uncapped, toks).cpu().numpy(),
                           want.cpu().numpy(), **TOL)
    # A windowed prefill and decode run the kernels (the decode on the
    # ring).
    cfg = reduced_config(base, sliding_window=2)
    model = init_model(cfg, 0, device=cuda)
    tattn.reset_plain_calls()
    got = prefill(model, cfg, x_tok + torch.arange(4, device=cuda))
    assert tattn.PLAIN_CALLS["blockwise_causal_attention"] == 0
    np.testing.assert_allclose(
        got.cpu().numpy(), prefill(model, cfg, x_tok + torch.arange(
            4, device=cuda), impl="plain").cpu().numpy(), **TOL)
    kc = init_caches(cfg, 1, 8, device=cuda)
    pc = init_caches(cfg, 1, 8, device=cuda)
    for i in range(5):
        lk, kc = decode_step(model, cfg, kc, x_tok[:, :1] + i, i)
        lp, pc = decode_step(model, cfg, pc, x_tok[:, :1] + i, i,
                             impl="plain")
        np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(), **TOL)
