"""Port parity: the MoE LM family (deepseek-moe-16b: 2 shared experts
beside the routed ones; grok-1-314b: no shared experts and an attention
logit softcap of 30). On each ``reduced_config`` (4 layers, 4 experts
top-2, per-expert d_ff 64) the JAX ``init_model`` parameters, with the
norms perturbed and the router and experts scaled up so that routing is
decisive and the experts' outputs are O(1), are carried across with
``convert.lm_params``. Held against the JAX package at the suite's
float32 tolerance: ``moe_layer`` against ``_moe_layer_global`` (output,
aux loss and the routing itself: expert ids, ``keep`` and slots) at a
prefill and a decode shape, drop-free (capacity factor 2.0, the reduced
configs' E/k) and dropping (0.5, where the drops are asserted), the MoE
``apply_block`` in both modes, ``prefill`` and teacher-forced
``decode_step`` logits, and the greedy tokens of the service; the plain
attention with the softcap against JAX's. On the card (marker ``cuda``)
each flash kernel with the softcap is held against its plain version,
``moe_layer`` runs without a host sync, and the reduced MoE models'
kernel path is held against ``impl="plain"``. JAX is imported on first
use, not at module level, so on a card's machine without JAX the marked
tests run with ``pytest --noconftest -m cuda``."""
import dataclasses
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
from repro_torch.models import blocks as tblocks
from repro_torch.models import decode_step, init_caches, init_model, prefill
from repro_torch.models import moe as tmoe
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
ARCHS = ["deepseek-moe-16b", "grok-1-314b"]
#: Batch, prompt length, teacher-forced decode steps past it, cache size.
B, T, STEPS, S = 2, 12, 8, 24
#: moe_layer shapes: a prefill [2, 24] and a decode step of 16 tokens
#: (at B = 2 a decode step cannot drop: C is at least 4 and each token
#: sends at most one assignment to an expert).
LAYER_SHAPES = {"prefill": (2, 24), "decode": (16, 1)}
#: Scale of the router and of the experts in the tests' weights.
ROUTER_SCALE, EXPERT_SCALE = 25.0, 5.0


@functools.lru_cache(maxsize=None)
def jx():
    """The JAX side: ``jax``, ``jnp``, the configs, models and service."""
    import jax
    import jax.numpy as jnp

    from repro import configs, models
    from repro.launch import serve
    from repro.models import attention, blocks, moe

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 models=models, attention=attention,
                                 blocks=blocks, moe=moe, serve=serve)


def _jcfg(arch, **over):
    j = jx()
    return dataclasses.replace(
        j.configs.reduced_config(j.configs.get_config(arch)), **over)


def _cfg(arch, **over):
    return dataclasses.replace(reduced_config(get_config(arch)), **over)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """Numpy parameters (perturbed and scaled) and JAX parameters."""
    j = jx()
    params, _ = j.models.init_model(_jcfg(arch), j.jax.random.PRNGKey(0))
    out = j.jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   params)
    rng = np.random.default_rng(1)

    def perturb(a):
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    out["final_norm"] = perturb(out["final_norm"])
    for run in out["runs"]:
        run["ln1"], run["ln2"] = perturb(run["ln1"]), perturb(run["ln2"])
        moe = run["moe"]
        moe["router"] = moe["router"] * np.float32(ROUTER_SCALE)
        for name in ("w_gate", "w_up", "w_down"):
            moe[name] = moe[name] * np.float32(EXPERT_SCALE)
    return out, j.jax.tree_util.tree_map(j.jnp.asarray, out)


@functools.lru_cache(maxsize=None)
def _model(arch):
    return convert.lm_params(_jax_model(arch)[0], _cfg(arch), device="cpu")


def _layer(arch, li=0):
    """JAX parameters of layer ``li`` (one run: every layer is MoE)."""
    j = jx()
    return j.jax.tree_util.tree_map(lambda a: j.jnp.asarray(a[li]),
                                    _jax_model(arch)[0]["runs"][0])


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _x(shape, seed, d):
    return np.random.default_rng(seed).standard_normal(
        shape + (d,)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reduced_moe(arch):
    cfg = _cfg(arch)
    full = get_config(arch)
    assert (cfg.family, cfg.num_experts, cfg.num_experts_per_tok,
            cfg.d_ff_per_expert, cfg.capacity_factor) == (
        "moe", 4, 2, 64, 2.0)
    assert cfg.num_shared_experts == (1 if full.num_shared_experts else 0)
    assert cfg.attn_logit_softcap == full.attn_logit_softcap
    assert [(r.kind, r.count, r.window) for r in
            tblocks.layer_schedule(cfg)] == [("moe", 4, 0)]
    # The full widths the card serves: 64 routed experts top-6 plus 2
    # shared (deepseek); 8 experts top-2 and a softcap of 30 (grok).
    assert {"deepseek-moe-16b": (64, 6, 2, 1408, 0.0),
            "grok-1-314b": (8, 2, 0, 32768, 30.0)}[arch] == (
        full.num_experts, full.num_experts_per_tok, full.num_shared_experts,
        full.d_ff_per_expert, full.attn_logit_softcap)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_parameters_carried_across(arch):
    jp = _jax_model(arch)[0]["runs"][0]["moe"]
    moe = _model(arch).runs[0][2].moe
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(_np(getattr(moe, name)), jp[name][2])
    if "shared" in jp:
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                _np(getattr(moe.shared, name).weight), jp["shared"][name][2].T)
    else:
        assert moe.shared is None


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_matches_reference_shapes(arch):
    """The port's own random init: the reference's parameter shapes."""
    j = jx()
    want, _ = j.moe.init_moe(_jcfg(arch), j.jax.random.PRNGKey(0),
                             j.jnp.float32)
    got = tmoe.init_moe(_cfg(arch), torch.Generator().manual_seed(0),
                        torch.float32)
    for name, w in want.items():
        if name == "shared":
            for sub, ws in w.items():
                assert tuple(getattr(got.shared, sub).weight.T.shape) == \
                    ws.shape
        else:
            assert tuple(getattr(got, name).shape) == w.shape, name


@pytest.mark.parametrize("n,want", [(2, 4), (16, 20), (48, 52), (64, 68)])
def test_capacity_matches_jax(n, want):
    cfg = _cfg("deepseek-moe-16b")
    assert tmoe._capacity(n, cfg) == jx().moe._capacity(
        n, _jcfg("deepseek-moe-16b")) == want
    # deepseek-moe-16b at full width: C = 8 at a decode step of 64 tokens.
    full = get_config("deepseek-moe-16b")
    assert tmoe._capacity(64, full) == jx().moe._capacity(
        64, jx().configs.get_config("deepseek-moe-16b")) == 8


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax(arch, mode, cf):
    """Output, aux loss and routing against ``_moe_layer_global`` and the
    reference's own routing (``_route_local``: the same top-k, stable
    sort, ranks and slots). At capacity factor 0.5 assignments are
    dropped; at 2.0 (E/k) none can be. Ties in the router's float32
    probabilities, where the two top-k could order differently, do not
    occur on these inputs (the ids are compared)."""
    j = jx()
    jcfg, cfg = _jcfg(arch, capacity_factor=cf), _cfg(arch,
                                                      capacity_factor=cf)
    x = _x(LAYER_SHAPES[mode], 3, cfg.d_model)
    lp = _layer(arch)["moe"]
    want, waux = j.moe._moe_layer_global(lp, j.jnp.asarray(x), jcfg)
    layer = _model(arch).runs[0][0].moe
    with torch.no_grad():
        got, aux = tmoe.moe_layer(layer, torch.tensor(x), cfg)
        r = tmoe.route(layer, torch.tensor(x).reshape(-1, cfg.d_model), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert np.abs(_np(want)).max() > 0.1  # the experts' outputs matter
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(waux), **TOL)

    _, (keep, slot, tok, gate, C), _ = j.moe._route_local(
        j.jnp.asarray(x.reshape(-1, cfg.d_model)), lp["router"], jcfg)
    assert r["C"] == C
    for name, w in (("keep", keep), ("slot", slot), ("tok", tok)):
        np.testing.assert_array_equal(r[name].numpy(), np.asarray(w), name)
    np.testing.assert_allclose(r["gate_sorted"].numpy(), np.asarray(gate),
                               **TOL)
    n_dropped = int(tmoe.dropped(r))
    if cf == 2.0:
        assert n_dropped == 0
    else:
        assert n_dropped > 0
        assert n_dropped == int((~np.asarray(keep)).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_prefill_matches_jax(arch):
    j = jx()
    cfg = _cfg(arch)
    x = _x((B, T), 4, cfg.d_model)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, _, waux = j.blocks.apply_block(
        _layer(arch, 1), j.jnp.asarray(x), _jcfg(arch), "moe",
        positions=j.jnp.asarray(pos), window=0)
    with torch.no_grad():
        got, cache, aux = tblocks.apply_block(
            _model(arch).runs[0][1], torch.tensor(x), cfg, "moe",
            positions=torch.tensor(pos), window=0)
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_decode_matches_jax(arch):
    """One step against a cache of 9 rows: output, the written row, aux."""
    j = jx()
    cfg = _cfg(arch)
    rng = np.random.default_rng(5)
    length = 9
    kv = [rng.standard_normal((B, cfg.num_kv_heads, S,
                               cfg.resolved_head_dim)).astype(np.float32)
          for _ in range(2)]
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((B, 1), length, np.int32)
    want, wc, waux = j.blocks.apply_block(
        _layer(arch, 3), j.jnp.asarray(x), _jcfg(arch), "moe",
        positions=j.jnp.asarray(pos), window=0,
        cache=dict(attn=j.attention.KVCache(
            j.jnp.asarray(kv[0]), j.jnp.asarray(kv[1]),
            j.jnp.asarray(length, j.jnp.int32))))
    tcache = dict(attn=tattn.KVCache(torch.tensor(kv[0]), torch.tensor(kv[1]),
                                     torch.tensor(length, dtype=torch.int32)))
    with torch.no_grad():
        got, gc, aux = tblocks.apply_block(
            _model(arch).runs[0][3], torch.tensor(x), cfg, "moe",
            positions=torch.tensor(pos), window=0, cache=tcache)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    assert int(gc["attn"].length) == length + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(getattr(gc["attn"], name)),
                                   _np(getattr(wc["attn"], name)), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_logits(arch):
    """JAX prefill logits over the first T tokens, and the logits of
    T + STEPS teacher-forced decode steps (caches of S)."""
    j = jx()
    jcfg, jparams = _jcfg(arch), _jax_model(arch)[1]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch):
    cfg = _cfg(arch)
    tokens, pre, _ = _jax_logits(arch)
    got = prefill(_model(arch), cfg, torch.tensor(tokens[:, :T]))
    assert got.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), pre, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_jax(arch):
    """Every logit of 20 teacher-forced steps (a decode step of B = 2
    tokens is drop-free at any capacity factor)."""
    cfg = _cfg(arch)
    tokens, _, dec = _jax_logits(arch)
    caches = init_caches(cfg, B, S, device="cpu")
    for i in range(T + STEPS):
        logits, caches = decode_step(_model(arch), cfg, caches,
                                     torch.tensor(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(logits.numpy(), dec[i], **TOL,
                                   err_msg=f"step {i}")
    assert caches[0]["attn"].length.tolist() == [T + STEPS] * cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_prefill(arch):
    """Drop-free (the reduced capacity factor E/k), so the teacher-forced
    decode equals the prefill at the last position."""
    cfg = _cfg(arch)
    tokens = torch.tensor(_jax_logits(arch)[0][:, :T])
    caches = init_caches(cfg, B, S, device="cpu")
    for i in range(T):
        logits, caches = decode_step(_model(arch), cfg, caches,
                                     tokens[:, i:i + 1], torch.tensor(i))
    np.testing.assert_allclose(logits.numpy(),
                               prefill(_model(arch), cfg, tokens).numpy(),
                               **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_stack_sums_the_aux_losses(arch):
    """The stack's aux total is the sum of the layers' (as the
    reference's scan sums them)."""
    from repro_torch.models.transformer import _apply_stack, _positions

    cfg = _cfg(arch)
    m = _model(arch)
    x = torch.tensor(_x((B, T), 6, cfg.d_model))
    pos = _positions(cfg, B, T)
    runs = tblocks.layer_schedule(cfg)
    with torch.no_grad():
        _, _, total = _apply_stack(m, x, cfg, runs, positions=pos)
        h, want = x, 0.0
        for block in m.runs[0]:
            h, _, aux = tblocks.apply_block(block, h, cfg, "moe",
                                            positions=pos, window=0)
            want = want + aux
    assert total.dtype == torch.float32
    torch.testing.assert_close(total, want)
    assert 0.5 * cfg.num_layers < float(total) < 2.0 * cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("prompt_len,gen,max_len", [(12, 8, 24), (5, 4, 9)])
def test_greedy_tokens_equal_jax_serve(arch, prompt_len, gen, max_len):
    """The JAX service (its weights from seed 0, its prompts from seed 1)
    and the port's loop on the same weights and prompts."""
    j = jx()
    scfg = j.serve.ServeConfig(arch=arch, batch=2, prompt_len=prompt_len,
                               gen=gen, max_len=max_len)
    want = np.asarray(j.serve.serve(scfg, emit=lambda _: None)["tokens"])
    jcfg = _jcfg(arch)
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    prompts = j.jax.random.randint(j.jax.random.PRNGKey(1),
                                   (2, prompt_len), 0, jcfg.vocab_size)
    cfg = _cfg(arch)
    m = convert.lm_params(j.jax.tree_util.tree_map(np.asarray, params), cfg,
                          device="cpu")
    out = tserve.generate(m, cfg, torch.tensor(np.asarray(prompts)), gen,
                          max_len)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    assert out["logits"].shape == (2, 1, cfg.padded_vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_moe_family_on_cpu(arch, capsys):
    tserve.main(["--workload", "decode", "--arch", arch, "--batch", "2",
                 "--prompt-len", "6", "--gen", "3", "--device", "cpu"])
    assert "[serve] 2 seqs x 9 steps" in capsys.readouterr().out


def test_init_model_builds_both_reduced_moe_models():
    for arch in ARCHS:
        cfg = _cfg(arch)
        m = init_model(cfg, 0, device="cpu")
        blocks = [b for run in m.runs for b in run]
        assert len(blocks) == cfg.num_layers
        assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
                   for b in blocks)


# ---------------------------------------------------------------------------
# The logit softcap in the plain attention versions
# ---------------------------------------------------------------------------

#: Scores of q.k / sqrt(Dh) with q and k scaled by this reach far past
#: the cap of 30 (a spread of ~64 at Dh 16).
CAP, PEAK = 30.0, 8.0


def _capped_qkv(rng, Bq, Hq, Hkv, Tq, Tk, Dh):
    return (PEAK * rng.standard_normal((Bq, Hq, Tq, Dh)),
            PEAK * rng.standard_normal((Bq, Hkv, Tk, Dh)),
            rng.standard_normal((Bq, Hkv, Tk, Dh)))


@pytest.mark.parametrize("T_,chunk", [(40, 16), (64, 64)])
def test_flash_plain_softcap_matches_jax_blockwise(T_, chunk):
    """`flash_attention_plain(softcap=)` (GQA 4:2) against the JAX
    model's ``blockwise_causal_attention`` (kv expanded to 4 heads), with
    scores past ±60, at the float32 TOL; the cap changes the output by
    far more than the tolerance."""
    j = jx()
    q, k, v = _capped_qkv(np.random.default_rng(T_), 2, 4, 2, T_, T_, 16)
    s = np.einsum("bhqd,bhkd->bhqk", q[:, ::2], k) / 4.0
    assert np.abs(s).max() > 2 * CAP
    tq, tk, tv = (torch.tensor(a, dtype=torch.float32) for a in (q, k, v))
    got = kfa.flash_attention_plain(tq, tk, tv, softcap=CAP, block_q=16,
                                    block_k=32)

    def jt(a, expand=False):  # [B, H, T, Dh] -> [B, T, H, Dh]
        a = np.repeat(a, 2, axis=1) if expand else a
        return j.jnp.asarray(a.transpose(0, 2, 1, 3).astype(np.float32))

    want = j.attention.blockwise_causal_attention(
        jt(q), jt(k, True), jt(v, True), chunk=chunk, softcap=CAP)
    want = np.asarray(want).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), want, **TOL)
    uncapped = _np(kfa.flash_attention_plain(tq, tk, tv))
    assert not np.allclose(uncapped, want, **TOL)
    # The port's model-level plain attention takes the same cap.
    mine = tattn.blockwise_causal_attention(
        *(torch.tensor(np.asarray(a)) for a in (jt(q), jt(k, True),
                                                jt(v, True))),
        chunk=chunk, softcap=CAP)
    np.testing.assert_allclose(_np(mine).transpose(0, 2, 1, 3), want, **TOL)


@pytest.mark.parametrize("length", [1, 17, 24])
def test_decode_plain_softcap_matches_jax(length):
    """`decode_attention_plain(softcap=)` against the JAX model's
    ``decode_attention`` on a cache of 24 rows, ``length`` of them valid
    (GQA group 3), scores past ±60."""
    j = jx()
    q, k, v = _capped_qkv(np.random.default_rng(length), 2, 6, 2, 1, 24, 16)
    L = np.int32(length)
    want = j.attention.decode_attention(
        j.jnp.asarray(q.transpose(0, 2, 1, 3).astype(np.float32)),
        j.attention.KVCache(j.jnp.asarray(k.astype(np.float32)),
                            j.jnp.asarray(v.astype(np.float32)),
                            j.jnp.asarray(L)), softcap=CAP)
    want = np.asarray(want).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.tensor(a, dtype=torch.float32) for a in (q, k, v))
    tl = torch.tensor(length, dtype=torch.int32)
    got = kfa.decode_attention_cuda(tq, tk, tv, tl, softcap=CAP)  # CPU: plain
    np.testing.assert_allclose(_np(got), want, **TOL)
    if length > 1:
        uncapped = _np(kfa.decode_attention_plain(tq, tk, tv, tl))
        assert not np.allclose(uncapped, want, **TOL)


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: (B, Hq, Hkv, Tq, Tk, Dh, dtype): grok's head layout (48 query heads,
#: 8 kv heads, Dh 128) in a bf16 prefill (the ``wgmma`` kernel) and a bf16
#: decode step (the decode kernel, 6 rows per kv head); the FMA kernel in
#: float32 and at Dh 16; decode at 16 rows.
CAP_CARD_CASES = [(1, 48, 8, 200, 200, 128, "bfloat16"),
                  (2, 48, 8, 1, 300, 128, "bfloat16"),
                  (1, 4, 2, 130, 130, 64, "float32"),
                  (2, 4, 2, 40, 40, 16, "bfloat16"),
                  (2, 16, 2, 2, 600, 64, "float32")]


def _card(arrays, dtype, device):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return [torch.tensor(np.asarray(a, np.float32), device=device).to(tdt)
            for a in arrays]


def test_cap_card_cases_reach_every_kernel():
    kernels = set()
    for Bq, Hq, Hkv, Tq, Tk, Dh, dtype in CAP_CARD_CASES:
        q = torch.empty((Bq, Hq, Tq, Dh), dtype=getattr(torch, dtype),
                        device="meta")
        kernels.add(kfa.select_kernel(q, q[:, :Hkv]))
    assert kernels == {"decode", "wgmma", "fma"}


@pytest.mark.cuda
@pytest.mark.parametrize("Bq,Hq,Hkv,Tq,Tk,Dh,dtype", CAP_CARD_CASES)
def test_softcap_kernels_match_plain_on_card(cuda, Bq, Hq, Hkv, Tq, Tk, Dh,
                                             dtype):
    """Each kernel with the cap (the one the dispatch picks, and only it)
    against its plain version with the cap, on scores past ±60; the plain
    version without the cap is far off. The decode kernel also on a cache
    read in place (``decode_attention_cuda``)."""
    tol = TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    q, k, v = _card(_capped_qkv(np.random.default_rng(Tq), Bq, Hq, Hkv, Tq,
                                Tk, Dh), dtype, cuda)
    kernel = kfa.select_kernel(q, k)
    before = dict(kfa.LAUNCHES)
    got = kfa.flash_attention_cuda(q, k, v, softcap=CAP)
    torch.cuda.synchronize()
    assert {n: kfa.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n == kfa.KERNEL_COUNTERS[kernel]) for n in before}
    want = kfa.flash_attention_plain(q, k, v, softcap=CAP)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert not np.allclose(_np(kfa.flash_attention_plain(q, k, v)),
                           _np(want), **tol)
    if kernel == "decode" and Tq == 1:
        length = torch.tensor(Tk - 5, dtype=torch.int32, device=cuda)
        got = kfa.decode_attention_cuda(q, k, v, length, softcap=CAP)
        want = kfa.decode_attention_plain(q, k, v, length, softcap=CAP)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_makes_no_host_sync_on_card(cuda, arch):
    """A decode-shaped and a prefill-shaped ``moe_layer`` under
    ``set_sync_debug_mode("error")``, and equal to the CPU's result on the
    same weights (float32; the CUDA ``index_add_`` sums in any order)."""
    cfg = _cfg(arch, capacity_factor=0.5)
    layer = tmoe.init_moe(cfg, torch.Generator().manual_seed(0),
                          torch.float32)
    with torch.no_grad():
        layer.router.mul_(ROUTER_SCALE)
    card = tmoe.init_moe(cfg, torch.Generator(cuda).manual_seed(0),
                         torch.float32)
    card.load_state_dict(layer.state_dict())
    for shape in LAYER_SHAPES.values():
        x = torch.tensor(_x(shape, 7, cfg.d_model))
        xc = x.to(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                got, aux = tmoe.moe_layer(card, xc, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        with torch.no_grad():
            want, waux = tmoe.moe_layer(layer, x, cfg)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(float(aux), float(waux), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernel_path_matches_plain_on_card(cuda, arch, dtype):
    """Prefill and 8 decode steps of the reduced MoE model with the
    kernels (grok's with the softcap: one prefill launch and one decode
    launch per layer and step, no plain call) against ``impl="plain"`` on
    the card (random weights of the port's own)."""
    name = str(dtype).split(".")[1]
    cfg = _cfg(arch, param_dtype=name, compute_dtype=name)
    model = init_model(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (B, T), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(2))
    tol = TOL if dtype == torch.float32 else dict(rtol=5e-2, atol=5e-2)
    tattn.reset_plain_calls()
    before = dict(kfa.LAUNCHES)
    got = prefill(model, cfg, toks)
    kc = init_caches(cfg, B, 16, device=cuda)
    for i in range(STEPS):
        lk, kc = decode_step(model, cfg, kc, toks[:, i:i + 1], i)
    torch.cuda.synchronize()
    moved = {n: kfa.LAUNCHES[n] - before[n] for n in before}
    assert sum(moved.values()) == cfg.num_layers * (1 + STEPS)
    assert moved["flash_attention_decode"] >= cfg.num_layers * STEPS
    assert not any(tattn.PLAIN_CALLS.values())
    want = prefill(model, cfg, toks, impl="plain")
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    pc = init_caches(cfg, B, 16, device=cuda)
    for i in range(STEPS):
        lp, pc = decode_step(model, cfg, pc, toks[:, i:i + 1], i,
                             impl="plain")
    np.testing.assert_allclose(_np(lk), _np(lp), **tol)
