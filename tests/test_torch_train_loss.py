"""Port parity: the training loss and its gradients.

For each of the five families' ``reduced_config`` the JAX ``init_model``
parameters (norms and zero-initialised leaves drawn at random, so that
every leaf's conversion matters) are carried across with
``convert.lm_params``, and the port's `models.train_loss` (loss, ``ce``,
``aux``) and the gradient of every parameter (`launch.steps.
loss_and_grads`) are held against ``jax.value_and_grad`` of the JAX
``train_loss`` at the suite's float32 tolerance, the JAX gradients laid
out by ``convert.lm_tree``. The encoder-decoder also runs on a seeded
random frontend (its zero frontend gives an exactly zero memory, ROADMAP
C4). Reduced qwen2 with ``tp_size=8`` pads 4 query heads to 8: the
reference's training attention runs the padded heads, so their ``wo``
rows get nonzero gradients, and the port's equal them. ``remat="none"``
gives the numbers of ``"block"`` bit for bit. A JAX-only test records the
reference's fault: its padded heads, made live by one step, change its
prefill but not its decode. The plain scan's gradient across its time
chunks equals ``jax.grad`` of the JAX scan oracle. On the card (marker
``cuda``) every kernel
wrapper raises under grad, and a training loss launches no kernel. JAX is
imported on first use, so on a card's machine without JAX the marked
tests run with ``pytest --noconftest -m cuda``.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import init_model, train_loss
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
B, T = 2, 40
#: (arch, reduced_config overrides, frontend): the five families, the
#: encoder-decoder on a random frontend too, and qwen2 with padded heads.
CASES = [("qwen2-1.5b", {}, None), ("hymba-1.5b", {}, None),
         ("deepseek-moe-16b", {}, None), ("xlstm-350m", {}, None),
         ("seamless-m4t-medium", {}, "zeros"),
         ("seamless-m4t-medium", {}, "random"),
         ("qwen2-1.5b", {"tp_size": 8}, None)]
IDS = ["dense", "hybrid", "moe", "xlstm", "encdec-zero-frontend",
       "encdec-random-frontend", "qwen2-padded-heads"]


@functools.lru_cache(maxsize=None)
def jx():
    import jax
    import jax.numpy as jnp

    from repro import configs, models

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 models=models)


def _configs(arch, overrides):
    j = jx()
    jcfg = j.configs.reduced_config(j.configs.get_config(arch), **overrides)
    cfg = reduced_config(get_config(arch), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _perturbed(params, seed):
    """The JAX parameters as numpy, each leaf that is constant at init
    (norms at 1, biases and ``D`` at 0 or 1) drawn at random around its
    value, so each one's conversion and gradient is tested."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a, np.float32)
        if a.size and np.all(a == a.flat[0]):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a

    return jx().jax.tree_util.tree_map(draw, params)


def _batch(cfg, frontend, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if frontend is not None:
        shape = (B, cfg.encoder_seq_len, cfg.d_model)
        batch["enc_emb"] = (np.zeros(shape, np.float32) if frontend == "zeros"
                            else rng.standard_normal(shape).astype(
                                np.float32))
    return batch


@functools.lru_cache(maxsize=None)
def _jax_case(arch, overrides_items, frontend):
    """JAX's loss, metrics and gradients on the case's weights and batch."""
    j = jx()
    jcfg, cfg = _configs(arch, dict(overrides_items))
    params = _perturbed(j.models.init_model(jcfg, j.jax.random.PRNGKey(0))[0],
                        seed=3)
    batch = _batch(cfg, frontend)
    jbatch = {k: j.jnp.asarray(v) for k, v in batch.items()}
    fn = j.jax.jit(j.jax.value_and_grad(
        lambda p: j.models.train_loss(p, jcfg, jbatch), has_aux=True))
    (loss, metrics), grads = fn(params)
    to_np = functools.partial(j.jax.tree_util.tree_map, np.asarray)
    return cfg, params, batch, float(loss), to_np(metrics), to_np(grads)


def _port(cfg, params, batch):
    model = convert.lm_params(params, cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return model, tb


@pytest.mark.parametrize("arch,overrides,frontend", CASES, ids=IDS)
def test_train_loss_and_gradients_match_jax(arch, overrides, frontend):
    cfg, params, batch, jloss, jmet, jgrads = _jax_case(
        arch, tuple(overrides.items()), frontend)
    model, tb = _port(cfg, params, batch)
    loss, metrics, grads = loss_and_grads(model, cfg, tb)
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]), **TOL)
    if cfg.num_experts:
        assert float(metrics["aux"]) > 0
    want = convert.lm_tree(jgrads, grads.keys())
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n], **TOL, err_msg=n)
    if frontend == "random":  # the memory reaches every cross leaf
        for n, g in grads.items():
            if n.startswith("cross_attn.") and "bias" not in n:
                assert float(g.abs().max()) > 0, n
    if cfg.padded_heads != cfg.num_heads:
        dh, H = cfg.resolved_head_dim, cfg.num_heads
        pad = grads["runs.0.0.attn.wo.weight"][:, H * dh:]
        assert float(pad.abs().max()) > 0.1 * float(
            grads["runs.0.0.attn.wo.weight"][:, :H * dh].abs().max())


@pytest.mark.parametrize("T_", [100, 300])
def test_plain_scan_gradients_match_jax(T_):
    """``ssm_scan_plain`` under autograd across several of its time
    chunks (T > ``CHUNK``, where each chunk's carry is the previous
    chunk's last state: the full-width SSM and mLSTM scans have two or
    more) against ``jax.grad`` of the JAX package's scan oracle."""
    from repro_torch.kernels.ssm_scan.ssm_scan import CHUNK, ssm_scan_plain

    j = jx()
    from repro.kernels.ssm_scan.ref import ssm_scan_ref

    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 1.0, (2, T_, 6)).astype(np.float32)
    b = rng.standard_normal((2, T_, 6)).astype(np.float32)
    w = rng.standard_normal((2, T_, 6)).astype(np.float32)
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    (ssm_scan_plain(ta, tb) * torch.from_numpy(w)).sum().backward()
    ga, gb = j.jax.grad(lambda a, b: (ssm_scan_ref(a, b) * w).sum(),
                        argnums=(0, 1))(j.jnp.asarray(a), j.jnp.asarray(b))
    assert T_ < CHUNK or T_ > 2 * CHUNK
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **TOL)


def test_remat_none_equals_block():
    cfg = reduced_config(get_config("deepseek-moe-16b"))
    assert cfg.remat == "block"
    model = init_model(cfg, 0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, None).items()}
    out = {}
    for remat in ("block", "none", "dots"):
        out[remat] = loss_and_grads(model, dataclasses.replace(
            cfg, remat=remat), tb)
    for remat in ("none", "dots"):
        assert torch.equal(out[remat][0], out["block"][0])
        for n, g in out["block"][2].items():
            assert torch.equal(out[remat][2][n], g), n
    with pytest.raises(ValueError):
        train_loss(model, dataclasses.replace(cfg, remat="full"), tb)


def test_train_loss_masks_ignored_labels():
    """``labels == -1`` leave the mean (the reference's ``ignore_id``):
    masking the second half of a causal model's labels gives the loss of
    the first half alone; `cross_entropy_loss` equals JAX's with a padded
    vocabulary, ignored labels and ``z_loss``."""
    from repro_torch.models.layers import cross_entropy_loss

    cfg = reduced_config(get_config("qwen2-1.5b"))
    model = init_model(cfg, 0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, None).items()}
    masked = dict(tb, labels=tb["labels"].clone())
    masked["labels"][:, T // 2:] = -1
    with torch.no_grad():
        full, _ = train_loss(model, cfg, tb)
        half, _ = train_loss(model, cfg, masked)
        first, _ = train_loss(model, cfg, {k: v[:, :T // 2]
                                           for k, v in tb.items()})
    assert float(half) != float(full)
    assert float(half) == pytest.approx(float(first), rel=1e-5)  # causal
    logits = torch.randn(2, 3, 70, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[1, -1, 5], [-1, -1, 2]])
    got = cross_entropy_loss(logits, labels, 64, z_loss=1e-4)
    want = jx().models.layers.cross_entropy_loss(
        jx().jnp.asarray(logits.numpy()), jx().jnp.asarray(labels.numpy()),
        64, z_loss=1e-4)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    none = cross_entropy_loss(logits, torch.full((2, 3), -1), 64)
    assert float(none) == 0.0


def test_reference_padded_heads_go_live_in_training():
    """A fault of the reference (ROADMAP C): its training attention runs
    the padded query heads (``attention_layer``'s train branch expands
    k/v to every padded head), so their ``wo`` rows get gradients as
    large as the real rows'; after one step their output is no longer 0.
    Its decode runs the real heads only, so the trained model's decode no
    longer computes its own prefill."""
    j = jx()
    jnp = j.jnp
    jcfg, cfg = _configs("qwen2-1.5b", {"tp_size": 8})
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, None).items()}
    grads = j.jax.grad(lambda p: j.models.train_loss(p, jcfg, batch)[0])(
        params)
    dh, H = cfg.resolved_head_dim, cfg.num_heads
    wo = np.asarray(grads["runs"][0]["attn"]["wo"])   # [layers, Hp dh, d]
    pad, real = np.abs(wo[:, H * dh:]).max(), np.abs(wo[:, :H * dh]).max()
    assert pad > 0.5 * real, (pad, real)
    # One signed step on wo alone makes the padded heads live.
    runs = [dict(r, attn=dict(r["attn"], wo=r["attn"]["wo"] - 1e-2 * jnp.sign(
        g["attn"]["wo"]))) for r, g in zip(params["runs"], grads["runs"])]
    trained = dict(params, runs=runs)
    tokens = batch["tokens"][:1, :8]
    pre = np.asarray(j.models.prefill(trained, jcfg, tokens))[:, -1]
    caches = j.models.init_caches(jcfg, 1, 8)
    for t in range(8):
        logits, caches = j.models.decode_step(
            trained, jcfg, caches, tokens[:, t:t + 1], jnp.int32(t))
    dec = np.asarray(logits)[:, -1]
    gap = np.abs(pre - dec).max() / np.abs(pre).max()
    assert gap > 1e-3, gap
    untrained = np.asarray(j.models.prefill(params, jcfg, tokens))[:, -1]
    caches = j.models.init_caches(jcfg, 1, 8)
    for t in range(8):
        logits, caches = j.models.decode_step(
            params, jcfg, caches, tokens[:, t:t + 1], jnp.int32(t))
    np.testing.assert_allclose(np.asarray(logits)[:, -1], untrained, **TOL)


# ---------------------------------------------------------------------------
# On the card (marker `cuda`; skipped where there is none)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_wrappers_raise_under_grad(cuda):
    from repro_torch.core.types import FilteringElement, SmoothingElement
    from repro_torch.kernels.flash_attention import flash_attention as kfa
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.kernels.ssm_scan import ssm_scan as kss

    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=cuda, dtype=dtype)

    q, k, v = (rand(1, 2, 64, 64, dtype=torch.bfloat16) for _ in range(3))
    a, b = rand(2, 16, 8), rand(2, 16, 8)
    length = torch.tensor([64], dtype=torch.int32, device=cuda)
    eye = torch.eye(3, device=cuda).expand(4, 3, 3)
    fe = FilteringElement(A=eye.clone(), b=rand(4, 3), C=eye.clone(),
                          eta=rand(4, 3), J=eye.clone())
    se = SmoothingElement(E=eye.clone(), g=rand(4, 3), L=eye.clone())
    calls = {
        "flash_attention": lambda: kfa.flash_attention_cuda(q, k, v),
        "decode_attention": lambda: kfa.decode_attention_cuda(
            q[:, :, :1].contiguous(), k, v, length),
        "ssm_scan": lambda: kss.ssm_scan_cuda(a, b),
        "filtering_combine": lambda: kc.filtering_combine_cuda(fe, fe),
        "smoothing_combine": lambda: kc.smoothing_combine_cuda(se, se)}
    grad_inputs = {"flash_attention": [q], "decode_attention": [q],
                   "ssm_scan": [b], "filtering_combine": [fe.b],
                   "smoothing_combine": [se.g]}
    for name, call in calls.items():
        call()                             # no input requires grad: runs
        for t in grad_inputs[name]:
            t.requires_grad_(True)
        with torch.no_grad():
            call()                         # grad mode off: runs
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        for t in grad_inputs[name]:
            t.requires_grad_(False)


@pytest.mark.cuda
def test_train_loss_on_card_launches_no_kernel(cuda, monkeypatch):
    """The hybrid family's gradients on the card (float32, TF32 off)
    equal the CPU's, and no kernel launches."""
    from repro_torch.kernels.flash_attention import flash_attention as kfa
    from repro_torch.kernels.ssm_scan import ssm_scan as kss

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = reduced_config(get_config("hymba-1.5b"))
    model = init_model(cfg, 0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, None).items()}
    loss_cpu, _, g_cpu = loss_and_grads(model, cfg, tb)
    model = model.to(cuda)
    for mod in (kfa, kss):
        mod.reset_launch_counts()
    loss, _, grads = loss_and_grads(model, cfg,
                                    {k: v.to(cuda) for k, v in tb.items()})
    assert sum(kfa.LAUNCHES.values()) + sum(kss.LAUNCHES.values()) == 0
    np.testing.assert_allclose(float(loss), float(loss_cpu), **TOL)
    for n, g in grads.items():
        np.testing.assert_allclose(g.cpu().numpy(), g_cpu[n].numpy(), **TOL,
                                   err_msg=n)
