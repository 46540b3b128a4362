"""Port parity and self-consistency of the step count
(`repro_torch.launch.cost`) and the roofline (`launch.roofline`).

* A ``meta`` trace of a reduced step counts exactly what a CPU run of
  the same step counts: the train step (autograd, remat, AdamW), and the
  prefill and decode steps, whose attention and scans count by their
  kernels' formulas while the plain versions run.
* The count's trip-count shortcut for the sLSTM's time loop on ``meta``
  (`repro_torch.counting.repeated`) counts what the whole loop counts.
* One dense layer counts ``2 M K N`` FLOPs and its operand and output
  bytes; a plain call of each kernel wrapper counts its kernel's formula
  (`kernels.work`) and none of its operations.
* ``model_flops`` equals the JAX package's on every (arch x shape) cell.
* Beside the JAX package's ``analyze_hlo`` of the same reduced
  one-device qwen2-1.5b train and decode steps (recorded in ROADMAP C,
  not gated: the port's eager operations are not XLA's fusions)."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ALL_SHAPES, get_config, list_configs
from repro_torch import counting
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.types import FilteringElement, SmoothingElement
from repro_torch.kernels import work
from repro_torch.kernels.flash_attention import flash_attention as kfa
from repro_torch.kernels.kalman_combine import kalman_combine as kc
from repro_torch.kernels.ssm_scan import ssm_scan as kss
from repro_torch.launch import roofline
from repro_torch.launch.cost import count, count_cell, meta_inputs
from repro_torch.launch.steps import make_cell_plan
from _torch_jax import release_jax_caches  # noqa: F401

B, T, S = 2, 64, 128


def _plan(arch, kind):
    cfg = reduced_config(get_config(arch))
    shape = ShapeConfig("s", S if kind == "decode" else T, B, kind)
    return make_cell_plan(cfg, None, shape)


def _cpu(t):
    """A CPU tensor standing for meta tensor ``t``: integers 0, floats
    drawn (values do not change a count)."""
    if not t.is_floating_point():
        return torch.zeros(t.shape, dtype=t.dtype)
    g = torch.Generator().manual_seed(t.numel())
    return (0.02 * torch.randn(t.shape, generator=g)).to(t.dtype)


def _cpu_tree(x):
    if isinstance(x, torch.Tensor):
        return _cpu(x)
    if isinstance(x, dict):
        return {k: _cpu_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        out = [_cpu_tree(v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    return x


@pytest.mark.parametrize("arch,kind", [
    ("qwen2-1.5b", "train"), ("qwen2-1.5b", "prefill"),
    ("qwen2-1.5b", "decode"), ("hymba-1.5b", "prefill"),
    ("xlstm-350m", "prefill"), ("seamless-m4t-medium", "decode")])
def test_meta_trace_equals_cpu_run(arch, kind):
    plan = _plan(arch, kind)
    meta, _ = count_cell(plan)
    # The same step on the CPU: a model of real tensors, real inputs.
    from repro_torch.models.transformer import init_model

    plan = _plan(arch, kind)
    margs, mkw = meta_inputs(plan)
    model = init_model(plan.cfg, 0, device="cpu")
    if kind == "train":
        state = plan.init_state(model)
        args = (state, _cpu_tree(margs[1]))
    else:
        args = (plan.bind(model),) + tuple(_cpu_tree(a) for a in margs[1:])
    _, cpu = count(plan.step_fn, *args, **_cpu_tree(mkw))
    cpu = cpu.summary()
    assert cpu["flops"] == meta["flops"] > 0
    assert cpu["hbm_bytes"] == meta["hbm_bytes"] > 0
    assert cpu["kernels"] == meta["kernels"]
    if kind != "train":
        assert sum(meta["kernels"].values()) > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_loop_shortcut_counts_the_whole_loop(kind, monkeypatch):
    cfg = reduced_config(get_config("xlstm-350m"))
    plan = make_cell_plan(cfg, None, ShapeConfig("s", 32, 1, kind))
    whole, _ = count_cell(plan)          # T < LOOP_STEPS: every step runs
    runs = []
    monkeypatch.setattr(counting, "LOOP_STEPS", 8)
    monkeypatch.setattr(counting, "repeated", lambda *a: runs.append(1)
                        or counting._Repeated.apply(*a))
    short, _ = count_cell(plan)          # runs of 16 and 8 steps
    assert runs                          # the shortcut was taken
    assert short == whole


def test_dense_layer_counts_2mkn():
    M, K, N = 48, 64, 80
    x = torch.empty((M, K), device="meta")
    w = torch.empty((N, K), device="meta")
    _, c = count(F.linear, x, w)
    assert c.flops == 2 * M * K * N
    assert c.hbm_bytes == 4 * (M * K + K * N + M * N)
    # Batched: [B, M, K] @ [K, N] counts B times as much.
    _, c = count(torch.matmul, torch.empty((3, M, K), device="meta"),
                 torch.empty((K, N), device="meta"))
    assert c.flops == 3 * 2 * M * K * N


def test_plain_calls_count_their_kernels_formula():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 24, 16), generator=g)
    k = torch.randn((2, 2, 24, 16), generator=g)
    v = torch.randn((2, 2, 24, 16), generator=g)
    _, c = count(kfa.flash_attention_cuda, q, k, v, window=8)
    assert (c.flops, c.hbm_bytes) == work.flash_work(2, 4, 2, 24, 24, 16,
                                                     True, 4, 8)
    assert dict(c.kernels) == {"flash_attention": 1}
    assert len(c.by_op) == 1      # no operation of the plain version
    length = torch.tensor([10], dtype=torch.int32)
    _, c = count(kfa.decode_attention_cuda, q[:, :, :1], k, v, length)
    assert (c.flops, c.hbm_bytes) == work.decode_work(2, 4, 2, 24, 16, 4)
    a = torch.rand((2, 40, 8), generator=g)
    _, c = count(kss.ssm_scan_cuda, a, torch.randn_like(a))
    assert (c.flops, c.hbm_bytes) == work.ssm_scan_work(a.numel(), 4)
    nx, P = 3, 10
    m = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)  # noqa
    fe = FilteringElement(m(P, nx, nx), m(P, nx), m(P, nx, nx), m(P, nx),
                          m(P, nx, nx))
    _, c = count(kc.filtering_combine_cuda, fe, fe)
    assert (c.flops, c.hbm_bytes) == work.combine_work(
        "filtering_combine", P, nx, 8)
    se = SmoothingElement(m(P, nx, nx), m(P, nx), m(P, nx, nx))
    _, c = count(kc.smoothing_combine_cuda, se, se)
    assert (c.flops, c.hbm_bytes) == work.combine_work(
        "smoothing_combine", P, nx, 8)


def test_formulas_are_chip_smokes_bounds():
    # The bounds chip_smoke.py printed before they moved into the
    # package, at two of its shapes (bf16 qwen2 decode and prefill).
    ms, by = roofline.bound_ms(*reversed(work.decode_work(
        64, 12, 2, 512, 128, 2)), "bfloat16")
    n_bytes = 2 * (2 * 64 * 2 * 512 * 128 + 2 * 64 * 12 * 128)
    assert (ms, by) == (n_bytes / 3.35e12 * 1e3, "bytes")
    flops, nbytes = work.flash_work(8, 12, 2, 128, 128, 128, True, 2)
    assert flops == 4 * 8 * 12 * 128 * (128 * 129 // 2)
    assert nbytes == 2 * (2 * 8 * 12 * 128 * 128 + 2 * 8 * 2 * 128 * 128)


CELLS = [(a, s) for a in sorted(list_configs()) for s in ALL_SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[
    f"{a}-{s.name}" for a, s in CELLS])
def test_model_flops_equal_jax(arch, shape):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.launch.roofline import model_flops as jmodel_flops

    assert roofline.model_flops(get_config(arch), shape) == jmodel_flops(
        jget_config(arch), JSHAPES[shape.name])


def test_roofline_uses_the_h100_peaks():
    cfg = get_config("qwen2-1.5b")
    shape = ShapeConfig("train_4k", 4096, 256, "train")
    cell = {"chips": 1, "flops": 989e12, "hbm_bytes": 3.35e12,
            "collective_bytes": {"total": 450e9}}
    rl = roofline.roofline_report(cfg, shape, cell)
    assert rl["compute_s"] == rl["memory_s"] == rl["collective_s"] == 1.0
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert roofline.roofline_report(f32, shape, cell)["compute_s"] == \
        pytest.approx(989 / 67)


def test_count_beside_jax_analyze_hlo(record_property):
    """The reduced one-device qwen2-1.5b train and decode steps (B = 2,
    T = 64; caches of 128), counted by the port and by JAX's
    ``analyze_hlo`` of its compiled step."""
    import jax
    import jax.numpy as jnp

    from repro import models as jm
    from repro.configs import get_config as jget_config
    from repro.configs import reduced_config as jreduced
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.optim import AdamWConfig, adamw_update, init_adamw

    jcfg = jreduced(jget_config("qwen2-1.5b"))
    params, _ = jm.init_model(jcfg, jax.random.PRNGKey(0))

    def step(p, opt, batch):
        (_, _), g = jax.value_and_grad(
            lambda q: jm.train_loss(q, jcfg, batch), has_aux=True)(p)
        return adamw_update(AdamWConfig(), p, g, opt, 1.0)

    toks = jnp.zeros((B, T), jnp.int32)
    jtrain = analyze_hlo(jax.jit(step).lower(
        params, init_adamw(params), {"tokens": toks, "labels": toks})
        .compile().as_text())
    jdecode = analyze_hlo(jax.jit(
        lambda p, c, t, pos: jm.decode_step(p, jcfg, c, t, pos)).lower(
        params, jm.init_caches(jcfg, B, S), jnp.zeros((B, 1), jnp.int32),
        jnp.int32(0)).compile().as_text())
    for kind, ref in (("train", jtrain), ("decode", jdecode)):
        plan = _plan("qwen2-1.5b", kind)
        got, _ = count_cell(plan)
        mf = roofline.model_flops(plan.cfg, plan.shape)
        record_property(f"{kind}_flops", (got["flops"], ref["flops"]))
        record_property(f"{kind}_hbm_bytes",
                        (got["hbm_bytes"], ref["hbm_bytes"]))
        # Useful work is part of either count.
        assert got["flops"] >= mf and ref["flops"] >= mf
        assert np.isfinite(got["hbm_bytes"]) and got["hbm_bytes"] > 0
