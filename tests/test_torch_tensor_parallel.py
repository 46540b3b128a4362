"""Port parity: tensor parallelism of the dense family over "model".

On a 2 x 2 ("data", "model") mesh of four gloo ranks on the CPU
(`_tp_cases.session`), the port's train, prefill and decode plans hold
the reference's "model" block of every dense layer and compute on it:
attention heads, the MLP's ``d_ff``, and the padded vocabulary of the
embedding and the head. The oracle is the JAX package's own sharded
steps (``make_train_step``, ``make_prefill_step``, ``make_decode_step``)
on the same weights and numpy inputs, on an Auto-axis host mesh of the
same shape in a subprocess with 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
``JAX_PLATFORMS=cpu``), where GSPMD splits the same layers.

Configs: reduced qwen2-1.5b (GQA, its kv heads split), reduced
codeqwen1.5-7b (MHA, QKV bias, kv split), a reduced dense config with 3
heads padded to 4 and one replicated kv head at tp_size 2, and one with 6
heads padded to 8 on 2 replicated kv heads at tp_size 4 (rank 0's q heads
read kv heads 0, 0, 0, 1), and reduced qwen2-vl-72b (M-RoPE). The two with
replicated kv heads decode against caches split along their sequence over
"model" (32 rows) and against whole caches (8 rows, through the rank's
head map).

Each config: the train step's loss, ce, grad norm and every parameter
after one step, prefill logits and four teacher-forced decode steps'
logits at the suite's float32 TOL (``rtol=2e-4, atol=2e-5``); each
rank's compute model holds exactly its "model" block (its bytes, the
plan's count and the reference's specs agree); the port's per-chip FLOPs
(`launch.cost` on one rank of an ``AbstractMesh``) against JAX's
``analyze_hlo`` of its compiled sharded step, each difference named; and
the decode step's count gathers no cache block. The split-K decode
kernel's plain version takes a head map and returns log-sum-exps, held
against JAX's ``decode_attention`` on the expanded heads."""
import concurrent.futures
import dataclasses
import functools
import math
import os

import numpy as np
import pytest
import torch

import _tp_cases as cases
from _subproc import run_snippet
from repro_torch import convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import AbstractMesh
from repro_torch.kernels.flash_attention import flash_attention as kfa
from repro_torch.kernels.work import attention_pairs
from repro_torch.launch import sharding as tsharding
from repro_torch.launch.cost import Counter, count_cell, meta_inputs
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import attention as tattn
from repro_torch.models.blocks import layer_schedule
from _torch_jax import release_jax_caches  # noqa: F401

RANKS = 4
TOL = dict(rtol=2e-4, atol=2e-5)
F64_TOL = dict(rtol=1e-9, atol=1e-10)
KEYS = list(cases.CASES)
#: The cases that run the train and prefill plans too.
FULL = [k for k in KEYS if k not in cases.DECODE_ONLY]

_JAX = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import models
from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.launch import sharding as shard_lib
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.steps import (TrainState, make_decode_step,
                                make_prefill_step, make_train_step)
from repro.optim import AdamWConfig, init_adamw

inp = dict(np.load("%(inputs)s"))
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(AxisType.Auto,) * 2)
B, T, STEPS = %(B)d, %(T)d, %(default_steps)d


def run(plan, args):
    args = jax.device_put(args, plan.in_shardings)
    compiled = plan.step_fn.lower(*args).compile()
    return compiled, analyze_hlo(compiled.as_text())["flops"], args


for key, (arch, fields) in %(cases)s.items():
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **fields)
    shapes, specs = shard_lib._specs_only(cfg)
    treedef = jax.tree_util.tree_structure(shapes)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inp[f"params/{key}/{i}"])
        for i in range(treedef.num_leaves)])
    toks = jnp.asarray(inp[f"tokens/{key}"], jnp.int32)
    enc = ([jnp.asarray(inp[f"enc_emb/{key}"])] if f"enc_emb/{key}" in inp
           else [])
    mem = ([jnp.asarray(inp[f"memory/{key}"])] if f"memory/{key}" in inp
           else [])
    caps, steps = %(caches)s.get(key, %(default_caches)r), \
        %(steps)r.get(key, STEPS)
    with mesh:
      if key not in %(decode_only)r:
        plan = make_train_step(cfg, mesh, ShapeConfig("t", T, B, "train"),
                               opt_cfg=AdamWConfig(lr=%(LR)r),
                               total_steps=%(TOTAL)d, warmup_steps=0)
        # The step donates its state: a copy of the parameters.
        own = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                     params)
        state = TrainState(params=own, opt=init_adamw(own))
        batch = {"tokens": toks, "labels": toks}
        if enc:
            batch["enc_emb"] = enc[0]
        step, flops, args = run(plan, (state, batch))
        out[f"{key}/train/flops"] = np.asarray(flops)
        new, m = step(*args)
        for k in ("loss", "ce", "grad_norm"):
            out[f"{key}/train/{k}"] = np.asarray(m[k])
        for i, leaf in enumerate(jax.tree_util.tree_leaves(new.params)):
            out[f"{key}/train/params/{i}"] = np.asarray(leaf)

        plan = make_prefill_step(cfg, mesh, ShapeConfig("p", T, B,
                                                        "prefill"))
        step, flops, args = run(plan, (params, toks, *enc))
        out[f"{key}/prefill/flops"] = np.asarray(flops)
        out[f"{key}/prefill"] = np.asarray(step(*args))
      for cap in caps:
            plan = make_decode_step(cfg, mesh, ShapeConfig("d", cap, B,
                                                           "decode"))
            caches = models.init_caches(cfg, B, cap)
            step, flops, args = run(plan, (params, caches, toks[:, :1],
                                           jnp.int32(0), *mem))
            out[f"{key}/decode{cap}/flops"] = np.asarray(flops)
            p, c = args[0], args[1]
            logits = []
            for i in range(steps):
                j = i %% T
                lg, c = step(*jax.device_put(
                    (p, c, toks[:, j:j + 1], jnp.int32(i), *mem),
                    plan.in_shardings))
                logits.append(np.asarray(lg))
            out[f"{key}/decode{cap}"] = np.stack(logits)
np.savez("%(outputs)s", **out)
print("TP_ORACLES_OK")
"""

#: XLA's CPU backend at its cheapest: compile time is most of the
#: oracle's cost, and no number here needs fast code.
CHEAP_XLA = "--xla_backend_optimization_level=0 " \
    "--xla_llvm_disable_expensive_passes=true " \
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"


@functools.lru_cache(maxsize=None)
def jx():
    import types

    import jax

    from repro import models
    from repro.configs import get_config, reduced_config
    from repro.launch import sharding as jsharding
    return types.SimpleNamespace(jax=jax, models=models,
                                 get_config=get_config,
                                 reduced_config=reduced_config,
                                 sharding=jsharding)


def _jcfg(key):
    j = jx()
    arch, fields = cases.CASES[key]
    return dataclasses.replace(j.reduced_config(j.get_config(arch)),
                               **fields)


@functools.lru_cache(maxsize=None)
def _jparams(key):
    """Random parameters in the reference's pytree (its shapes by
    ``eval_shape``): norms ``1 + 0.1 z``, every other leaf ``0.02 z``
    (the padded heads' ``wq`` columns and ``wo`` rows zero, as its
    ``init_model`` leaves them), float32 numpy; and the tree's
    structure."""
    j = jx()
    cfg = _jcfg(key)
    shapes = j.jax.eval_shape(lambda: j.models.init_model(
        cfg, j.jax.random.PRNGKey(0))[0])
    rng = np.random.default_rng(KEYS.index(key))
    real = np.repeat(np.arange(cfg.padded_heads) < cfg.num_heads,
                     cfg.resolved_head_dim).astype(np.float32)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        keys = j.jax.tree_util.keystr(path)
        if "norm" in keys or "'ln" in keys:
            return np.float32(1.0) + np.float32(0.1) * z
        z = np.float32(0.02) * z
        if keys.endswith("['wq']") or keys.endswith("['bq']"):
            z = z * real
        elif keys.endswith("['wo']"):
            z = z * real[:, None]
        return z

    params = j.jax.tree_util.tree_map_with_path(draw, shapes)
    return params, j.jax.tree_util.tree_structure(shapes)


@functools.lru_cache(maxsize=None)
def _inputs():
    """The parameters and tokens of every case; for an encoder-decoder
    also the frontend's embeddings (train and prefill) and a memory
    (decode), float32 normals."""
    rng = np.random.default_rng(27)
    out = {"params": {k: _jparams(k)[0] for k in KEYS},
           "tokens": {k: rng.integers(0, 512, (cases.B, cases.T))
                      for k in KEYS}}
    for k in KEYS:
        cfg = cases.cfg_of(k)
        if cfg.encoder_layers:
            shape = (cases.B, cfg.encoder_seq_len, cfg.d_model)
            for what in ("enc_emb", "memory"):
                out[f"{what}/{k}"] = rng.standard_normal(shape).astype(
                    np.float32)
    return out


def _jax_oracle(tmp) -> dict:
    inp = _inputs()
    flat = {k: v for k, v in inp.items() if "/" in k}
    for k in KEYS:
        flat[f"tokens/{k}"] = inp["tokens"][k]
        leaves = jx().jax.tree_util.tree_leaves(inp["params"][k])
        flat.update({f"params/{k}/{i}": x for i, x in enumerate(leaves)})
    path, outputs = (os.path.join(tmp, f) for f in ("in.npz", "out.npz"))
    np.savez(path, **flat)
    proc = run_snippet(_JAX % dict(
        inputs=path, outputs=outputs, cases=repr(cases.CASES), B=cases.B,
        T=cases.T, default_steps=cases.DECODE_STEPS, steps=cases.STEPS,
        LR=cases.LR, TOTAL=cases.TOTAL, caches=repr(cases.DECODE_ONLY),
        default_caches=cases.CACHES, decode_only=tuple(cases.DECODE_ONLY)),
        n_devices=8, timeout=900, extra_env={"XLA_FLAGS": (
            "--xla_force_host_platform_device_count=8 " + CHEAP_XLA)})
    assert proc.returncode == 0 and "TP_ORACLES_OK" in proc.stdout, (
        f"JAX oracle subprocess failed (rc={proc.returncode})\n"
        f"{proc.stdout}\n{proc.stderr}")
    return dict(np.load(outputs))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(each rank's results, JAX's sharded outputs), both run at once."""
    tmp = str(tmp_path_factory.mktemp("tensor_parallel"))
    inp = _inputs()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        oracle = pool.submit(_jax_oracle, tmp)
        ranks = pool.submit(run_ranks, cases.session, RANKS, inp,
                            device="cpu", emit=None)
        return ranks.result(), oracle.result()


def _port_names(key):
    return convert.lm_params(_jparams(key)[0], cases.cfg_of(key),
                             device="cpu").state_dict().keys()


def _rows(ranks, key, part):
    """The whole batch's rows from the ranks at "model" 0, by "data";
    every rank of a "model" line returns the same rows."""
    for r in ranks:
        line = [q for q in ranks if q["coords"]["data"] ==
                r["coords"]["data"]]
        np.testing.assert_array_equal(r[key]["serve"][part],
                                      line[0][key]["serve"][part])
    rows = {r["coords"]["data"]: r[key]["serve"][part] for r in ranks
            if r["coords"]["model"] == 0}
    axis = 1 if part.startswith("decode") else 0
    return np.concatenate([rows[d] for d in sorted(rows)], axis=axis)


# ---------------------------------------------------------------------------
# The plans against JAX's sharded steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", FULL)
def test_train_step_matches_jax_sharded_step(sessions, key):
    ranks, oracle = sessions
    for r in ranks:
        assert r[key]["train"]["tensor_parallel"]
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(r[key]["train"]["metrics"][k],
                                       oracle[f"{key}/train/{k}"],
                                       err_msg=k, **TOL)
    _, treedef = _jparams(key)
    want = convert.lm_tree(jx().jax.tree_util.tree_unflatten(treedef, [
        oracle[f"{key}/train/params/{i}"]
        for i in range(treedef.num_leaves)]), _port_names(key))
    got = ranks[0][key]["train"]["params"]
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


@pytest.mark.parametrize("key", FULL)
def test_prefill_matches_jax_sharded_step(sessions, key):
    ranks, oracle = sessions
    assert all(r[key]["serve"]["lm_params_tp"] == "model" for r in ranks)
    np.testing.assert_allclose(_rows(ranks, key, "prefill"),
                               oracle[f"{key}/prefill"], **TOL)


@pytest.mark.parametrize("key,cap", [(k, c) for k in KEYS
                                     for c in cases.caches_of(k)])
def test_decode_matches_jax_sharded_step(sessions, key, cap):
    ranks, oracle = sessions
    got = _rows(ranks, key, f"decode{cap}")
    np.testing.assert_allclose(got, oracle[f"{key}/decode{cap}"], **TOL)
    cfg = cases.cfg_of(key)
    split = not cfg.shard_kv_heads and cap >= 16
    # Each run's caches: ``cap`` rows, or a windowed ring of min(cap,
    # window), which splits only where it has the plan's rows.
    rows = [min(cap, run.window or cap) for run in layer_schedule(cfg)]
    want = [n // 2 if split and n == cap else n for n in rows]
    for r in ranks:
        s = r[key]["serve"]
        # The rank's cache blocks: its block of the sequence where the
        # reference splits it over "model", else every row.
        assert s[f"cache_rows{cap}"] == want
        np.testing.assert_array_equal(s[f"lengths{cap}"],
                                      cases.steps_of(key))


# ---------------------------------------------------------------------------
# What a rank holds, what it counts
# ---------------------------------------------------------------------------

def _model_block_bytes(key) -> int:
    """The reference's "model" block of every parameter at "model" = 2,
    from its own specs: each dimension its spec splits over "model"
    halved (the batch axes ignored)."""
    j = jx()
    cfg = _jcfg(key)
    shapes, specs = j.sharding._specs_only(cfg)
    total = 0
    for leaf, spec in zip(j.jax.tree_util.tree_leaves(shapes),
                          j.jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(
                                  x, j.jax.sharding.PartitionSpec))):
        dims = [d // 2 if "model" in ((e,) if isinstance(e, str) else
                                      (e or ())) else d
                for d, e in zip(leaf.shape, tuple(spec) + (None,) * (
                    len(leaf.shape) - len(spec)))]
        total += math.prod(dims) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("key", FULL)
def test_compute_model_holds_the_model_block(sessions, key):
    ranks, _ = sessions
    want = _model_block_bytes(key)
    whole = sum(p.numel() * p.element_size() for p in convert.lm_params(
        _jparams(key)[0], cases.cfg_of(key), device="cpu").parameters())
    assert want < whole
    for r in ranks:
        t = r[key]["train"]
        assert t["compute_bytes"] == t["plan_compute_bytes"] == want


def _whole_in_proj(key) -> dict:
    """Each layer's SSM ``in_proj`` of the case's JAX parameters in the
    port's layout ``[2 d_inner, d]`` (rows ``[x ; z]``), by port name."""
    names = [n for n in _port_names(key) if n.endswith("ssm.in_proj.weight")]
    return {n: w for n, w in convert.lm_tree(
        _jparams(key)[0], names).items()}


def test_in_proj_computes_on_its_block_of_each_half(sessions):
    """Reduced hymba at "model" 2: each rank's compute model holds the
    rows ``[x_r ; z_r]`` of every ``in_proj``, both as the train plan
    cuts it and as `convert.lm_params(mesh=)` does, while the rank's
    resting block (the reference's spec, one contiguous block) is all of
    ``x`` at "model" 0 and all of ``z`` at "model" 1."""
    ranks, _ = sessions
    whole = _whole_in_proj("hybrid")
    assert len(whole) == cases.cfg_of("hybrid").num_layers
    for r in ranks:
        m = r["coords"]["model"]
        train = r["hybrid"]["train"]
        for part in (train, r["hybrid"]["serve"]):
            assert set(part["in_proj"]) == set(whole)
            for n, w in whole.items():
                din, c = w.shape[0] // 2, w.shape[0] // 4
                np.testing.assert_array_equal(part["in_proj"][n],
                                              np.concatenate(
                    [w[m * c:(m + 1) * c], w[din + m * c:din + (m + 1) * c]]))
                np.testing.assert_array_equal(
                    train["in_proj_rest"][n], w[:din] if m == 0 else w[din:])


@pytest.mark.parametrize("size", [2, 4])
def test_in_proj_layouts_exchange_rows(size):
    """The compute block of a `split_halves` weight is the rank's block of
    each half, its resting block the reference's contiguous block (the
    spec `param_specs` gives it), and the two exchange rows alone: the
    row sets of the ranks' blocks partition the weight both ways."""
    import types

    cfg = cases.cfg_of("hybrid")
    spec = tsharding.param_specs(cfg)["runs.0.0.ssm.in_proj.weight"]
    assert tsharding.split_halves("runs.0.0.ssm.in_proj.weight")
    assert tuple(spec) == ("model", None)
    full = torch.arange(2 * 8 * 3).reshape(16, 3)
    rows, rest = [], []
    for r in range(size):
        mesh = types.SimpleNamespace(shape={"model": size},
                                     coords={"model": r})
        got = tsharding.halves_block(full, mesh)
        c = 8 // size
        want = torch.cat([full[r * c:(r + 1) * c],
                          full[8 + r * c:8 + (r + 1) * c]])
        assert torch.equal(got, want)
        rows += (got[:, 0] // 3).tolist()
        rest += list(tsharding._rest_rows(16, size, r))
    assert sorted(rows) == sorted(rest) == list(range(16))


def _plan(key, kind, cap=None):
    cfg = cases.cfg_of(key)
    mesh = AbstractMesh(cases.SHAPE, ("data", "model"))
    if kind == "train":
        return make_train_step(cfg, mesh, ShapeConfig(
            "t", cases.T, cases.B, "train"))
    if kind == "prefill":
        return make_prefill_step(cfg, mesh, ShapeConfig(
            "p", cases.T, cases.B, "prefill"))
    return make_decode_step(cfg, mesh, ShapeConfig("d", cap, cases.B,
                                                   "decode"))


def _flop_differences(key, kind, cap=None) -> list:
    """The dots whose count differs between rank 0 of the port's step and
    a chip of XLA's sharded step, as ``(what, port minus XLA FLOPs)``;
    every other dot counts alike. At these sizes one attention block
    spans the sequence (``attn_chunk`` 64 > T)."""
    cfg = cases.cfg_of(key)
    tp, L, d, dh = cases.SHAPE[1], cfg.num_layers, cfg.d_model, \
        cfg.resolved_head_dim
    Bl, T, H = cases.B // cases.SHAPE[0], cases.T, cfg.num_heads
    runs = layer_schedule(cfg)
    # Rank 0's real q heads: its block of the padded heads.
    real0 = min(H, cfg.padded_heads // tp)
    out = []
    if kind == "prefill":
        out.append((
            "prefill attention: XLA multiplies every (query, key) pair of "
            "the diagonal block, the port's kernel formula (the kernel's "
            "work, `kernels.work.flash_work`) counts the causal ones, in "
            "the window where the layer has one",
            -4 * dh * Bl * real0 * sum(
                run.count * (T * T - attention_pairs(T, T, True, run.window))
                for run in runs)))
    if kind in ("train", "prefill") and not cfg.shard_kv_heads:
        # Forward; in training also the block's recomputation and the
        # backward pass's two products.
        passes = 4 if kind == "train" else 1
        kv = 2 * (2 * Bl * T * d * cfg.num_kv_heads * dh)
        out.append((
            "the replicated wk and wv: the port projects the whole "
            "sequence on every rank of \"model\", GSPMD the rank's block "
            "of the sequence-parallel stream, then gathers k and v",
            passes * kv * L * (tp - 1) // tp))
    if kind == "decode":
        # A layer's cache is whole on every rank where the kv heads split,
        # where it is short, or where it is a ring shorter than the plan's.
        whole = sum(run.count * min(cap, run.window or cap) for run in runs
                    if cfg.shard_kv_heads or cap < 16
                    or min(cap, run.window or cap) != cap)
        if whole:
            out.append((
                "decode attention on a cache whole on every rank: rank 0 "
                "runs the real heads of its block of the padded heads "
                f"({real0}), GSPMD splits the {H} real heads evenly "
                f"({-(-H // tp)} a chip)",
                4 * Bl * dh * whole * (real0 - -(-H // tp))))
    if cfg.family == "hybrid" and kind in ("train", "prefill"):
        n_el = Bl * T * cfg.ssm_expand * d // tp * cfg.ssm_state
        out.append((
            "prefill: the port counts ssm_scan by the kernel's formula (2 "
            "operations a value, `kernels.work.ssm_scan_work`), XLA's "
            "associative scan has no dot" if kind == "prefill" else
            "the gradient of the SSM's h from y = einsum(h, C): the port's "
            "is an outer product as a batched matmul, XLA's an elementwise "
            "multiply", 2 * n_el * L))
    if cfg.encoder_layers and kind == "train":
        S, hq, hkv = (cfg.encoder_seq_len, cfg.padded_heads // tp,
                      cfg.num_kv_heads // tp)
        proj = 2 * Bl * d * dh
        layer = (proj * T * (2 * hq + 2 * hkv)            # wq, wk, wv, wo
                 + 4 * Bl * hq * T * T * dh               # QK^T and PV
                 + 3 * 2 * Bl * T * d * cfg.d_ff // tp    # the MLP
                 + proj * (T * hq + 2 * S * hkv)          # cross wq, wk, wv
                 + 4 * Bl * hq * T * S * dh)              # cross QK^T, PV
        out.append((
            "the decoder's recomputation: the port's block remat recomputes "
            "each decoder layer with its cross-attention in the backward "
            "pass, up to the cross wo (torch's non-reentrant checkpoint "
            "stops at the last saved input); the reference's cross path "
            "applies the decoder blocks without its jax.checkpoint",
            layer * L))
    return out


@pytest.mark.parametrize("key,kind,cap", [
    (k, kind, cap) for k in KEYS for kind, cap in
    ([("train", None), ("prefill", None)] if k in FULL else [])
    + [("decode", c) for c in cases.caches_of(k)]])
def test_flops_equal_jax_analyze_hlo(sessions, key, kind, cap,
                                     record_property):
    _, oracle = sessions
    got, _ = count_cell(_plan(key, kind, cap))
    name = f"{key}/{kind}{cap or ''}/flops"
    want = float(oracle[name])
    record_property("flops", (got["flops"], want))
    diff = sum(d for _, d in _flop_differences(key, kind, cap))
    assert got["flops"] == want + diff, (got["flops"], want)


class _Collectives(Counter):
    """A step count that also keeps each collective's kind and bytes."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def collective(self, kind, out_bytes, in_bytes):
        self.calls.append((kind, out_bytes))
        super().collective(kind, out_bytes, in_bytes)


def _collectives(plan) -> list:
    args, kwargs = meta_inputs(plan)
    counter = _Collectives()
    with counter:
        plan.step_fn(*args, **kwargs)
    return counter.calls


@pytest.mark.parametrize("key", KEYS)
def test_decode_moves_no_cache_block(key):
    """One rank's decode step (traced on ``meta``) runs the same
    collectives, of the same bytes, whatever the caches' capacity: none
    carries a cache block (the q rows, the ranks' partial rows, the
    partial sums of the row products and the logits are all it moves).
    Both capacities of each pair lay out their caches alike: split along
    the sequence over "model" (32, 64 rows; hybrid_w32's rings split at
    16 and 32 rows, not at 64) where the kv heads are replicated, or
    whole (8, 12)."""
    pairs = ((16, 32), (8, 12)) if key == "hybrid_w32" else ((32, 64),
                                                             (8, 12))
    for caps in pairs:
        a, b = (_collectives(_plan(key, "decode", c)) for c in caps)
        assert a and a == b, caps
        assert _plan(key, "decode", caps[0]).tensor_parallel


def test_region_functions_are_their_adjoints(sessions):
    ranks, _ = sessions
    for name, pair in ranks[0]["adjoints"].items():
        np.testing.assert_allclose(pair[0], pair[1], err_msg=name,
                                   **F64_TOL)


# ---------------------------------------------------------------------------
# The decode kernel's plain version under a head map
# ---------------------------------------------------------------------------

def _decode_inputs(Hq, Hkv, S, n, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, Hq, 1, 16)).astype(np.float32)
    k = rng.standard_normal((2, Hkv, S, 16)).astype(np.float32)
    v = rng.standard_normal((2, Hkv, S, 16)).astype(np.float32)
    return q, k, v, np.int32(n)


@pytest.mark.parametrize("hmap", [(0, 0, 0, 1), (1, 1, 1, 1),
                                  (0, 1, 1, 0, 1, 1)])
def test_mapped_decode_plain_matches_jax_on_expanded_heads(hmap):
    """q head ``i`` against kv head ``hmap[i]`` of the cache, in place,
    against the reference's ``decode_attention`` of the same q heads on
    kv heads expanded by the map (one kv head per q head)."""
    from repro.models import attention as jattn
    import jax.numpy as jnp

    q, k, v, n = _decode_inputs(len(hmap), 2, 24, 19)
    got = kfa.decode_attention_cuda(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.tensor(n), head_map=hmap)          # CPU: the plain version
    idx = np.asarray(hmap)
    want = jattn.decode_attention(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jattn.KVCache(jnp.asarray(k[:, idx]), jnp.asarray(v[:, idx]),
                      jnp.int32(n)))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        want).transpose(0, 2, 1, 3), **TOL)


def test_decode_lse_merges_a_cache_split_along_its_sequence():
    """The rows of two halves of a cache, each with its log-sum-exps,
    merge into the rows of the whole cache (`attention._merge_over`'s
    rule), a half without keys weighing 0."""
    q, k, v, _ = _decode_inputs(4, 2, 32, 0)
    q, k, v = map(torch.as_tensor, (q, k, v))
    for n in (9, 16, 23):
        whole = kfa.decode_attention_plain(q, k, v, torch.tensor(n))
        parts = [kfa.decode_attention_plain(
            q, k[:, :, h * 16:(h + 1) * 16], v[:, :, h * 16:(h + 1) * 16],
            torch.tensor(min(max(n - 16 * h, 0), 16)), return_lse=True)
            for h in range(2)]
        os_ = torch.stack([o for o, _ in parts])
        ls = torch.stack([lse for _, lse in parts])
        w = torch.exp(ls - torch.logsumexp(ls, dim=0))
        np.testing.assert_allclose((w[..., None] * os_).sum(0).numpy(),
                                   whole.numpy(), **TOL)
        assert torch.isfinite(ls[0]).all()
        assert torch.isinf(ls[1]).all() == (n <= 16)


def test_rank_heads_restate_the_reference_map():
    """qwen2-1.5b at full width (12 heads padded to 16, 2 replicated kv
    heads) on "model" 2: rank 0's q heads read kv heads 0 (six) and 1
    (two), rank 1's four real heads kv head 1."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-1.5b")
    full = tattn.head_map(cfg)
    assert full == (0,) * 6 + (1,) * 10
    assert full[:8] == (0,) * 6 + (1,) * 2 and full[8:12] == (1,) * 4
    assert not tsharding.kv_heads_split(cfg, AbstractMesh(
        (2, 2), ("data", "model")))
    assert tsharding.tensor_parallel(cfg, AbstractMesh(
        (2, 2), ("data", "model")), "decode")


@pytest.mark.parametrize("shape", [(2, 2), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-medium"])
def test_hybrid_and_encdec_plans_are_tensor_parallel(arch, shape):
    """hymba-1.5b's and seamless-m4t-medium's train, prefill and decode
    plans split over "model" on the 2 x 2 test mesh and both production
    meshes; grok-1-314b's global dispatch and xlstm-350m keep the
    replicated compute model."""
    from repro_torch.configs import get_config

    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    mesh = AbstractMesh(shape, names)
    for kind in ("train", "prefill", "decode"):
        assert tsharding.tensor_parallel(get_config(arch), mesh, kind)
        for other in ("grok-1-314b", "xlstm-350m"):
            assert not tsharding.tensor_parallel(get_config(other), mesh,
                                                 kind)


@pytest.mark.cuda
def test_mapped_decode_kernel_matches_plain_on_card():
    """The split-K kernel with an uneven map and a map into a replicated
    cache, in place, with log-sum-exps, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the decode kernel has no CPU mode")
    dev = "cuda"
    for hmap, Hkv in (((0,) * 6 + (1,) * 2, 2), ((1, 1, 1, 1), 2)):
        q, k, v, n = _decode_inputs(len(hmap), Hkv, 96, 70)
        args = [torch.as_tensor(a).to(dev, torch.bfloat16)
                for a in (q, k, v)]
        length = torch.tensor([n], dtype=torch.int32, device=dev)
        got, lse = kfa.decode_attention_cuda(*args, length, head_map=hmap,
                                             return_lse=True)
        want, wlse = kfa.decode_attention_plain(
            *[a.float() for a in args], length, head_map=hmap,
            return_lse=True)
        np.testing.assert_allclose(got.float().cpu(), want.cpu(),
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(lse.cpu(), wlse.cpu(), rtol=1e-4,
                                   atol=1e-4)
