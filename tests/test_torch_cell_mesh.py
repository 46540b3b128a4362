"""Port parity on a mesh of gloo ranks on the CPU: the MoE's global
dispatch in training (one step of reduced deepseek-moe-16b at its
production capacity factor, 1.25, on a batch of few distinct tokens so
that routing drops) on a data-only 2 x 1 mesh and on 2 x 2 at an odd T
(the experts split over "model", but T does not, so the layers take the
global dispatch), and the prefill and decode cell plans of four archs
on 2 x 2 (the MoE's decode batch one that "data" does not divide, so
that every rank routes the whole batch, with drops).

Oracles: the JAX package's sharded train step on Auto-axis host meshes
of the same shapes (a subprocess with 8 host devices, as
`test_torch_mesh_train.py` runs it; its capacity and aux loss span the
global batch), the port's one-device step (drops and aux), and JAX's
one-device ``prefill`` and ``decode_step`` on the same weights.
Tolerance: the suite's float32 TOL (``rtol=2e-4, atol=2e-5``).

The data-only mesh once routed each rank's rows alone (ROADMAP C8): the
capacity of the local token count and the aux loss of local means, so
each rank's loss, aux and the gradient norm differed from the global
batch's."""
import concurrent.futures
import dataclasses
import functools
import os

import numpy as np
import pytest

import _cell_mesh_cases as cases
from _subproc import run_snippet
from repro_torch import convert
from repro_torch.launch.mesh import run_ranks
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
#: The MoE batches' token ids are drawn from this few, so that routing
#: crowds a few experts past the capacity of factor 1.25.
MOE_IDS = 6

_JAX_STEPS = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.launch import sharding as shard_lib
from repro.launch.steps import TrainState, make_train_step
from repro.launch.train import plan_opt_specs
from repro.optim import AdamWConfig, init_adamw
from repro.runtime.elastic import reshard_state
from jax.sharding import AxisType

inp = dict(np.load("%(inputs)s"))
out = {}
for key, (shape, T, tp) in %(steps)s.items():
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]],
                         axis_types=(AxisType.Auto,) * 2)
    cfg = dataclasses.replace(reduced_config(get_config("deepseek-moe-16b")),
                              tp_size=tp, capacity_factor=%(cf)r)
    plan = make_train_step(cfg, mesh, ShapeConfig("t", T, %(B)d, "train"),
                           opt_cfg=AdamWConfig(lr=%(LR)r),
                           total_steps=%(TOTAL)d, warmup_steps=0,
                           sequence_parallel=False)
    with mesh:
        shapes, specs = shard_lib._specs_only(cfg)
        treedef = jax.tree_util.tree_structure(shapes)
        params = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(inp[f"params/{key}/{i}"])
            for i in range(treedef.num_leaves)])
        state = TrainState(params=params, opt=init_adamw(params))
        state = reshard_state(state, mesh, TrainState(
            params=shard_lib.adapt_specs_for_mesh(specs, mesh),
            opt=plan_opt_specs(cfg, mesh, specs, params)))
        toks = jnp.asarray(inp[f"tokens/{key}"], jnp.int32)
        state, m = plan.step_fn(state, {"tokens": toks, "labels": toks})
        for k in ("loss", "ce", "aux", "grad_norm"):
            out[f"{key}/{k}"] = np.asarray(m[k])
    for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
        out[f"{key}/params/{i}"] = np.asarray(leaf)
np.savez("%(outputs)s", **out)
print("CELL_MESH_ORACLES_OK")
"""

CHEAP_XLA = "--xla_backend_optimization_level=0 " \
    "--xla_llvm_disable_expensive_passes=true " \
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"


@functools.lru_cache(maxsize=None)
def jx():
    import types

    import jax

    from repro import models
    from repro.configs import get_config, reduced_config
    return types.SimpleNamespace(jax=jax, models=models,
                                 get_config=get_config,
                                 reduced_config=reduced_config)


def _jcfg(arch, tp, capacity_factor=None):
    j = jx()
    cfg = dataclasses.replace(j.reduced_config(j.get_config(arch)),
                              tp_size=tp)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


@functools.lru_cache(maxsize=None)
def _jparams(arch, tp, seed):
    """Random parameters in the pytree of the reference's ``init_model``
    (its shapes by ``eval_shape``): norms ``1 + 0.1 z``, every other leaf
    ``0.02 z``, float32 numpy."""
    j = jx()
    shapes = j.jax.eval_shape(lambda: j.models.init_model(
        _jcfg(arch, tp), j.jax.random.PRNGKey(0))[0])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        keys = j.jax.tree_util.keystr(path)
        norm = "norm" in keys or "'ln" in keys
        return np.float32(1.0) + np.float32(0.1) * z if norm \
            else np.float32(0.02) * z

    return j.jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(26)
    inp = {"moe_params": {}, "moe_tokens": {}, "serve_params": {},
           "serve_tokens": {}}
    for key, (_, T, tp) in cases.MOE_STEPS.items():
        inp["moe_params"][key] = _jparams("deepseek-moe-16b", tp, 1)
        inp["moe_tokens"][key] = rng.integers(0, MOE_IDS, (cases.B, T))
    for i, (arch, tp) in enumerate(cases.SERVE_ARCHS.items()):
        inp["serve_params"][arch] = _jparams(arch, tp, 2 + i)
        moe = arch == "deepseek-moe-16b"
        inp["serve_tokens"][arch] = {
            "prefill": rng.integers(0, 512, (cases.B, cases.PREFILL_T)),
            "decode": rng.integers(0, MOE_IDS if moe else 512, (
                cases.MOE_DECODE_B if moe else cases.B,
                cases.DECODE_STEPS))}
    return inp


def _jax_steps(tmp) -> dict:
    inp = _inputs()
    flat = {}
    for key in cases.MOE_STEPS:
        flat[f"tokens/{key}"] = inp["moe_tokens"][key]
        leaves = jx().jax.tree_util.tree_leaves(inp["moe_params"][key])
        flat.update({f"params/{key}/{i}": x for i, x in enumerate(leaves)})
    path, outputs = (os.path.join(tmp, f) for f in ("in.npz", "out.npz"))
    np.savez(path, **flat)
    proc = run_snippet(_JAX_STEPS % dict(
        inputs=path, outputs=outputs, steps=repr(cases.MOE_STEPS),
        cf=cases.MOE_CF, B=cases.B, LR=cases.LR, TOTAL=cases.TOTAL),
        n_devices=8, timeout=600, extra_env={"XLA_FLAGS": (
            "--xla_force_host_platform_device_count=8 " + CHEAP_XLA)})
    assert proc.returncode == 0 and "CELL_MESH_ORACLES_OK" in proc.stdout, (
        f"JAX oracle subprocess failed (rc={proc.returncode})\n"
        f"{proc.stdout}\n{proc.stderr}")
    return dict(np.load(outputs))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(2 x 1 ranks' results, 2 x 2 ranks' results, JAX's steps), all
    three run at once."""
    tmp = str(tmp_path_factory.mktemp("cell_mesh"))
    inp = _inputs()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        oracle = pool.submit(_jax_steps, tmp)
        r21 = pool.submit(run_ranks, cases.moe_2x1, 2, inp, device="cpu",
                          emit=None)
        r22 = pool.submit(run_ranks, cases.cells_2x2, 4, inp, device="cpu",
                          emit=None)
        return r21.result(), r22.result(), oracle.result()


def _moe_results(sessions, key):
    r21, r22, oracle = sessions
    ranks = [r for r in r21] if key == "2x1" else [r["moe"] for r in r22]
    return ranks, oracle


def _jax_params_by_name(oracle, key):
    _, T, tp = cases.MOE_STEPS[key]
    cfg = cases.cfg_of("deepseek-moe-16b", tp, cases.MOE_CF)
    tree = _jparams("deepseek-moe-16b", tp, 1)
    treedef = jx().jax.tree_util.tree_structure(tree)
    leaves = [oracle[f"{key}/params/{i}"]
              for i in range(treedef.num_leaves)]
    names = convert.lm_params(tree, cfg, device="cpu").state_dict().keys()
    return convert.lm_tree(jx().jax.tree_util.tree_unflatten(
        treedef, leaves), names)


@pytest.mark.parametrize("key", list(cases.MOE_STEPS))
def test_moe_global_dispatch_step_matches_jax_sharded_step(sessions, key):
    ranks, oracle = _moe_results(sessions, key)
    for r in ranks:
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(r["mesh"][k], oracle[f"{key}/{k}"],
                                       err_msg=f"{key} {k}", **TOL)
    want = _jax_params_by_name(oracle, key)
    got = ranks[0]["mesh"]["params"]
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


@pytest.mark.parametrize("key", list(cases.MOE_STEPS))
def test_moe_global_dispatch_drops_and_aux_equal_one_device(sessions, key):
    ranks, _ = _moe_results(sessions, key)
    one = ranks[0]["one"]
    assert one["drops"] > 0     # the batch does drop assignments
    # Each data rank drops its share of the global batch's drops: summed
    # over one "model" line's data ranks they are the one device's.
    tp = cases.MOE_STEPS[key][0][1]
    assert sum(r["mesh"]["drops"] for r in ranks[::tp]) == one["drops"]
    for r in ranks:
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(r["mesh"][k], one[k], **TOL)
    for n, p in one["params"].items():
        np.testing.assert_allclose(ranks[0]["mesh"]["params"][n], p,
                                   err_msg=n, **TOL)


def _whole_rows(r22, arch, part):
    """The rows of the batch from the ranks at "model" 0, by "data"; a
    batch that "data" does not divide is every rank's whole."""
    rows = {r["coords"]["data"]: r["serve"][arch]["mesh"][part]
            for r in r22 if r["coords"]["model"] == 0}
    if len(_inputs()["serve_tokens"][arch][part]) % len(rows):
        for d in rows:
            np.testing.assert_array_equal(rows[d], rows[0])
        return rows[0]
    axis = 1 if part == "decode" else 0
    return np.concatenate([rows[d] for d in sorted(rows)], axis=axis)


@functools.lru_cache(maxsize=None)
def _jax_serve(arch):
    """JAX's one-device prefill logits and teacher-forced decode logits."""
    j = jx()
    import jax.numpy as jnp

    pcfg, dcfg = (_jcfg(arch, cases.SERVE_ARCHS[arch],
                        cases.serve_cfg(arch, part).capacity_factor)
                  for part in ("prefill", "decode"))
    params = j.jax.tree_util.tree_map(jnp.asarray,
                                      _inputs()["serve_params"][arch])
    toks = _inputs()["serve_tokens"][arch]
    prefill = j.jax.jit(lambda p, t: j.models.prefill(p, pcfg, t))
    step = j.jax.jit(lambda p, c, t, i: j.models.decode_step(p, dcfg, c, t,
                                                             i))
    pre = np.asarray(prefill(params, jnp.asarray(toks["prefill"], jnp.int32)))
    caches = j.models.init_caches(dcfg, len(toks["decode"]), cases.DECODE_S)
    dec = []
    for i in range(cases.DECODE_STEPS):
        lg, caches = step(params, caches, jnp.asarray(
            toks["decode"][:, i:i + 1], jnp.int32), jnp.int32(i))
        dec.append(np.asarray(lg))
    return pre, np.stack(dec)


@pytest.mark.parametrize("arch", list(cases.SERVE_ARCHS))
@pytest.mark.parametrize("part", ["prefill", "decode"])
def test_serve_plans_on_2x2_match_one_device_and_jax(sessions, arch, part):
    _, r22, _ = sessions
    got = _whole_rows(r22, arch, part)
    # Every rank of a "model" line returns the same rows.
    for r in r22:
        line = [q for q in r22 if q["coords"]["data"] == r["coords"]["data"]]
        np.testing.assert_array_equal(r["serve"][arch]["mesh"][part],
                                      line[0]["serve"][arch]["mesh"][part])
    one = r22[list(cases.SERVE_ARCHS).index(arch)]["serve"][arch]["one"]
    np.testing.assert_allclose(got, one[part], **TOL)
    if arch == "deepseek-moe-16b" and part == "decode":
        # The decode batch drops assignments, as on one device.
        assert one["decode_drops"] > 0
        for r in r22:
            assert r["serve"][arch]["mesh"]["decode_drops"] == \
                one["decode_drops"]
    want = _jax_serve(arch)[0 if part == "prefill" else 1]
    np.testing.assert_allclose(got, want, **TOL)
