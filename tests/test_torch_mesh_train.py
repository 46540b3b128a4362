"""Port parity: training across a mesh (the sharded train step with
ZeRO-1 AdamW, the collectives' backward passes, the mixers' gradients
under expert and sequence parallelism, int8 compressed all-reduce,
sharded checkpoints and elastic restart), on four gloo ranks on the CPU.

The ranks run `_train_mesh_cases.session` (torch and the port only) once
for the module. The oracle is the JAX package's own sharded code, run by
three subprocesses with 8 host devices (XLA at its cheapest
optimisation, one thread per device), at the same time as the ranks, on
meshes whose axes
are ``AxisType.Auto``: jax 0.9's ``jax.make_mesh`` defaults to Explicit axes,
on which the reference's ``embedding_lookup`` and ``jax.grad`` under
``with mesh:`` raise, while on Auto axes its code runs unchanged. There
the reference's ``make_train_step`` on a 2 x 2 ("data", "model") mesh
takes two steps of reduced qwen2-1.5b, deepseek-moe-16b (at its
production capacity factor, 1.25, on a batch of few distinct tokens, so
that routing drops) and xlstm-350m (its mLSTM layers sequence-parallel),
state placed as its ``train()`` places it; ``jax.grad`` of
``moe_layer`` and ``mlstm_layer`` under ``with mesh:`` takes the
expert- and sequence-parallel paths; ``compressed_psum`` runs under
``shard_map`` over 4 devices; and its ``per_chip_argument_bytes`` on the
16 x 16 production mesh (an ``AbstractMesh``: no compile) gives the
resident bytes the port's plan must count. Tolerances: the suite's
float32 TOL (``rtol=2e-4, atol=2e-5``), float64 TOL for the adjoints;
the specs, the byte counts, the checkpoints and the compression's integer
payload are exact."""
import concurrent.futures
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import _train_mesh_cases as cases
from _subproc import run_snippet
from repro_torch import convert
from repro_torch.configs import get_config, list_configs, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import SyntheticTokenPipeline, TokenPipelineConfig
from repro_torch.distributed import AbstractMesh, P
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import compress, decompress, zero_specs
from repro_torch.runtime.elastic import replan_data
from _torch_jax import release_jax_caches  # noqa: F401

RANKS = 4
TOL = dict(rtol=2e-4, atol=2e-5)
F64_TOL = dict(rtol=1e-9, atol=1e-10)
ARCHS = list(cases.STEP_ARCHS)
#: deepseek's batch: tokens from this few ids, so that routing crowds a
#: few experts past the capacity of factor 1.25.
MOE_IDS = 6
MIXER_B, MOE_T, MLSTM_T = 4, 16, 64
PSUM_SHAPE = (RANKS, 32)
BYTES_ARCHS = ("qwen2-1.5b", "qwen2-vl-72b")

_HEAD = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P
from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.launch import sharding as shard_lib
from repro.launch.steps import TrainState, make_train_step
from repro.launch.train import plan_opt_specs
from repro.models.moe import moe_layer
from repro.models.xlstm import mlstm_layer
from repro.optim import AdamWConfig, compressed_psum, init_adamw, \
    init_compression
from repro.runtime.elastic import reshard_state

inp = dict(np.load("%(inputs)s"))
out = {}
auto = lambda n: (AxisType.Auto,) * n
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=auto(2))
leaves = lambda t: jax.tree_util.tree_leaves(t)


def load_params(arch):
    # The test's parameters (numpy, in tree_leaves order) in the
    # reference's pytree, and its specs: no init computed.
    cfg = dataclasses.replace(reduced_config(get_config(arch)), tp_size=2)
    shapes, specs = shard_lib._specs_only(cfg)
    treedef = jax.tree_util.tree_structure(shapes)
    n = treedef.num_leaves
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inp[f"params/{arch}/{i}"]) for i in range(n)]), specs

"""

#: The reference's sharded train steps of the given archs ...
_STEPS = r"""
for arch, T, cf in %(steps)s:
    cfg = dataclasses.replace(reduced_config(get_config(arch)), tp_size=2)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    plan = make_train_step(cfg, mesh, ShapeConfig("loop", T, %(B)d, "train"),
                           opt_cfg=AdamWConfig(lr=%(LR)r),
                           total_steps=%(TOTAL)d, warmup_steps=0,
                           sequence_parallel=False)
    with mesh:
        params, specs = load_params(arch)
        state = TrainState(params=params, opt=init_adamw(params))
        state = reshard_state(state, mesh, TrainState(
            params=shard_lib.adapt_specs_for_mesh(specs, mesh),
            opt=plan_opt_specs(cfg, mesh, specs, params)))
        toks = jnp.asarray(inp[f"tokens/{arch}"], jnp.int32)
        batch = {"tokens": toks, "labels": toks}
        for s in range(2):
            state, m = plan.step_fn(state, batch)
            out[f"{arch}/loss/{s}"] = np.asarray(m["loss"])
            out[f"{arch}/grad_norm/{s}"] = np.asarray(m["grad_norm"])
    for part, tree in (("params", state.params), ("m", state.opt.m),
                       ("v", state.opt.v)):
        for i, leaf in enumerate(leaves(tree)):
            out[f"{arch}/{part}/{i}"] = np.asarray(leaf)
"""

#: ... the mixers' gradients, compression and the byte counts ...
_GRADS = r"""
# The mixers' gradients under the mesh (expert- and sequence-parallel).
def grads(fn, layer, x, ct, with_aux):
    def loss(p, xx):
        y, aux = fn(p, xx)
        return jnp.sum(y * ct) + (0.1 * aux if with_aux else 0.0)
    with mesh:
        return jax.jit(jax.grad(loss, argnums=(0, 1)))(layer, x)
"""

_MOE_GRAD = r"""
cfg = dataclasses.replace(reduced_config(get_config("deepseek-moe-16b")),
                          tp_size=2)
params, _ = load_params("deepseek-moe-16b")
layer = jax.tree_util.tree_map(lambda a: a[0], params["runs"][0]["moe"])
gp, gx = grads(lambda p, x: moe_layer(p, x, cfg), layer,
               jnp.asarray(inp["moe_x"]), jnp.asarray(inp["moe_ct"]), True)
for i, leaf in enumerate(leaves(gp)):
    out[f"moe_grad/{i}"] = np.asarray(leaf)
out["moe_grad/x"] = np.asarray(gx)
"""

_MLSTM_GRAD = r"""
cfg = dataclasses.replace(reduced_config(get_config("xlstm-350m")),
                          tp_size=2)
params, _ = load_params("xlstm-350m")
layer = jax.tree_util.tree_map(lambda a: a[0], params["runs"][0]["mlstm"])
gp, gx = grads(lambda p, x: (mlstm_layer(p, x, cfg)[0], 0.0), layer,
               jnp.asarray(inp["mlstm_x"]), jnp.asarray(inp["mlstm_ct"]),
               False)
for i, leaf in enumerate(leaves(gp)):
    out[f"mlstm_grad/{i}"] = np.asarray(leaf)
out["mlstm_grad/x"] = np.asarray(gx)
"""

_REST = r"""
# compressed_psum over 4 devices.
mesh4 = jax.make_mesh((4,), ("pod",), devices=jax.devices()[:4],
                      axis_types=auto(1))
g = jnp.asarray(inp["psum_g"])
state = init_compression({"g": g[0]})
def reduce_grads(gs):
    new, st = compressed_psum({"g": gs[0]}, state, "pod")
    return new["g"][None], st.residual["g"][None]
got, res = jax.jit(jax.shard_map(
    reduce_grads, mesh=mesh4, in_specs=(P("pod", None),),
    out_specs=(P("pod", None), P("pod", None)), check_vma=False))(g)
out["psum/got"], out["psum/residual"] = np.asarray(got), np.asarray(res)

# Resident bytes per chip on the 16 x 16 production mesh.
prod = AbstractMesh((16, 16), ("data", "model"), axis_types=auto(2))
for arch in %(bytes_archs)s:
    plan = make_train_step(get_config(arch), prod,
                           ShapeConfig("train_4k", 4096, 256, "train"))
    out[f"bytes/{arch}"] = np.asarray(plan.per_chip_argument_bytes())
"""

_TAIL = r"""
np.savez("%(outputs)s", **out)
print("TRAIN_MESH_ORACLES_OK")
"""

#: ... in three subprocesses that run at the same time, none much longer
#: than the ranks: two archs' steps; the third's with its mixer's
#: gradients; the other mixer's gradients with the rest.
ORACLE_JOBS = [
    (_HEAD + _STEPS + _TAIL, ("qwen2-1.5b", "deepseek-moe-16b")),
    (_HEAD + _STEPS + _GRADS + _MLSTM_GRAD + _TAIL, ("xlstm-350m",)),
    (_HEAD + _GRADS + _MOE_GRAD + _REST + _TAIL, ())]


@functools.lru_cache(maxsize=None)
def jx():
    import types

    import jax
    import jax.numpy as jnp

    from repro import configs, models
    from repro.data import tokens as jtokens
    from repro.launch import sharding as jsharding
    from repro.optim import adamw as jadamw
    from repro.optim import compression as jcomp
    from repro.runtime import elastic as jelastic

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 models=models, tokens=jtokens,
                                 sharding=jsharding, adamw=jadamw,
                                 compression=jcomp, elastic=jelastic)


def _jcfg(arch, tp=2):
    j = jx()
    return dataclasses.replace(
        j.configs.reduced_config(j.configs.get_config(arch)), tp_size=tp)


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    """Random parameters in the pytree of the reference's ``init_model``
    (reduced, tp = 2; its shapes by ``eval_shape``, nothing computed):
    the norms ``1 + 0.1 z``, every other leaf ``0.02 z`` (float32, seeded),
    as numpy, and the pytree's structure."""
    j = jx()
    shapes = j.jax.eval_shape(lambda: j.models.init_model(
        _jcfg(arch), j.jax.random.PRNGKey(0))[0])
    rng = np.random.default_rng(sorted(cases.STEP_ARCHS).index(arch))

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        keys = j.jax.tree_util.keystr(path)
        norm = "norm" in keys or "'ln" in keys
        return np.float32(1.0) + np.float32(0.1) * z if norm \
            else np.float32(0.02) * z

    params = j.jax.tree_util.tree_map_with_path(draw, shapes)
    return params, j.jax.tree_util.tree_structure(shapes)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    tokens = {}
    for arch, (T, _) in cases.STEP_ARCHS.items():
        vocab = MOE_IDS if arch == "deepseek-moe-16b" else 512
        tokens[arch] = rng.integers(0, vocab, (cases.B, T))
    d = 64
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    return {"tokens": tokens,
            "moe_x": f32(MIXER_B, MOE_T, d), "moe_ct": f32(MIXER_B, MOE_T, d),
            "mlstm_x": f32(MIXER_B, MLSTM_T, d),
            "mlstm_ct": f32(MIXER_B, MLSTM_T, d),
            "psum_g": (np.arange(np.prod(PSUM_SHAPE), dtype=np.float32)
                       .reshape(PSUM_SHAPE) / 17.0
                       + f32(*PSUM_SHAPE))}


def _jax_inputs(tmp) -> str:
    inp = _inputs()
    flat = {f"tokens/{a}": t for a, t in inp["tokens"].items()}
    for a in ARCHS:
        leaves = jx().jax.tree_util.tree_leaves(_jparams(a)[0])
        flat.update({f"params/{a}/{i}": x for i, x in enumerate(leaves)})
    flat.update({k: inp[k] for k in ("moe_x", "moe_ct", "mlstm_x",
                                     "mlstm_ct", "psum_g")})
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **flat)
    return path


#: XLA's CPU backend at its cheapest optimisation and on one thread per
#: device: the oracles' compile time is most of their cost, no number
#: here needs the fast code, and the suite's other workers need the cores.
CHEAP_XLA = "--xla_backend_optimization_level=0 " \
    "--xla_llvm_disable_expensive_passes=true " \
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"


def _jax_subprocess(snippet, inputs, outputs, archs=()):
    steps = [(a, *cases.STEP_ARCHS[a]) for a in archs]
    proc = run_snippet(snippet % dict(
        inputs=inputs, outputs=outputs, steps=repr(steps), B=cases.B,
        LR=cases.LR, TOTAL=cases.TOTAL, bytes_archs=repr(BYTES_ARCHS)),
        n_devices=8, timeout=600, extra_env={"XLA_FLAGS": (
            "--xla_force_host_platform_device_count=8 " + CHEAP_XLA)})
    assert proc.returncode == 0 and "TRAIN_MESH_ORACLES_OK" in proc.stdout, (
        f"JAX oracle subprocess failed (rc={proc.returncode})\n"
        f"{proc.stdout}\n{proc.stderr}")
    return dict(np.load(outputs))


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """Starts the JAX subprocesses and the ranks with the module's first
    test, so that the tests that need neither run meanwhile; waits for
    them at the module's end."""
    tmp = str(tmp_path_factory.mktemp("train_mesh"))
    inputs = _jax_inputs(tmp)
    ckpt = os.path.join(tmp, "ckpt")
    os.makedirs(ckpt)
    with concurrent.futures.ThreadPoolExecutor(len(ORACLE_JOBS) + 1) as pool:
        oracles = [pool.submit(_jax_subprocess, snippet, inputs,
                               os.path.join(tmp, f"out{i}.npz"), archs)
                   for i, (snippet, archs) in enumerate(ORACLE_JOBS)]
        ranks = pool.submit(run_ranks, cases.session, RANKS,
                            dict(_inputs(), params={
                                a: _jparams(a)[0] for a in ARCHS}),
                            ckpt, device="cpu", emit=None)
        yield oracles, ranks


@pytest.fixture(scope="module")
def sessions(_started):
    """(each rank's results, JAX's sharded outputs)."""
    oracles, ranks = _started
    oracle = {}
    for o in oracles:
        oracle.update(o.result())
    return ranks.result(), oracle


def _port_tree(arch, leaves):
    """JAX leaves (tree_leaves order of the reference's params pytree) by
    the port's parameter names."""
    _, treedef = _jparams(arch)
    tree = jx().jax.tree_util.tree_unflatten(treedef, list(leaves))
    names = convert.lm_params(_jparams(arch)[0], cases.cfg_of(arch),
                              device="cpu").state_dict().keys()
    return convert.lm_tree(tree, names)


def _jax_part(oracle, arch, part):
    n = len([k for k in oracle if k.startswith(f"{arch}/{part}/")])
    return _port_tree(arch, [oracle[f"{arch}/{part}/{i}"] for i in range(n)])


def _close_trees(got, want, tol=TOL, what=""):
    assert set(got) == set(want), what
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=f"{what} {n}",
                                   **tol)


# ---------------------------------------------------------------------------
# Specs and tables (no ranks)
# ---------------------------------------------------------------------------

REGISTERED = sorted(list_configs())


def _jax_specs_tree(cfg):
    j = jx()
    _, specs = j.sharding._specs_only(cfg)
    return specs


def _same_tree(port, ref, path=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _same_tree(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same_tree(a, b, f"{path}/{i}")
    else:
        assert tuple(port) == tuple(ref), (path, port, ref)


@pytest.mark.parametrize("arch,tp", [(a, 1) for a in REGISTERED]
                         + [(a, 2) for a in ARCHS])
def test_param_specs_equal_jax_leaf_for_leaf(arch, tp):
    # Every arch's reduced config (tp 1), and the steps' (tp 2).
    jcfg = _jcfg(arch, tp)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), tp_size=tp)
    ref = _jax_specs_tree(jcfg)
    _same_tree(tsharding.jax_spec_tree(cfg), ref)
    # Each port parameter's spec is its JAX leaf's, the stacked entry
    # dropped and a transposed weight's reversed.
    specs = tsharding.param_specs(cfg)
    shapes = tsharding.param_shapes(cfg)
    assert list(specs) == list(shapes)
    for name, spec in specs.items():
        keys, layer, transposed = convert.jax_leaf(name)
        leaf = ref
        for k in keys:
            leaf = leaf[k]
        entries = list(leaf)[1:] if layer is not None else list(leaf)
        ndim = len(shapes[name][0])
        entries += [None] * (ndim - len(entries))
        if transposed:
            entries = entries[::-1]
        assert tuple(spec) == tuple(entries), (name, spec, leaf)


def test_spec_rules_equal_jax():
    j = jx()
    from jax.sharding import PartitionSpec as JP

    shapes = {"w": (64, 128), "b": (128,), "e": (8, 48, 32)}
    jshapes = {k: j.jax.ShapeDtypeStruct(s, j.jnp.float32)
               for k, s in shapes.items()}
    specs = {"w": P(None, "model"), "b": P("model"),
             "e": P("model", None, None)}
    jspecs = {k: JP(*s) for k, s in specs.items()}
    # mirror of tests/substrates/test_optim.py::test_zero_specs_widen
    out = zero_specs(specs, {"data": 16, "model": 16}, shapes)
    assert out.m["w"] == P("data", "model")
    assert out.m["b"] == P("model")
    assert out.step == P()
    for sizes in ({"data": 16, "model": 16}, {"data": 2, "model": 2},
                  {"data": 3}):
        got = zero_specs(specs, sizes, shapes)
        want = j.adamw.zero_specs(jspecs, sizes, jshapes)
        for k in specs:
            assert tuple(got.m[k]) == tuple(want.m[k]), (k, sizes)
            assert tuple(got.v[k]) == tuple(want.v[k]), (k, sizes)
    for size in (16, 2, 3):
        got = tsharding.fsdp_widen(specs, shapes, data_size=size)
        want = j.sharding.fsdp_widen(jspecs, jshapes, data_size=size)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}, size
    pod = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    jpod = j.jax.sharding.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    nested = {"a": P("data", None), "b": [P(None, "model"),
                                          P(("data", "model"))],
              "c": P(("pod", "data"), None)}
    jnested = {"a": JP("data", None), "b": [JP(None, "model"),
                                            JP(("data", "model"))],
               "c": JP(("pod", "data"), None)}
    got = tsharding.adapt_specs_for_mesh(nested, pod)
    want = j.sharding.adapt_specs_for_mesh(jnested, jpod)
    assert tuple(got["a"]) == tuple(want["a"])
    assert [tuple(s) for s in got["b"]] == [tuple(s) for s in want["b"]]
    assert tuple(got["c"]) == tuple(want["c"])
    flat = AbstractMesh((2, 2), ("data", "model"))
    assert tsharding.adapt_specs_for_mesh(nested, flat) is nested
    cfg = reduced_config(get_config("seamless-m4t-medium"))
    got = tsharding.train_batch_specs(cfg)
    want = j.sharding.train_batch_specs(_jcfg("seamless-m4t-medium", 1))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert tuple(tsharding.residual_spec()) == tuple(
        j.sharding.residual_spec())


def test_plan_opt_specs_are_the_plans_moment_specs():
    # The trainer's rule on the port's per-layer parameters gives the
    # plan's moment specs where no stacked dimension is picked.
    cfg = cases.cfg_of("qwen2-1.5b")
    mesh = AbstractMesh((2, 2), ("data", "model"))
    plan = make_train_step(cfg, mesh, ShapeConfig("t", 64, 4, "train"))
    got = ttrain.plan_opt_specs(cfg, mesh, tsharding.param_specs(cfg),
                                tsharding.meta_model(cfg))
    assert got.m == plan.moment_specs and got.v == plan.moment_specs
    assert got.step == P()


@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_per_chip_argument_bytes_equal_jax_on_16x16(sessions, arch):
    _, oracle = sessions
    plan = make_train_step(get_config(arch),
                           AbstractMesh((16, 16), ("data", "model")),
                           ShapeConfig("train_4k", 4096, 256, "train"))
    assert plan.per_chip_argument_bytes() == int(oracle[f"bytes/{arch}"])
    if not get_config(arch).fsdp_params:
        # No spec shards a stacked layer dimension: the port's per-layer
        # blocks hold exactly the reference's bytes.
        assert plan.resident_bytes() == plan.per_chip_argument_bytes()


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_replan_data_equals_jax(hosts):
    j = jx()
    cfg = TokenPipelineConfig(vocab_size=512, seq_len=16, global_batch=8,
                              seed=3)
    jpipe = j.tokens.SyntheticTokenPipeline(j.tokens.TokenPipelineConfig(
        vocab_size=512, seq_len=16, global_batch=8, seed=3))
    pipe = SyntheticTokenPipeline(cfg)
    for host in range(hosts):
        got = replan_data(pipe, hosts, host).batch_at(5)
        want = j.elastic.replan_data(jpipe, hosts, host).batch_at(5)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def test_compress_and_decompress_equal_jax():
    j = jx()
    rng = np.random.default_rng(4)
    g = rng.standard_normal((8, 33)).astype(np.float32)
    r = (0.01 * rng.standard_normal((8, 33))).astype(np.float32)
    q, scale, new_r = compress(torch.from_numpy(g), torch.from_numpy(r))
    jq, jscale, jr = j.compression.compress(j.jnp.asarray(g),
                                            j.jnp.asarray(r))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
    np.testing.assert_allclose(new_r.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(decompress(q, scale).numpy(), np.asarray(
        j.compression.decompress(jq, jscale)), **TOL)


def test_compression_error_feedback_unbiased():
    # The port's counterpart of tests/substrates/test_optim.py's.
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    r = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(5):
        q, scale, r = compress(g, r)
        total = total + decompress(q, scale)
    np.testing.assert_allclose((total + r).numpy(), (5 * g).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_compressed_psum_equals_jax_shard_map(sessions):
    ranks, oracle = sessions
    g = _inputs()["psum_g"]
    want = g.sum(axis=0)
    for r in range(RANKS):
        got = ranks[r]["compression"]
        np.testing.assert_allclose(got["got"], oracle["psum/got"][r], **TOL)
        np.testing.assert_allclose(got["residual"], oracle["psum/residual"][r],
                                   **TOL)
        # The reference's bound: 2 % of the largest magnitude.
        np.testing.assert_allclose(got["got"], want, atol=0.02 * float(
            np.abs(want).max()))
        np.testing.assert_allclose(got["psum"], want, rtol=1e-6)


# ---------------------------------------------------------------------------
# Collectives' backward passes
# ---------------------------------------------------------------------------

ADJOINTS = ["ppermute", "psum", "psum_all", "pmean", "all_gather",
            "all_gather_tiled", "psum_scatter", "psum_scatter_tiled",
            "all_to_all", "all_to_all_tiled", "pvary"]


@pytest.mark.parametrize("name", ADJOINTS)
def test_collective_backward_is_its_adjoint(sessions, name):
    ranks, _ = sessions
    for r in range(RANKS):
        lhs, rhs = ranks[r]["adjoints"][name]
        np.testing.assert_allclose(lhs, rhs, **F64_TOL)
        np.testing.assert_array_equal(ranks[r]["adjoints"][name],
                                      ranks[0]["adjoints"][name])


# ---------------------------------------------------------------------------
# The sharded step against JAX's sharded step, and the one-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax_sharded_step(sessions, arch):
    ranks, oracle = sessions
    for r in range(RANKS):
        got = ranks[r]["steps"][arch]
        for s in range(cases.STEPS):
            np.testing.assert_allclose(got["loss"][s],
                                       oracle[f"{arch}/loss/{s}"], **TOL)
            np.testing.assert_allclose(got["grad_norm"][s],
                                       oracle[f"{arch}/grad_norm/{s}"],
                                       **TOL)
        assert got["loss"] == ranks[0]["steps"][arch]["loss"]
    whole = ranks[0]["steps"][arch]["whole"]
    for part in ("params", "m", "v"):
        _close_trees(whole[part], _jax_part(oracle, arch, part),
                     what=f"{arch} {part}")
    # The parameters moved (by up to 2 lr, far past TOL's atol), so the
    # comparison is not of the init.
    init = convert.lm_tree(_jparams(arch)[0], whole["params"].keys())
    moved = max(float(np.abs(whole["params"][n] - init[n]).max())
                for n in init)
    assert moved > 20 * TOL["atol"]


def test_moe_step_drops_assignments(sessions):
    ranks, _ = sessions
    drops = [r["steps"]["deepseek-moe-16b"]["drops"] for r in ranks]
    assert sum(drops) > 0, drops


def test_xlstm_step_is_sequence_parallel(sessions):
    ranks, _ = sessions
    cfg = cases.cfg_of("xlstm-350m")
    n_mlstm = cfg.num_layers - len(cfg.slstm_layers)
    for r in ranks:
        # Each step's forward pass: every mLSTM layer, recomputed once
        # more in the backward pass (block remat).
        calls = r["steps"]["xlstm-350m"]["sp_calls"]
        assert calls == cases.STEPS * 2 * n_mlstm, calls


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device_step(sessions, arch):
    ranks, _ = sessions
    res = ranks[0]["steps"][arch]
    mesh = res.get("drop_free", res)
    one = ranks[ARCHS.index(arch)]["steps"][arch]["one_device"]
    np.testing.assert_allclose(mesh["loss"], one["loss"], **TOL)
    np.testing.assert_allclose(mesh["grad_norm"], one["grad_norm"], **TOL)
    for part in ("params", "m", "v"):
        _close_trees(mesh["whole"][part], one["whole"][part],
                     what=f"{arch} {part}")


# ---------------------------------------------------------------------------
# The mixers' gradients under the mesh against jax.grad under `with mesh:`
# ---------------------------------------------------------------------------

def _rows(a, r):
    n = a.shape[0] // 2
    d = r // 2
    return a[d * n:(d + 1) * n]


@pytest.mark.parametrize("mixer", ["moe", "mlstm"])
def test_mixer_gradients_match_jax_grad(sessions, mixer):
    ranks, oracle = sessions
    arch = {"moe": "deepseek-moe-16b", "mlstm": "xlstm-350m"}[mixer]
    n = len([k for k in oracle if k.startswith(f"{mixer}_grad/")
             and k != f"{mixer}_grad/x"])
    # The JAX layer's gradient pytree in the port's layout, through the
    # model's parameter names of layer 0.
    _, treedef = _jparams(arch)
    jparams = _jparams(arch)[0]
    layer_tree = jx().jax.tree_util.tree_map(
        lambda a: a[0], jparams["runs"][0][mixer])
    leaves_def = jx().jax.tree_util.tree_structure(layer_tree)
    gtree = jx().jax.tree_util.tree_unflatten(
        leaves_def, [oracle[f"{mixer}_grad/{i}"] for i in range(n)])
    full = jx().jax.tree_util.tree_map(lambda a: np.asarray(a)[None], gtree)
    wrapped = {"runs": [{mixer: full}]}
    prefix = f"runs.0.0.{mixer}."
    names = [prefix + k for k in ranks[0]["mixers"][mixer]["grads"]]
    want = convert.lm_tree(wrapped, names)
    if mixer == "mlstm":
        assert ranks[0]["mixers"][mixer]["sp_calls"] == 1
    for r in range(RANKS):
        got = ranks[r]["mixers"][mixer]
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want[prefix + k],
                                       err_msg=f"{mixer} {k}", **TOL)
        np.testing.assert_allclose(got["x"], _rows(oracle[
            f"{mixer}_grad/x"], r), **TOL)


# ---------------------------------------------------------------------------
# Checkpoints and elastic restart
# ---------------------------------------------------------------------------

def test_restore_onto_different_mesh_is_bit_exact(sessions):
    # Mirror of tests/substrates/test_checkpoint.py::
    # test_restore_onto_different_mesh.
    ranks, _ = sessions
    full = np.arange(64.0).reshape(8, 8)
    for r in range(RANKS):
        got = ranks[r]["checkpoints"]["reshard"]
        np.testing.assert_array_equal(got["whole"], full)
        np.testing.assert_array_equal(got["saved_block"],
                                      full[2 * r:2 * r + 2])
        d, m = r // 2, r % 2   # P("model", "data") on (data, model)
        np.testing.assert_array_equal(got["block"],
                                      full[4 * m:4 * m + 4,
                                           4 * d:4 * d + 4])


def test_checkpoint_moves_between_mesh_and_one_device(sessions):
    ranks, _ = sessions
    assert ranks[0]["checkpoints"]["to_one_device"] is True
    assert all(r["checkpoints"]["to_mesh"] for r in ranks)


def test_elastic_resume_on_another_mesh_equals_uninterrupted(sessions):
    ranks, _ = sessions
    res = ranks[0]["elastic"]
    straight, resumed = res["straight"], res["resumed"]
    assert straight["last_step"] == 3 and resumed["last_step"] == 3
    assert len(resumed["losses"]) == 1
    np.testing.assert_allclose(resumed["losses"][0], straight["losses"][2],
                               **TOL)
    a, b = res["final"]["straight"], res["final"]["resumed"]
    assert set(a) == set(b) and len(a) > 3
    for f in a:
        np.testing.assert_allclose(b[f], a[f], err_msg=f, **TOL)
    assert any("resumed from step 2" in line for line in res["log"])
    for r in ranks:   # the same dict on every rank, the log on rank 0
        assert r["elastic"]["straight"] == straight
        assert r["elastic"]["resumed"] == resumed
        assert (len(r["elastic"]["log"]) > 0) == (r is ranks[0])


def test_mesh_of_another_size_than_the_ranks_raises(sessions):
    ranks, _ = sessions
    for r in ranks:
        assert "needs 2 ranks" in r["elastic"]["wrong_size"]
    with pytest.raises(ValueError, match="needs 4 ranks"):
        ttrain.train(ttrain.TrainLoopConfig(arch="qwen2-1.5b",
                                            mesh_shape=(4, 1), steps=1,
                                            device="cpu"))
