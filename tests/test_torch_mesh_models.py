"""Port parity on a mesh: the sequence-parallel mLSTM (`xlstm._mlstm_sp`),
the expert-parallel MoE (`moe._moe_layer_ep`), their ``prefill`` under
``with mesh:``, the expert shards of `convert.lm_params(mesh=)`, and the
reference's sharded-driver fault (ROADMAP C7), on four gloo ranks on the
CPU as 1 x 4 and 2 x 2 ("data", "model") meshes.

The ranks run `_mesh_cases.model_session` (torch and the port only) once
for the module. The oracles: JAX in this process on one device (the
unsharded ``mlstm_layer``, ``_mlstm_chunked``, ``_moe_layer_global`` and
``prefill``), and JAX's own ``shard_map`` forward passes from one
subprocess with 8 host devices (`tests/_subproc.run_snippet`):
``_moe_layer_ep`` at the reduced config's capacity factor (2.0, E/k:
drop-free) and at 0.5 (dropping), and ``_mlstm_sp``, each on the same two
meshes (four of the eight devices), and the reference's sharded
``parallel_filter``, ``parallel_smoother`` and ``sqrt_parallel_filter``
on all eight against its unsharded ones. Tolerances: the suite's float32
TOL for the mLSTM (2e-4) and the prefills, 2e-5 for the MoE layer (the
same products in another arrangement), float64 TOL for the drivers. The
mLSTM's carry across ranks is held on gates whose memory outlasts a
slice (``log_sigmoid(6 + z)``): on the model's random gates it vanishes,
and there a dropped state (a planted fault, `_mesh_cases._no_exchange`)
would pass unseen; here it must miss."""
import concurrent.futures
import functools
import os
import types

import numpy as np
import pytest

import _mesh_cases as cases
from _subproc import run_snippet
from repro_torch.launch.mesh import run_ranks
from _torch_jax import release_jax_caches  # noqa: F401

RANKS = 4
TOL = dict(rtol=2e-4, atol=2e-5)
MOE_TOL = dict(rtol=2e-5, atol=2e-5)
F64_TOL = dict(rtol=1e-9, atol=1e-10)
#: Router and experts scaled so that routing is decisive and the experts'
#: outputs O(1) (as in `test_torch_lm_moe.py`).
ROUTER_SCALE, EXPERT_SCALE = 25.0, 5.0
XL_B, XL_T = 2, 128        # T: one 32-step chunk per rank at tp = 4
MOE_B, MOE_T = 2, 16
FAULT_N, FAULT_DEVICES = 64, 8

SNIPPET = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_enable_x64", True)
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro import core as C
from repro.configs import get_config, reduced_config
from repro.models.moe import _moe_layer_ep
from repro.models.xlstm import _mlstm_sp

inp = dict(np.load("%(inputs)s"))
out = {}
devs = np.array(jax.devices())
assert len(devs) == 8, devs
meshes = {"1x4": Mesh(devs[:4].reshape(1, 4), ("data", "model")),
          "2x2": Mesh(devs[:4].reshape(2, 2), ("data", "model"))}

cfg = reduced_config(get_config("deepseek-moe-16b"))
layer = {k: jnp.asarray(inp["moe/" + k]) for k in
         ("router", "w_gate", "w_up", "w_down")}
layer["shared"] = {k: jnp.asarray(inp["moe/shared/" + k])
                   for k in ("w_gate", "w_up", "w_down")}
x = jnp.asarray(inp["moe_x"])
for name, mesh in meshes.items():
    for cf in (2.0, 0.5):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        y, aux = jax.jit(lambda p, xx: _moe_layer_ep(p, xx, c, mesh))(
            layer, x)
        out[f"ep/{name}/{cf}"] = np.asarray(y)
        out[f"ep_aux/{name}/{cf}"] = np.asarray(aux)
    gates = [jnp.asarray(inp[f"gates/{i}"]) for i in range(5)]
    out[f"sp/{name}"] = np.asarray(jax.jit(
        lambda *g: _mlstm_sp(*g, 32, mesh))(*gates))

# The reference's sharded drivers against its unsharded ones (8 shards).
mesh8 = jax.make_mesh((8,), ("sp",))
lin = C.LinearizedSSM(*(jnp.asarray(inp["fault/" + k][0])
                        for k in ("F", "c", "Qp", "H", "d", "Rp")))
ys, m0, P0 = (jnp.asarray(inp["fault/" + k]) for k in ("ys", "m0", "P0"))
ys = ys[0]
sm = lambda f: shard_map(f, mesh=mesh8, in_specs=(P("sp"), P("sp")),
                         out_specs=P("sp"), check_rep=False)
ref_f, ref_s, ref_q = jax.jit(lambda l, y: (
    lambda f: (f, C.parallel_smoother(l, f, m0, P0),
               C.sqrt_parallel_filter(l, y, m0, P0)))(
        C.parallel_filter(l, y, m0, P0)))(lin, ys)
got_f = jax.jit(sm(lambda l, y: C.parallel_filter(
    l, y, m0, P0, axis_name="sp")))(lin, ys)
# The smoother on the right filtered input: its own boundary faults.
got_s = jax.jit(sm(lambda l, f: C.parallel_smoother(
    l, f, m0, P0, axis_name="sp")))(lin, ref_f)
got_q = jax.jit(sm(lambda l, y: C.sqrt_parallel_filter(
    l, y, m0, P0, axis_name="sp")))(lin, ys)
for k, v in (("ref_f", ref_f), ("ref_s", ref_s), ("ref_q", ref_q),
             ("got_f", got_f), ("got_s", got_s), ("got_q", got_q)):
    out[f"fault/{k}/mean"] = np.asarray(v.mean)
    out[f"fault/{k}/cov"] = np.asarray(v.cov)
np.savez("%(outputs)s", **out)
print("MESH_ORACLES_OK")
"""


@functools.lru_cache(maxsize=None)
def jx():
    import jax
    import jax.numpy as jnp

    from repro import configs, models
    from repro.models import moe, xlstm

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 models=models, moe=moe, xlstm=xlstm)


def _jcfg(arch):
    j = jx()
    return j.configs.reduced_config(j.configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """Numpy JAX parameters of the reduced ``arch``: the norms perturbed
    and, for the MoE, the router and experts scaled."""
    j = jx()
    params, _ = j.models.init_model(_jcfg(arch), j.jax.random.PRNGKey(0))
    out = j.jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   params)
    rng = np.random.default_rng(1)
    out["final_norm"] = out["final_norm"] + np.float32(0.1) * \
        rng.standard_normal(out["final_norm"].shape).astype(np.float32)
    for run in out["runs"]:
        moe = run.get("moe")
        if moe is not None:
            moe["router"] = moe["router"] * np.float32(ROUTER_SCALE)
            for name in ("w_gate", "w_up", "w_down"):
                moe[name] = moe[name] * np.float32(EXPERT_SCALE)
    return out


def _layer(arch, mixer):
    """Layer 0's mixer parameters (numpy) of run 0."""
    return j_tree_map(lambda a: a[0], _params(arch)["runs"][0][mixer])


def j_tree_map(fn, tree):
    """``fn`` on every array of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: j_tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [j_tree_map(fn, v) for v in tree]
    return fn(tree)


def _long_gates(rng):
    """q, k, v ``[B, H, T, dh]`` and gates whose memory outlasts a slice:
    forget ``log_sigmoid(6 + z)``, input ``log_sigmoid(z)``."""
    cfg = _jcfg("xlstm-350m")
    H = cfg.num_heads
    dh = int(cfg.mlstm_proj_factor * cfg.d_model) // H
    shape = (XL_B, H, XL_T)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    log_sig = lambda z: -np.logaddexp(0.0, -z)  # noqa: E731
    q = f32(rng.standard_normal(shape + (dh,)) / np.sqrt(dh))
    k, v = (f32(rng.standard_normal(shape + (dh,))) for _ in range(2))
    return (q, k, v, f32(log_sig(6.0 + rng.standard_normal(shape))),
            f32(log_sig(rng.standard_normal(shape))))


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    d_xl = _jcfg("xlstm-350m").d_model
    d_moe = _jcfg("deepseek-moe-16b").d_model
    return {
        "xlstm_params": _params("xlstm-350m"),
        "moe_params": _params("deepseek-moe-16b"),
        "mlstm_x": rng.standard_normal((XL_B, XL_T, d_xl)).astype(
            np.float32),
        "xlstm_tokens": rng.integers(0, 512, (XL_B, XL_T)),
        "long_gates": _long_gates(rng),
        "moe_x": rng.standard_normal((MOE_B, MOE_T, d_moe)).astype(
            np.float32),
        "moe_tokens": rng.integers(0, 512, (MOE_B, MOE_T)),
        "fault": cases.random_ssm(np.random.default_rng(0), 1, FAULT_N),
    }


def _jax_subprocess(tmp):
    """JAX's own sharded forward passes (8 host devices) to an npz."""
    inp = _inputs()
    flat = {"moe_x": inp["moe_x"]}
    for k, v in _layer("deepseek-moe-16b", "moe").items():
        if isinstance(v, dict):
            flat.update({f"moe/shared/{kk}": vv for kk, vv in v.items()})
        else:
            flat[f"moe/{k}"] = v
    flat.update({f"gates/{i}": g for i, g in enumerate(inp["long_gates"])})
    flat.update({f"fault/{k}": v for k, v in inp["fault"].items()})
    paths = {"inputs": os.path.join(tmp, "inputs.npz"),
             "outputs": os.path.join(tmp, "outputs.npz")}
    np.savez(paths["inputs"], **flat)
    proc = run_snippet(SNIPPET % paths, n_devices=FAULT_DEVICES,
                       timeout=600)
    assert proc.returncode == 0 and "MESH_ORACLES_OK" in proc.stdout, (
        f"JAX oracle subprocess failed (rc={proc.returncode})\n"
        f"{proc.stdout}\n{proc.stderr}")
    return dict(np.load(paths["outputs"]))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(each rank's results, JAX's sharded outputs): the subprocess, the
    ranks and the in-process JAX oracles run at once."""
    tmp = str(tmp_path_factory.mktemp("mesh_oracles"))
    inp = _inputs()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        oracle = pool.submit(_jax_subprocess, tmp)
        ranks = pool.submit(run_ranks, cases.model_session, RANKS, inp,
                            device="cpu", emit=None)
        _jax_mlstm()
        _jax_moe()
        return ranks.result(), oracle.result()


def _replicated(ranks, section, key, shape, field=None):
    """Every rank of a "model" line holds the same output."""
    for r in range(RANKS):
        line0 = (r // shape[1]) * shape[1]
        a, b = ranks[r][section][key], ranks[line0][section][key]
        if field is not None:
            a, b = a[field], b[field]
        np.testing.assert_array_equal(a, b)
    parts = [ranks[dr * shape[1]][section][key] for dr in range(shape[0])]
    if field is not None:
        parts = [p[field] for p in parts]
    return np.concatenate(parts)


SHAPE_IDS = dict(ids=lambda s: "x".join(map(str, s)))


# ---------------------------------------------------------------------------
# The sequence-parallel mLSTM
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mlstm():
    j = jx()
    cfg = _jcfg("xlstm-350m")
    inp = _inputs()
    layer = j_tree_map(j.jnp.asarray, _layer("xlstm-350m", "mlstm"))
    y, _ = j.jax.jit(lambda p, x: j.xlstm.mlstm_layer(p, x, cfg))(
        layer, inp["mlstm_x"])
    h, _ = j.jax.jit(lambda *g: j.xlstm._mlstm_chunked(
        *g, cfg.scan_chunk))(*inp["long_gates"])
    params = j_tree_map(j.jnp.asarray, inp["xlstm_params"])
    logits = j.jax.jit(lambda p, t: j.models.prefill(p, cfg, t))(
        params, inp["xlstm_tokens"])
    return {"layer": np.asarray(y), "chunked": np.asarray(h),
            "prefill": np.asarray(logits)}


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_mlstm_layer_is_sequence_parallel_and_matches_jax(sessions, shape):
    ranks, _ = sessions
    got = _replicated(ranks, "mlstm", ("layer", shape), shape)
    np.testing.assert_allclose(got, _jax_mlstm()["layer"], **TOL)


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_mlstm_sp_carries_state_across_ranks(sessions, shape):
    """On long-memory gates: the port's `_mlstm_sp` equals JAX's unsharded
    chunked form; with the exchange dropped it misses."""
    ranks, _ = sessions
    want = _jax_mlstm()["chunked"]
    got = _replicated(ranks, "mlstm", ("sp", shape), shape)
    np.testing.assert_allclose(got, want, **TOL)
    bad = _replicated(ranks, "mlstm", ("sp_fault", shape), shape)
    excess = np.abs(bad - want) / (TOL["atol"] + TOL["rtol"] * np.abs(want))
    assert excess.max() > 100.0


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_mlstm_sp_matches_jax_shard_map(sessions, shape):
    ranks, oracle = sessions
    got = _replicated(ranks, "mlstm", ("sp", shape), shape)
    np.testing.assert_allclose(got, oracle["sp/" + "x".join(map(str, shape))],
                               **TOL)


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_xlstm_prefill_under_mesh_matches_jax(sessions, shape):
    ranks, _ = sessions
    got = _replicated(ranks, "mlstm", ("prefill", shape), shape)
    np.testing.assert_allclose(got, _jax_mlstm()["prefill"], **TOL)


# ---------------------------------------------------------------------------
# The expert-parallel MoE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_moe():
    j = jx()
    cfg = _jcfg("deepseek-moe-16b")
    inp = _inputs()
    layer = j_tree_map(j.jnp.asarray, _layer("deepseek-moe-16b", "moe"))
    y, aux = j.jax.jit(lambda p, x: j.moe._moe_layer_global(p, x, cfg))(
        layer, inp["moe_x"])
    params = j_tree_map(j.jnp.asarray, inp["moe_params"])
    logits = j.jax.jit(lambda p, t: j.models.prefill(p, cfg, t))(
        params, inp["moe_tokens"])
    return {"global": np.asarray(y), "aux": float(aux),
            "prefill": np.asarray(logits)}


def test_config_capacity_is_drop_free():
    cfg = _jcfg("deepseek-moe-16b")
    assert cfg.capacity_factor == cfg.num_experts / cfg.num_experts_per_tok


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_moe_ep_drop_free_matches_global_dispatch(sessions, shape):
    ranks, _ = sessions
    got = _replicated(ranks, "moe", ("layer", shape, 2.0), shape, field=0)
    want = _jax_moe()
    np.testing.assert_allclose(got, want["global"], **MOE_TOL)
    for r in range(RANKS):
        np.testing.assert_allclose(
            ranks[r]["moe"][("layer", shape, 2.0)][1], want["aux"],
            rtol=1e-5)


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_moe_ep_with_every_expert_on_each_rank(sessions, shape):
    """Unsharded weights under a mesh: the expert-parallel dispatch
    refuses them and names the sharding; the rank's own `shard_experts`
    of them gives the same result as `convert.lm_params(mesh=)`'s."""
    ranks, _ = sessions
    for r in range(RANKS):
        assert "shard the model first" in ranks[r]["moe"][
            ("layer_whole", shape)]
        got, want = (ranks[r]["moe"][key] for key in (
            ("layer_sharded_here", shape), ("layer", shape, 2.0)))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_moe_ep_matches_jax_shard_map(sessions, shape, cf):
    """At the config's capacity (2.0) and a dropping one (0.5), against
    the reference's own ``_moe_layer_ep`` on the same mesh."""
    ranks, oracle = sessions
    name = "x".join(map(str, shape))
    got = _replicated(ranks, "moe", ("layer", shape, cf), shape, field=0)
    np.testing.assert_allclose(got, oracle[f"ep/{name}/{cf}"], **MOE_TOL)
    for r in range(RANKS):
        np.testing.assert_allclose(ranks[r]["moe"][("layer", shape, cf)][1],
                                   oracle[f"ep_aux/{name}/{cf}"], rtol=1e-5)


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_moe_ep_at_half_capacity_drops(sessions, shape):
    """The dropping case does drop: its output differs from the drop-free
    one, in the port as in the reference."""
    ranks, oracle = sessions
    name = "x".join(map(str, shape))
    assert np.abs(oracle[f"ep/{name}/0.5"]
                  - oracle[f"ep/{name}/2.0"]).max() > 1e-2
    for r in range(RANKS):
        half, full = (ranks[r]["moe"][("layer", shape, cf)][0]
                      for cf in (0.5, 2.0))
        assert np.abs(half - full).max() > 1e-2


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_moe_prefill_under_mesh_matches_jax(sessions, shape):
    ranks, _ = sessions
    got = _replicated(ranks, "moe", ("prefill", shape), shape)
    np.testing.assert_allclose(got, _jax_moe()["prefill"], **TOL)


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_lm_params_keeps_the_ranks_expert_shards(sessions, shape):
    """Each rank's experts and shared-expert shards concatenate back to
    the JAX weights; the router stays whole."""
    ranks, _ = sessions
    layer = _layer("deepseek-moe-16b", "moe")
    tp = shape[1]
    for dr in range(shape[0]):
        line = [ranks[dr * tp + m]["moe"][("weights", shape)]
                for m in range(tp)]
        np.testing.assert_array_equal(
            np.concatenate([w["w_gate"] for w in line]), layer["w_gate"])
        np.testing.assert_array_equal(
            np.concatenate([w["w_down"] for w in line]), layer["w_down"])
        # nn.Linear weights are [out, in]: the column shard of the [in,
        # out] w_gate is a row block, w_down's row shard a column block.
        np.testing.assert_array_equal(
            np.concatenate([w["shared_gate"] for w in line]).T,
            layer["shared"]["w_gate"])
        np.testing.assert_array_equal(
            np.concatenate([w["shared_down"] for w in line], axis=1).T,
            layer["shared"]["w_down"])
        for w in line:
            np.testing.assert_array_equal(w["router"], layer["router"])


@pytest.mark.parametrize("shape", cases.SHAPES, **SHAPE_IDS)
def test_decode_with_sharded_experts_raises(sessions, shape):
    ranks, _ = sessions
    for r in range(RANKS):
        assert "experts" in ranks[r]["moe"][("decode", shape)]


# ---------------------------------------------------------------------------
# The reference's sharded-driver fault (ROADMAP C7) and the port's repair
# ---------------------------------------------------------------------------

def _per_shard(a, n_shards):
    return np.abs(a).reshape(n_shards, -1).max(axis=1)


def test_reference_sharded_filter_is_wrong_past_shard_0(sessions):
    """JAX's ``parallel_filter(axis_name=...)`` builds every shard's first
    element from the prior: right on shard 0, more than 0.1 off past it."""
    _, o = sessions
    err = _per_shard(o["fault/got_f/mean"] - o["fault/ref_f/mean"],
                     FAULT_DEVICES)
    assert err[0] < 1e-12 and err.max() > 0.1


def test_reference_sharded_smoother_and_sqrt_are_wrong_too(sessions):
    """Fed the right filtered input, JAX's sharded smoother still gives
    every shard a terminal element and an x_0 row; its sharded
    square-root filter repeats the filter's fault."""
    _, o = sessions
    nl = FAULT_N // FAULT_DEVICES
    got = o["fault/got_s/mean"].reshape(FAULT_DEVICES, nl + 1, -1)
    ref = o["fault/ref_s/mean"]
    body = np.stack([got[d, 1:] - ref[d * nl + 1:(d + 1) * nl + 1]
                     for d in range(FAULT_DEVICES)])
    x0_rows = np.stack([got[d, 0] - ref[d * nl]
                        for d in range(FAULT_DEVICES)])
    assert np.abs(body[-1]).max() < 1e-9 and np.abs(body[:-1]).max() > 1e-3
    # (Shard 0's x_0 row is the right kind of row, built on its wrong
    # smoothed rows.)
    assert np.abs(x0_rows[1:]).max() > 1e-3
    err = _per_shard(o["fault/got_q/mean"] - o["fault/ref_q/mean"],
                     FAULT_DEVICES)
    assert err[0] < 1e-9 and err.max() > 0.1


@pytest.mark.parametrize("part,ref", [("filter", "ref_f"),
                                      ("smoother", "ref_s"),
                                      ("sqrt_filter", "ref_q")])
def test_port_sharded_drivers_are_right_on_the_fault_inputs(sessions, part,
                                                            ref):
    ranks, o = sessions
    smoothed = part == "smoother"
    for field, name in ((0, "mean"), (1, "cov")):
        parts = [ranks[r]["fault"][part][field] for r in range(RANKS)]
        if smoothed:
            parts = [parts[0]] + [p[1:] for p in parts[1:]]
        np.testing.assert_allclose(np.concatenate(parts),
                                   o[f"fault/{ref}/{name}"], **F64_TOL)
