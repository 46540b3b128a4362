"""Port parity: the decode caches' layout on a mesh. Every cache spec
function (`attention.kv_cache_spec`, `ssm.ssm_cache_spec`,
`xlstm.mlstm_cache_spec`, `xlstm.slstm_cache_spec`,
`blocks.run_cache_spec`, `models.cache_specs`) against the JAX
package's, leaf for leaf, for every registered arch and batch spec; the
decode plan's cache shapes and specs (`launch.steps
._cache_shapes_and_specs`: the sequence-split rule, the multi-pod
adaptation) against the reference's on both production meshes; and
`launch.sharding.named` and `eval_shapes_init`. Exact."""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import AxisType, PartitionSpec as JP

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config, list_configs
from repro_torch.distributed import AbstractMesh, NamedSharding, P
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention, blocks, cache_specs, ssm, xlstm
from _torch_jax import release_jax_caches  # noqa: F401

ARCHS = sorted(list_configs())
BATCH_SPECS = [("data",), None, ("pod", "data")]
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _leaves(tree):
    """Spec leaves of a port tree (our `P` is a tuple: stop at it)."""
    out = []

    def walk(t):
        if isinstance(t, P):
            out.append(tuple(t))
        elif isinstance(t, dict):
            for k in t:
                walk(t[k])
        else:
            for x in t:
                walk(x)
    walk(tree)
    return out


def _jleaves(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _same(port, ref):
    # Same nesting (NamedTuple fields, dict keys, list lengths) and specs.
    if isinstance(ref, JP):
        assert tuple(port) == tuple(ref)
    elif isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _same(port[k], ref[k])
    else:
        assert type(port).__name__ == type(ref).__name__
        if hasattr(ref, "_fields"):
            assert port._fields == ref._fields
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _same(a, b)


@pytest.mark.parametrize("batch_spec", BATCH_SPECS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax_leaf_for_leaf(arch, batch_spec):
    cfg, jcfg = get_config(arch), jget_config(arch)
    _same(cache_specs(cfg, batch_spec), jmodels.cache_specs(jcfg, batch_spec))
    runs, jruns = blocks.layer_schedule(cfg), jblocks.layer_schedule(jcfg)
    for run, jrun in zip(runs, jruns):
        _same(blocks.run_cache_spec(cfg, run, batch_spec),
              jblocks.run_cache_spec(jcfg, jrun, batch_spec))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "grok-1-314b", "hymba-1.5b",
                                  "xlstm-350m"])
def test_layer_cache_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for bs in BATCH_SPECS:
        _same(attention.kv_cache_spec(cfg, bs), jattn.kv_cache_spec(jcfg, bs))
        _same(ssm.ssm_cache_spec(cfg, bs), jssm.ssm_cache_spec(jcfg, bs))
        _same(xlstm.mlstm_cache_spec(cfg, bs),
              jxlstm.mlstm_cache_spec(jcfg, bs))
        _same(xlstm.slstm_cache_spec(cfg, bs),
              jxlstm.slstm_cache_spec(jcfg, bs))


@pytest.mark.parametrize("mesh", MESHES,
                         ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_shapes_and_specs_equal_jax(arch, mesh):
    # The decode plan's caches at decode_32k's B = 128, S = 32,768 and at
    # B = 1 (long_500k's batch), where the batch stays whole.
    shape, axes = mesh
    jmesh = JAbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(
        shape))
    cfg, jcfg = get_config(arch), jget_config(arch)
    for B, S in ((128, 32768), (1, 4096)):
        shapes, specs = tsteps._cache_shapes_and_specs(
            cfg, B, S, AbstractMesh(shape, axes))
        jshapes, jspecs = jsteps._cache_shapes_and_specs(jcfg, B, S, jmesh)
        jspecs = jsharding.adapt_specs_for_mesh(jspecs, jmesh)
        assert _leaves(specs) == _jleaves(jspecs)
        got = [(tuple(t.shape), t.dtype.itemsize)
               for t in jax.tree_util.tree_leaves(shapes)]
        want = [(tuple(t.shape), np.dtype(t.dtype).itemsize)
                for t in jax.tree_util.tree_leaves(jshapes)]
        assert got == want
        assert all(t.device.type == "meta"
                   for t in jax.tree_util.tree_leaves(shapes))


def test_named_and_eval_shapes_init_equal_jax():
    pod = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    jpod = JAbstractMesh((2, 16, 16), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    specs = {"a": P("data", None), "b": [P(None, "model"), P()]}
    jspecs = {"a": JP("data", None), "b": [JP(None, "model"), JP()]}
    got = tsharding.named(pod, specs)
    want = jsharding.named(jpod, jspecs)
    assert isinstance(got["a"], NamedSharding) and got["a"].mesh is pod
    assert tuple(got["a"].spec) == tuple(want["a"].spec)
    assert [tuple(s.spec) for s in got["b"]] == \
        [tuple(s.spec) for s in want["b"]]
    for arch in ("qwen2-1.5b",):
        shapes, pspecs = tsharding.eval_shapes_init(get_config(arch))
        jshapes, _ = jsharding.eval_shapes_init(jget_config(arch))
        assert list(shapes) == list(pspecs)
        # The same parameter count and bytes, nothing allocated.
        n = sum(int(np.prod(s)) for s, _ in shapes.values())
        jn = sum(int(np.prod(t.shape))
                 for t in jax.tree_util.tree_leaves(jshapes))
        assert n == jn
        nbytes = sum(int(np.prod(s)) * d.itemsize for s, d in shapes.values())
        jbytes = sum(int(np.prod(t.shape)) * np.dtype(t.dtype).itemsize
                     for t in jax.tree_util.tree_leaves(jshapes))
        assert nbytes == jbytes
