"""Shared by `test_torch_dryrun_bytes_16x16.py` and
`test_torch_dryrun_bytes_2x16x16.py`: every (arch x shape) cell of a
production mesh, and the check of one cell against the JAX package's
plan on an Auto-axis ``AbstractMesh`` (no compile, no devices)."""
import functools

import pytest

from repro_torch.configs import ALL_SHAPES, SHAPES, get_config, list_configs
from repro_torch.distributed import AbstractMesh
from repro_torch.launch.steps import make_cell_plan

CELLS = [(a, s.name) for a in sorted(list_configs()) for s in ALL_SHAPES]


@pytest.fixture(scope="module")
def memoized_jax_specs():
    """The JAX package's ``sharding._specs_only`` (an ``eval_shape`` of
    ``init_model``: a pure function of the config, most of a plan's
    cost) memoized while the module's tests run, so that each arch's
    tree is traced once for its four shapes."""
    from repro.launch import sharding as jsharding

    original = jsharding._specs_only
    jsharding._specs_only = functools.lru_cache(maxsize=None)(original)
    yield
    jsharding._specs_only = original


def check_cell(arch: str, shape_name: str, shape: tuple, axes: tuple):
    """The port's plan counts the reference's per-chip argument bytes on
    every supported cell, and skips the others with the reference's
    reason."""
    from jax.sharding import AbstractMesh as JaxAbstractMesh, AxisType
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.launch.steps import make_cell_plan as jmake_cell_plan

    cfg, jcfg = get_config(arch), jget_config(arch)
    ok, reason = cfg.supports_shape(SHAPES[shape_name])
    assert (ok, reason) == jcfg.supports_shape(JSHAPES[shape_name])
    if not ok:
        assert reason
        return
    jmesh = JaxAbstractMesh(shape, axes,
                            axis_types=(AxisType.Auto,) * len(shape))
    want = jmake_cell_plan(jcfg, jmesh, JSHAPES[shape_name]) \
        .per_chip_argument_bytes()
    plan = make_cell_plan(cfg, AbstractMesh(shape, axes), SHAPES[shape_name])
    assert plan.kind == SHAPES[shape_name].kind
    assert plan.per_chip_argument_bytes() == want, (arch, shape_name)
