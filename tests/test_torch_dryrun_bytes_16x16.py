"""Port parity: the cell plans' resident bytes per chip
(`CellPlan.per_chip_argument_bytes`) on the 16 x 16 production mesh
against the JAX package's ``make_cell_plan(...).per_chip_argument_bytes()``
on an Auto-axis ``AbstractMesh``, for every (arch x shape) cell: the
train, prefill and decode plans of each supported one, and the
reference's reason for each one an arch does not support. Exact."""
import pytest

from _dryrun_cases import CELLS, check_cell, memoized_jax_specs  # noqa: F401
from _torch_jax import release_jax_caches  # noqa: F401


@pytest.mark.usefixtures("memoized_jax_specs")
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_bytes_equal_jax_on_16x16(arch, shape):
    check_cell(arch, shape, (16, 16), ("data", "model"))


def test_grok_train_cell_on_16x16():
    # The global dispatch's train cell, once refused on a mesh.
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import AbstractMesh
    from repro_torch.launch.steps import make_cell_plan

    plan = make_cell_plan(get_config("grok-1-314b"),
                          AbstractMesh((16, 16), ("data", "model")),
                          SHAPES["train_4k"])
    assert plan.per_chip_argument_bytes() == 15_109_864_452
