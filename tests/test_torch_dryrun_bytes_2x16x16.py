"""Port parity: the cell plans' resident bytes per chip on the 2 x 16 x
16 multi-pod production mesh ("pod", "data", "model") against the JAX
package's ``make_cell_plan(...).per_chip_argument_bytes()`` on an
Auto-axis ``AbstractMesh``, for every (arch x shape) cell, as
`test_torch_dryrun_bytes_16x16.py` does on 16 x 16. Exact."""
import pytest

from _dryrun_cases import CELLS, check_cell, memoized_jax_specs  # noqa: F401
from _torch_jax import release_jax_caches  # noqa: F401


@pytest.mark.usefixtures("memoized_jax_specs")
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_bytes_equal_jax_on_2x16x16(arch, shape):
    check_cell(arch, shape, (2, 16, 16), ("pod", "data", "model"))


def test_grok_train_and_qwen2_decode_cells_on_2x16x16():
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import AbstractMesh
    from repro_torch.launch.steps import make_cell_plan

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert make_cell_plan(get_config("grok-1-314b"), mesh,
                          SHAPES["train_4k"]).per_chip_argument_bytes() \
        == 8_766_830_084
    assert make_cell_plan(get_config("qwen2-1.5b"), mesh,
                          SHAPES["decode_32k"]).per_chip_argument_bytes() \
        == 475_150_484
