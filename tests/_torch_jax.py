"""A fixture shared by the PyTorch port's test modules, which run the JAX
package beside the port. Import it by name into a test module
(``from _torch_jax import release_jax_caches``: pytest puts ``tests/``
on ``sys.path`` when it imports a module there) and pytest applies it to
that module."""
import sys

import pytest


@pytest.fixture(autouse=True, scope="module")
def release_jax_caches():
    """Drop JAX's compiled executables when the module's tests end: a
    test process that keeps compiling JAX programs without releasing
    them can crash inside XLA's CPU compiler (ROADMAP queue C)."""
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
