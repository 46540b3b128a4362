"""Shared test config.

float64 is enabled for tight oracle comparisons in the core tests; all
model/framework code declares dtypes explicitly, so this does not change
its behavior. The dry-run launcher (`repro.launch.dryrun`) runs in its own
process and is unaffected.
"""
import jax

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); the test "
        "skips itself where torch.cuda.is_available() is False")
