"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``).

Each kernel package mirrors the JAX package's layout:
  * ``<name>.py`` — the kernel wrappers, their plain PyTorch versions and
    launch counters;
  * ``ops.py``   — the static per-call-site dispatch;
  * ``ref.py``   — the textbook oracle.
"""
