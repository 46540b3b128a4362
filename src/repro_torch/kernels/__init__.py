"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``):

  * ``kalman_combine`` — the batched Eq. 15 / Eq. 19 combines of the
    parallel smoother's scans (``csrc/kalman_combine.cu``);
  * ``ssm_scan`` — the diagonal linear-recurrence scan behind
    ``core.linear_recurrence_scan(combine_impl="pallas")``
    (``csrc/ssm_scan.cu``);
  * ``flash_attention`` — blocked causal GQA attention with an online
    softmax (``csrc/flash_attention.cu``).

``build.py`` compiles each source with ``nvcc`` at first use and loads it
with ``ctypes``.

Each kernel package mirrors the JAX package's layout:
  * ``<name>.py`` — the kernel wrappers, their plain PyTorch versions and
    launch counters;
  * ``ops.py``   — the static per-call-site dispatch;
  * ``ref.py``   — the textbook oracle.
"""
