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

No kernel has a backward (the JAX package's Pallas kernels have none
either, and its training path reaches none of them). A wrapper handed a
CUDA tensor that needs a gradient, with grad mode on, raises
(`refuse_autograd`): its output would otherwise cut the autograd graph
without a word. Training runs the plain versions.
"""
import torch


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """Raise a ``RuntimeError`` when grad mode is on and one of
    ``tensors`` requires grad. A guard, not a fallback: nothing runs in
    the kernel's place."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input "
            "requires grad with grad mode on; train on the plain versions "
            "(impl='plain', as models.train_loss does) or call the kernel "
            "under torch.no_grad()")
