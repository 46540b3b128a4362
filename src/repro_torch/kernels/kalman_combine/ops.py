"""Static per-call-site dispatch of the batched Kalman combines.

The choice is made once per scan (every Blelloch level of one scan takes
the same path), from the spec's ``combine_impl``/``backend`` as
`IteratedConfig.resolved_combine_impl` resolves them:

  * ``"pallas"`` / ``"pallas:gpu"`` — the hand-written CUDA kernels. The
    wrapper decides from the tensor: a CUDA tensor launches the kernel, a
    CPU tensor takes the plain version. ``backend="gpu"`` always resolves
    here;
  * ``"fused"`` — the plain PyTorch versions of the kernel math, on
    either device (``backend="jnp"``);
  * ``backend="auto"`` — the measured winner of `autotune` for the call
    site's ``(spec_id, B, T, nx)`` on its device's platform; where
    nothing was measured, the kernels on a CUDA device and the plain
    versions on the CPU;
  * ``backend="tpu"`` — no lowering exists in the port: raises.

`kernel_backend` names the compiled lowering of a device: ``"gpu"`` for
a CUDA device, ``None`` for the CPU, where `autotune` measures nothing.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.parallel import filtering_combine, smoothing_combine
from repro_torch.core.types import Device

from . import kalman_combine as _k

#: Backends a ``"pallas:<backend>"`` combine_impl may name.
KERNEL_BACKENDS = ("gpu",)


def kernel_backend(device: Device = None) -> Optional[str]:
    """The device's *compiled* kernel lowering: ``"gpu"`` for a CUDA
    device, ``None`` for the CPU (only the plain versions run there).
    ``None`` means the default device: the card where there is one."""
    if device is None:
        return "gpu" if torch.cuda.is_available() else None
    return "gpu" if torch.device(device).type == "cuda" else None


def resolve_backend(requested: Optional[str] = None) -> str:
    """The kernel backend for a ``"pallas[:backend]"`` combine_impl:
    ``None`` means the card's kernels ("gpu"); anything else raises."""
    if requested is None or requested == "gpu":
        return "gpu"
    if requested == "tpu":
        raise ValueError('backend "tpu" has no lowering in the PyTorch '
                         'port; use backend="auto" or "gpu"')
    raise ValueError(f"unknown kernel backend {requested!r}; "
                     f"available: {list(KERNEL_BACKENDS)}")


def plain_batched_combine_for(combine: Callable) -> Callable:
    """The plain PyTorch version of a core combine's kernel math
    (broadcasting over any leading axes); unknown combines run as given."""
    if combine is filtering_combine:
        return _k.filtering_combine_plain
    if combine is smoothing_combine:
        return _k.smoothing_combine_plain
    return combine


def batched_combine_for(combine: Callable) -> Tuple[Callable, bool]:
    """Map a core combine to its kernel wrapper: ``(op, on_pair_grid)``.

    The kernel wrappers take views of ``[L, P]`` pairs (any strides over
    the grid, no packing); unknown (user) combines have no kernel and run
    as given, broadcasting."""
    if combine is filtering_combine:
        return _k.filtering_combine_cuda, True
    if combine is smoothing_combine:
        return _k.smoothing_combine_cuda, True
    return combine, False
