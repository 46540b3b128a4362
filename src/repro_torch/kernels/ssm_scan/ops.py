"""Public wrapper of the linear-recurrence scan kernel.

Accepts ``[T, D]`` or ``[B, T, D]`` inputs and folds an optional initial
state into the first step, as the JAX package's ``ssm_scan`` does. A CUDA
tensor goes to the kernel, a CPU tensor to the plain version (the
decision is `ssm_scan_cuda`'s, from the tensor).
"""
from __future__ import annotations

from typing import Optional

import torch

from .ssm_scan import ssm_scan_cuda


def ssm_scan(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *, chunk: int = 128,
             d_block: int = 512) -> torch.Tensor:
    """All states of ``h_t = a_t h_{t-1} + b_t`` along the time axis.

    ``a, b`` are ``[T, D]`` or ``[B, T, D]``; ``h0`` is ``[D]`` or
    ``[B, D]`` (default 0). ``chunk`` and ``d_block`` are the TPU kernel's
    tile sizes (time chunk ``CT`` and channel block ``CD``); they are
    accepted so the signature matches the JAX package and change no
    result: the CUDA kernel walks each channel's whole time axis.
    """
    if chunk < 1 or d_block < 1:
        raise ValueError(f"chunk={chunk} and d_block={d_block} must be >= 1")
    squeeze = a.ndim == 2
    if squeeze:
        a, b = a[None], b[None]
        if h0 is not None:
            h0 = h0[None]
    if h0 is not None and a.shape[1] > 0:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    out = ssm_scan_cuda(a.contiguous(), b.contiguous())
    return out[0] if squeeze else out
