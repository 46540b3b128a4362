"""Oracle for the ssm_scan kernel: the sequential recurrence over time."""
from __future__ import annotations

from typing import Optional

import torch


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a, b [B, T, D]`` -> all states ``h [B, T, D]`` (``h0`` default 0)."""
    B, T, D = a.shape
    h = a.new_zeros((B, D)) if h0 is None else h0
    out = a.new_empty((B, T, D))
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
