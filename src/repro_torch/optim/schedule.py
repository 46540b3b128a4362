"""LR schedules: linear warmup + cosine decay (the production default),
the JAX package's ``repro.optim.schedule`` on tensors. ``step`` may be
an int or a device scalar; the scale comes back on its device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """The multiplicative LR scale at ``step`` (a float32 scalar)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, value: float = 1.0) -> torch.Tensor:
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.tensor(value, dtype=torch.float32, device=device)
