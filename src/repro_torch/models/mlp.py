"""SwiGLU MLP. Its three products stay `torch.matmul` (through
``nn.Linear``): the reference leaves them to XLA, outside any kernel."""
from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.models.layers import init_linear, silu


class MLP(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, d_ff: int,
                 dtype: torch.dtype):
        super().__init__()
        self.w_gate = init_linear(gen, d, d_ff, dtype)
        self.w_up = init_linear(gen, d, d_ff, dtype)
        self.w_down = init_linear(gen, d_ff, d, dtype)


def init_mlp(gen: torch.Generator, d: int, d_ff: int,
             dtype: torch.dtype) -> MLP:
    return MLP(gen, d, d_ff, dtype)


def mlp(params: MLP, x: torch.Tensor) -> torch.Tensor:
    h = silu(params.w_gate(x)) * params.w_up(x)
    return params.w_down(h)
