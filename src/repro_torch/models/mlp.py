"""SwiGLU MLP. Its three products stay `torch.matmul` (through
``nn.Linear``): the reference leaves them to XLA, outside any kernel.

Under tensor parallelism (``tp_axis`` set by
`launch.sharding.shard_tensor_parallel`) the rank holds the reference's
"model" blocks: ``w_gate`` and ``w_up`` column-parallel (its block of
``d_ff``), ``w_down`` row-parallel, so the block enters its region from
the residual stream and leaves it with one sum of the partial products
(`layers.tp_enter`, `layers.tp_exit`)."""
from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.models.layers import init_linear, silu, tp_axis, tp_enter, \
    tp_exit


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


def mlp(params: MLP, x: torch.Tensor, *, seq_split: bool = False
        ) -> torch.Tensor:
    """``x [B, T, d]`` -> ``[B, T, d]``; under tensor parallelism ``x`` and
    the output are the residual stream as the rank holds it (its block of
    the sequence where ``seq_split``)."""
    axis = tp_axis(params)
    if axis is not None:
        x = tp_enter(x, axis, seq_split)
    h = silu(params.w_gate(x)) * params.w_up(x)
    out = params.w_down(h)
    return out if axis is None else tp_exit(out, axis, seq_split)
