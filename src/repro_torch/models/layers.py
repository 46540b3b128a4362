"""Shared building blocks of the LM substrate (PyTorch).

The JAX package's ``repro.models.layers`` as functions on tensors, with
explicit ``torch.Generator``s in place of JAX keys, and the training
loss, `cross_entropy_loss`. Its ``maybe_shard`` has
no counterpart: a rank of a mesh holds its shard and computes on it
directly (`repro_torch.distributed`); `_active_mesh` is how the mixers
see that mesh.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from repro_torch.distributed import active_mesh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _active_mesh():
    """The ambient mesh (``with mesh:``), or None."""
    return active_mesh()


def _active_mesh_axes() -> tuple:
    """Axis names of the ambient mesh (``with mesh:``), or ()."""
    mesh = _active_mesh()
    return () if mesh is None else tuple(mesh.axis_names)


def normal_init(gen: torch.Generator, shape: Tuple[int, ...],
                dtype: torch.dtype, scale: float = 0.02) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 on the generator's device, then
    cast to ``dtype`` (the reference casts before scaling too)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.to(dtype) * scale


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """The reference's precision split: the mean square in float32, the
    normalising multiply in the input's dtype."""
    xf = x.float()
    scale = torch.rsqrt(xf.mul(xf).mean(dim=-1, keepdim=True) + eps)
    return x * scale.to(x.dtype) * w


def init_rms_norm(d: int, dtype: torch.dtype,
                  device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, *, bias: bool = False) -> nn.Linear:
    """An ``nn.Linear`` (weight stored ``[out, in]``) holding the
    reference's ``[in, out]`` matrix ``normal_init(gen, (d_in, d_out))``
    transposed, and a zero bias when asked for."""
    lin = nn.Linear(d_in, d_out, bias=bias, device="meta", dtype=dtype)
    lin.weight = nn.Parameter(normal_init(gen, (d_in, d_out), dtype).T
                              .contiguous())
    if bias:
        lin.bias = nn.Parameter(torch.zeros((d_out,), dtype=dtype,
                                            device=gen.device))
    return lin


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(normal_init(gen, (vocab, d), dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_size: int, *, z_loss: float = 0.0,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean cross-entropy over the valid tokens (``labels != ignore_id``),
    in float32: ``logits [..., Vp]`` with the padded vocabulary
    (``Vp > vocab_size``) masked to -1e30, ``labels [...]`` int. With
    ``z_loss > 0`` each token adds ``z_loss * logsumexp^2``. The mean
    divides by ``max(count, 1)``."""
    total, count = cross_entropy_terms(logits, labels, vocab_size,
                                       z_loss=z_loss, ignore_id=ignore_id)
    return total / count.clamp_min(1)


def cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor,
                        vocab_size: int, *, z_loss: float = 0.0,
                        ignore_id: int = -1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`cross_entropy_loss` before its mean: (the sum over the valid
    tokens, float32; their count, an integer tensor). On a mesh the
    global mean is the ratio of the two summed over the batch axes."""
    logits = logits.float()
    Vp = logits.shape[-1]
    if Vp > vocab_size:
        pad = torch.arange(Vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    valid = labels != ignore_id
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - torch.gather(logits, -1, safe[..., None])[..., 0]
    if z_loss > 0.0:
        nll = nll + z_loss * lse ** 2
    return torch.where(valid, nll, nll.new_zeros(())).sum(), valid.sum()
