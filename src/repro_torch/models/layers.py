"""Shared building blocks of the LM substrate (PyTorch).

The JAX package's ``repro.models.layers`` as functions on tensors, with
explicit ``torch.Generator``s in place of JAX keys, and the training
loss, `cross_entropy_loss`. `_active_mesh` is how the mixers see the
ambient mesh.

Tensor parallelism. The reference pins its layouts with ``maybe_shard``
and leaves the collectives to GSPMD. In the port a rank holds its shard
and computes on it directly (`repro_torch.distributed`), so the intent
of those pins becomes explicit code: a tensor-parallel module (one whose
``tp_axis`` names the mesh axis its weights split over, set by
`launch.sharding.shard_tensor_parallel`) enters its region with
`tp_enter` (the residual gathered along the sequence where it is
sequence-parallel, else taken as replicated) and leaves it with
`tp_exit` (the partial products summed, and scattered along the
sequence where the residual is sequence-parallel). The embedding and
the loss split the padded vocabulary over the same axis
(`vocab_parallel_embedding`, `vocab_parallel_ce_terms`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.distributed import (active_mesh, axis_index,
                                     copy_to_region, gather_sequence, pmax,
                                     psum, reduce_from_region,
                                     scatter_sequence)

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


def tp_axis(module) -> Optional[str]:
    """The mesh axis a module's weights split over (tensor parallelism),
    or None where it holds them whole."""
    return getattr(module, "tp_axis", None)


def tp_enter(x: torch.Tensor, axis: str, seq_split: bool) -> torch.Tensor:
    """A tensor-parallel region's input from the residual stream ``x [B,
    T', d]``: where the stream is sequence-parallel (``seq_split``: the
    rank holds its block of the sequence), the whole sequence
    (`gather_sequence`); else ``x`` itself, replicated over ``axis``
    (`copy_to_region`). Either way the backward pass sums the ranks'
    partial cotangents."""
    return gather_sequence(x, axis) if seq_split else copy_to_region(x, axis)


def tp_exit(y: torch.Tensor, axis: str, seq_split: bool) -> torch.Tensor:
    """A tensor-parallel region's output into the residual stream: the
    ranks' partial products ``y [B, T, d]`` summed over ``axis``, of which
    the rank keeps its block of the sequence where the stream is
    sequence-parallel (`scatter_sequence`), else all of it
    (`reduce_from_region`)."""
    return scatter_sequence(y, axis) if seq_split else \
        reduce_from_region(y, axis)


def tp_weight(w: torch.Tensor, axis: Optional[str], varies: bool
              ) -> torch.Tensor:
    """A weight held whole on every rank of ``axis`` that each rank uses
    in its own way (``varies``: a norm on the rank's block of the
    sequence, a replicated k/v projection feeding the rank's heads): its
    gradient is the sum of the ranks' parts (`copy_to_region`). Else
    ``w`` itself."""
    return copy_to_region(w, axis) if axis is not None and varies else w


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor,
                             axis: str, seq_split: bool = False
                             ) -> torch.Tensor:
    """The reference's ``embedding_lookup`` over a table split along the
    padded vocabulary over ``axis`` (``table``: the rank's block of rows):
    each rank looks up the ids in its block, zeros elsewhere, and the
    ranks' rows are summed (`reduce_from_region`), or summed and scattered
    along the sequence where the residual stream is sequence-parallel
    (``seq_split``). Exact: each row has one nonzero term."""
    Vb = table.shape[0]
    local = ids - axis_index(axis) * Vb
    inside = (local >= 0) & (local < Vb)
    rows = table[local.clamp(0, Vb - 1)]
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return tp_exit(rows, axis, seq_split)


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


def vocab_parallel_ce_terms(logits: torch.Tensor, labels: torch.Tensor,
                            vocab_size: int, axis: str, *,
                            z_loss: float = 0.0, ignore_id: int = -1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`cross_entropy_terms` of logits split along the padded vocabulary
    over ``axis`` (``logits [..., Vp / n]``: the rank's block of columns):
    the row max by `pmax` (no gradient: it only shifts), the sum of the
    exponentials and the target logit by `psum`, so each rank's gradient
    is that of its own columns. The result is replicated over ``axis``."""
    logits = logits.float()
    Vb = logits.shape[-1]
    first = axis_index(axis) * Vb
    col = first + torch.arange(Vb, device=logits.device)
    if first + Vb > vocab_size:
        logits = logits.masked_fill(col >= vocab_size, -1e30)
    valid = labels != ignore_id
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    mx = pmax(logits.detach().amax(dim=-1), axis)
    sumexp = psum(torch.exp(logits - mx[..., None]).sum(dim=-1), axis)
    lse = mx + torch.log(sumexp)
    local = safe - first
    inside = (local >= 0) & (local < Vb)
    picked = torch.gather(logits, -1, local.clamp(0, Vb - 1)[..., None])[
        ..., 0]
    target = psum(torch.where(inside, picked, picked.new_zeros(())), axis)
    nll = lse - target
    if z_loss > 0.0:
        nll = nll + z_loss * lse ** 2
    return torch.where(valid, nll, nll.new_zeros(())).sum(), valid.sum()
