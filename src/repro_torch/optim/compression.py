"""Gradient compression for a bandwidth-bound all-reduce: int8
quantization with error feedback (opt-in), the JAX package's
``repro.optim.compression``.

The cross-pod gradient reduction is the one collective that crosses the
slow network between pods. `compress`/`decompress` shrink a tensor 4x
(float32 to int8 with a per-tensor scale); the residual is fed back into
the next step's gradient, so the *accumulated* update is unbiased
(error-feedback SGD, Seide et al.). `compressed_psum` runs inside ``with
mesh:`` on every rank of the axis (the reference's ``shard_map``/``pmap``
body). It sums the payload as int32 on the wire, as the reference does,
so it moves as many bytes as a float32 `psum` of the same gradients, plus
a scalar `pmax` per tensor: it saves nothing against `psum`.

Gradients are a tensor or any nesting of dicts, lists and tuples of
tensors; the residual nests alike.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.distributed import pmax, psum, tree_map


class CompressionState(NamedTuple):
    residual: Any  # float32, nested like the gradients


def _map(fn, tree, *others):
    return tree_map(fn, tree, *others,
                    is_leaf=lambda x: isinstance(x, torch.Tensor))


def init_compression(grads_like) -> CompressionState:
    return CompressionState(residual=_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does.
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compress(g: torch.Tensor, r: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 payload, scale, new residual)."""
    x = g.float() + r
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = _quantize(x, scale)
    return q, scale, x - q.float() * scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads, state: CompressionState, axis_name: str
                    ) -> Tuple[Any, CompressionState]:
    """Error-feedback int8 all-reduce over ``axis_name``, inside ``with
    mesh:``. The ranks agree on a common scale by a (scalar) `pmax`
    first, so that the integer sum equals the scaled float sum; the
    payload crosses the wire as int32 (a sum of int8 payloads leaves the
    int8 range). Returns (the summed gradients, float32, the new
    state)."""
    def one(g, r):
        x = g.float() + r
        scale = pmax(x.abs().max(), axis_name) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = _quantize(x, scale)
        new_r = x - q.float() * scale
        total = psum(q.to(torch.int32), axis_name)
        return total.float() * scale, new_r

    leaves = []
    _map(lambda g, r: leaves.append((g, r)), grads, state.residual)
    with torch.no_grad():
        outs = [one(g, r) for g, r in leaves]
    sums, residuals = iter([o[0] for o in outs]), iter([o[1] for o in outs])
    return (_map(lambda g: next(sums), grads),
            CompressionState(residual=_map(lambda g: next(residuals),
                                           grads)))
