"""Selective SSM (Mamba-style) sequence mixer: the JAX package's
``repro.models.ssm`` on tensors. The state recurrence
``h_t = a_t * h_{t-1} + b_t`` is the diagonal linear recurrence of the
``ssm_scan`` kernel (`kernels.ssm_scan.ssm_scan_cuda`).

Prefill keeps the reference's time chunks of ``cfg.scan_chunk`` steps:
per chunk the elements ``a, b [B, CT, d_inner * n]`` (never ``[B, T,
d_inner * n]``), the carried state folded into ``b[:, 0]``, one scan. The
last chunk is as long as what is left of T (the reference pads it; the
padding changes no real step). Decode is one elementwise step, as in the
reference, and writes the state and the conv history into the cache's
buffers in place (``copy_``), so a step never waits on the host.

Where the prefill scan runs (``impl``):

* ``"auto"`` — the ``ssm_scan`` CUDA kernel on a CUDA tensor, the plain
  version on a CPU tensor;
* ``"plain"`` — `kernels.ssm_scan.ssm_scan_plain` on any device.

Each plain scan adds one to ``PLAIN_CALLS["ssm_scan"]``.

Tensor parallelism (an `SSM` whose ``tp_axis`` names the mesh axis, set
by `launch.sharding.shard_tensor_parallel`): the rank holds the
reference's "model" block of the ``d_inner`` channels, Megatron's column
and row pattern. ``in_proj`` is its block of each half, ``[x_r ; z_r]``
(`launch.sharding.split_halves`); ``conv_w``, ``dt_w``, ``dt_bias``,
``A_log`` and ``D`` its channels; ``x_proj`` and ``out_proj`` are
row-parallel. The layer enters its region from the residual stream
(`layers.tp_enter`: the whole sequence where the stream is
sequence-parallel), sums ``x_proj``'s partial products ``dt_bc [B, T,
dt_rank + 2n]`` over the axis before the softplus (one small all-reduce,
whose backward pass sums the ranks' partial cotangents), scans the rank's
``B T (d_inner / tp) n`` elements with no exchange, and leaves with the
partial products of ``out_proj`` summed (`layers.tp_exit`). A decode step
reads and writes the rank's block of the cache in place (``h [B, d_inner
/ tp, n]``, ``conv [B, K-1, d_inner / tp]``: the reference's
`ssm_cache_spec`).
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import P, copy_to_region, reduce_from_region
from repro_torch.kernels.ssm_scan import ssm_scan as kss
from repro_torch.models.layers import (init_linear, normal_init, silu,
                                       tp_axis, tp_enter, tp_exit)

IMPLS = ("auto", "plain")

#: Plain scans since `reset_plain_calls`.
PLAIN_CALLS: Dict[str, int] = {"ssm_scan": 0}


def reset_plain_calls() -> None:
    for k in PLAIN_CALLS:
        PLAIN_CALLS[k] = 0


class SSMCache(NamedTuple):
    h: torch.Tensor     # [B, d_inner, n] float32 state
    conv: torch.Tensor  # [B, K-1, d_inner] last inputs of the causal conv


class SSM(nn.Module):
    """``in_proj [d, 2 d_inner]``, ``x_proj [d_inner, dt_rank + 2n]``,
    ``dt_w [dt_rank, d_inner]`` and ``out_proj [d_inner, d]`` as
    ``nn.Linear``s (weights stored ``[out, in]``); ``conv_w [K, d_inner]``,
    ``dt_bias [d_inner]``, ``A_log [d_inner, n]`` (``log(-A)``) and ``D
    [d_inner]`` as parameters."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        d, n, K = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
        din = cfg.ssm_expand * d
        dt_rank = max(d // 16, 1)
        dev = gen.device
        self.in_proj = init_linear(gen, d, 2 * din, dtype)
        self.conv_w = nn.Parameter(normal_init(gen, (K, din), dtype,
                                               scale=0.5))
        self.x_proj = init_linear(gen, din, dt_rank + 2 * n, dtype)
        self.dt_w = init_linear(gen, dt_rank, din, dtype)
        self.dt_bias = nn.Parameter(torch.zeros((din,), dtype=dtype,
                                                device=dev))
        # A in (-1, 0): stable decays; stored as log(-A).
        self.A_log = nn.Parameter(torch.log(
            torch.arange(1, n + 1, dtype=torch.float32, device=dev)
            .expand(din, n)).to(dtype))
        self.D = nn.Parameter(torch.ones((din,), dtype=dtype, device=dev))
        self.out_proj = init_linear(gen, din, d, dtype)


def init_ssm(cfg: ModelConfig, gen: torch.Generator,
             dtype: torch.dtype) -> SSM:
    return SSM(cfg, gen, dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv in x's dtype: x ``[B, T, din]``, w ``[K,
    din]``, the K products summed in the reference's order."""
    K, T = w.shape[0], x.shape[1]
    if history is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([history.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for j in range(K):
        out = out + w[j] * xp[:, j:j + T]
    return out


def _elements(params: SSM, x_conv: torch.Tensor, dt_bc: torch.Tensor,
              n: int):
    """Scan elements ``a, b [B, T, din, n]`` and ``C [B, T, n]``, float32,
    from the conv'd inputs."""
    dt_rank = params.dt_w.in_features
    dt_r = dt_bc[..., :dt_rank]
    Bc = dt_bc[..., dt_rank:dt_rank + n].float()
    Cc = dt_bc[..., dt_rank + n:].float()
    dt = F.softplus(params.dt_w(dt_r).float() + params.dt_bias.float())
    A = -torch.exp(params.A_log.float())                  # [din, n]
    a = torch.exp(dt[..., None] * A)                       # [B, T, din, n]
    b = (dt * x_conv.float())[..., None] * Bc[..., None, :]
    return a, b, Cc


def _scan(a: torch.Tensor, b: torch.Tensor, impl: str) -> torch.Tensor:
    """The recurrence over ``a, b [B, T, D]``: the kernel on the card
    under ``impl="auto"``, else the plain version; under ``"auto"`` both
    count as the kernel (`repro_torch.counting`)."""
    region = kss.counted_scan(a) if impl == "auto" \
        else contextlib.nullcontext()
    with region:
        if impl == "auto" and a.is_cuda:
            return kss.ssm_scan_cuda(a, b)
        PLAIN_CALLS["ssm_scan"] += 1
        return kss.ssm_scan_plain(a, b)


def _out(params: SSM, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    y = y + params.D.float() * xc.float()
    return params.out_proj((y * silu(z.float())).to(dtype))


def _dt_bc(params: SSM, xc: torch.Tensor, axis: Optional[str]
           ) -> torch.Tensor:
    """``x_proj`` of the conv'd inputs: under tensor parallelism the
    ranks' partial products summed over the axis (before the softplus),
    the sum then used by each rank on its own channels."""
    dt_bc = params.x_proj(xc)
    if axis is None:
        return dt_bc
    return copy_to_region(reduce_from_region(dt_bc, axis), axis)


def ssm_layer(params: SSM, x: torch.Tensor, cfg: ModelConfig, *,
              cache: Optional[SSMCache] = None, impl: str = "auto",
              seq_split: bool = False, entered: bool = False
              ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """x ``[B, T, d]`` -> (y ``[B, T, d]``, the cache after the step).
    Prefill when ``cache`` is None (returns no cache, as the reference);
    else one decode step (T == 1) that writes ``cache`` in place. Under
    tensor parallelism (module docstring) ``x`` and the output are the
    residual stream as the rank holds it (its block of T where
    ``seq_split``), or ``x`` is the region's input already where
    ``entered`` (a hybrid block enters once for attention and the
    SSM)."""
    if impl not in IMPLS:
        raise ValueError(f"ssm impl {impl!r}; one of {IMPLS}")
    axis = tp_axis(params)
    if axis is not None and not entered:
        x = tp_enter(x, axis, seq_split)
    B, T, _ = x.shape
    n = cfg.ssm_state
    din = params.D.shape[0]
    xz = params.in_proj(x)
    xs, z = xz[..., :din], xz[..., din:]

    if cache is not None:
        xc = silu(_causal_conv(xs, params.conv_w, history=cache.conv))
        a, b, Cc = _elements(params, xc, _dt_bc(params, xc, axis), n)
        h = a[:, 0] * cache.h + b[:, 0]                      # [B, din, n]
        y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None, :]
        new_conv = torch.cat([cache.conv, xs.to(cache.conv.dtype)], dim=1)
        cache.h.copy_(h)
        cache.conv.copy_(new_conv[:, 1:])
        return _exit(params, _out(params, y, xc, z, x.dtype), axis,
                     seq_split), cache

    xc = silu(_causal_conv(xs, params.conv_w))
    dt_bc = _dt_bc(params, xc, axis)
    CT = min(cfg.scan_chunk, T)
    h0 = torch.zeros((B, din * n), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, T, CT):
        ct = min(CT, T - t0)
        a, b, Cc = _elements(params, xc[:, t0:t0 + ct], dt_bc[:, t0:t0 + ct],
                             n)
        a = a.reshape(B, ct, din * n)
        b = b.reshape(B, ct, din * n)
        b[:, 0] += a[:, 0] * h0
        hs = _scan(a, b, impl)
        del a, b
        ys.append(torch.einsum("btdn,btn->btd", hs.view(B, ct, din, n), Cc))
        h0 = hs[:, -1]
    return _exit(params, _out(params, torch.cat(ys, dim=1), xc, z, x.dtype),
                 axis, seq_split), None


def _exit(params: SSM, y: torch.Tensor, axis: Optional[str],
          seq_split: bool) -> torch.Tensor:
    """The layer's output into the residual stream: under tensor
    parallelism the ranks' partial products of ``out_proj`` summed."""
    return y if axis is None else tp_exit(y, axis, seq_split)


def init_ssm_cache(cfg: ModelConfig, B: int, dtype: torch.dtype,
                   device) -> SSMCache:
    din = cfg.ssm_expand * cfg.d_model
    return SSMCache(
        h=torch.zeros((B, din, cfg.ssm_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((B, cfg.ssm_conv - 1, din), dtype=dtype,
                         device=device))


def ssm_cache_spec(cfg: ModelConfig, batch_spec=("data",)) -> SSMCache:
    """An SSM cache's layout on a mesh: the batch over ``batch_spec``, the
    inner width over "model"."""
    return SSMCache(h=P(batch_spec, "model", None),
                    conv=P(batch_spec, None, "model"))
