"""Residual blocks and the heterogeneous layer schedule.

The reference stacks each run of identical layers and `lax.scan`s over it;
the port keeps a run as an ``nn.ModuleList`` of blocks and loops over it.
A run's decode caches are stacked as in the reference (``[count, ...]``
leading dim), and each layer reads and writes its slice in place.

All five kinds are ported: ``dense``, ``hybrid`` and ``moe`` (attention
and an MLP, an SSM beside attention, or an MoE layer), and the xLSTM
kinds ``mlstm`` and ``slstm`` (a norm and the recurrent layer, no
attention: their run caches are the recurrent state alone).

A tensor-parallel dense or hybrid block (``tp_axis`` set by
`launch.sharding.shard_tensor_parallel`) is Megatron's: each of its
sublayers enters its region from the residual stream and leaves it with
the partial products summed (`layers.tp_enter`, `layers.tp_exit`). In
train and prefill the stream may be sequence-parallel (``seq_split``:
the rank holds its block of T, the reference's ``residual_spec``): the
norms run on the block, the sublayers gather T before their column
products and scatter it after their row products. Decode (T = 1) keeps
the stream whole on every rank, with an all-reduce after each row
product, as the reference's decode step has no residual spec. A hybrid
block's attention and SSM enter their regions from the same normed input
(one gather), and each leaves on its own: ``ln_ssm`` normalises the
SSM's whole ``d``-wide output before the average.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import P, map_specs
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import init_rms_norm, rms_norm, tp_axis, \
    tp_enter, tp_weight


@dataclasses.dataclass(frozen=True)
class Run:
    kind: str          # dense | moe | hybrid | mlstm | slstm
    count: int
    window: int        # 0 = full attention (attention kinds only)
    first_layer: int


def layer_schedule(cfg: ModelConfig) -> List[Run]:
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            kind = "slstm" if i in cfg.slstm_layers else "mlstm"
            window = 0
        elif cfg.family == "hybrid":
            kind = "hybrid"
            window = 0 if i in cfg.global_layers else cfg.sliding_window
        elif cfg.num_experts:
            kind, window = "moe", cfg.sliding_window
        else:
            kind, window = "dense", cfg.sliding_window
        kinds.append((kind, window))
    runs: List[Run] = []
    for i, kw in enumerate(kinds):
        if runs and (runs[-1].kind, runs[-1].window) == kw:
            runs[-1] = dataclasses.replace(runs[-1],
                                           count=runs[-1].count + 1)
        else:
            runs.append(Run(kind=kw[0], count=1, window=kw[1],
                            first_layer=i))
    return runs


ATTENTION_KINDS = ("dense", "hybrid", "moe")
XLSTM_KINDS = ("mlstm", "slstm")


def _check_kind(kind: str) -> None:
    if kind not in ATTENTION_KINDS + XLSTM_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


class Block(nn.Module):
    """A pre-norm block: ``ln1``, ``attn``, ``ln2``, ``mlp`` (``moe`` in
    its place in an MoE block); a hybrid block also ``ssm`` and
    ``ln_ssm``; an xLSTM block ``ln1`` and ``mlstm`` or ``slstm``."""

    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        _check_kind(kind)
        d = cfg.d_model
        self.ln1 = init_rms_norm(d, dtype, gen.device)
        if kind == "mlstm":
            self.mlstm = xlstm_lib.init_mlstm(cfg, gen, dtype)
            return
        if kind == "slstm":
            self.slstm = xlstm_lib.init_slstm(cfg, gen, dtype)
            return
        self.attn = attn_lib.init_attention(cfg, gen, dtype)
        self.ln2 = init_rms_norm(d, dtype, gen.device)
        if kind == "moe":
            self.moe = moe_lib.init_moe(cfg, gen, dtype)
        else:
            self.mlp = mlp_lib.init_mlp(gen, d, cfg.d_ff, dtype)
        if kind == "hybrid":
            self.ssm = ssm_lib.init_ssm(cfg, gen, dtype)
            self.ln_ssm = init_rms_norm(d, dtype, gen.device)


def init_block(cfg: ModelConfig, kind: str, gen: torch.Generator,
               dtype: torch.dtype) -> Block:
    return Block(cfg, kind, gen, dtype)


def apply_block(params: Block, x: torch.Tensor, cfg: ModelConfig, kind: str,
                *, positions: torch.Tensor, window: int, cache=None,
                causal: bool = True, impl: str = "auto",
                seq_split: bool = False):
    """Pre-norm residual block. Returns (x, new_cache, aux_loss): an MoE
    block's load-balance loss (a float32 scalar tensor), 0.0 for the
    other kinds. A hybrid block (Hymba) runs
    attention and the SSM on the same normed input and averages them,
    the SSM output normed first; ``impl`` says where both run (and the
    mLSTM's chunk scan). An xLSTM block adds its layer's output to the
    residual; ``positions`` and ``window`` are unused there.
    ``seq_split``: a tensor-parallel block's residual stream is the rank's
    block of the sequence (module docstring); ``positions`` are those of
    the whole sequence."""
    _check_kind(kind)
    axis = tp_axis(params)
    if axis is not None and kind not in ("dense", "hybrid"):
        raise ValueError(f"tensor parallelism covers the dense and hybrid "
                         f"blocks, not {kind!r}")
    # A norm on the rank's block of T: its gradient sums the ranks' parts.
    ln = lambda w: tp_weight(w, axis, seq_split)  # noqa: E731
    h = rms_norm(x, ln(params.ln1), cfg.rmsnorm_eps)
    if kind == "mlstm":
        y, new_cache = xlstm_lib.mlstm_layer(params.mlstm, h, cfg,
                                             cache=cache, impl=impl)
        return x + y, new_cache, 0.0
    if kind == "slstm":
        y, new_cache = xlstm_lib.slstm_layer(params.slstm, h, cfg,
                                             cache=cache)
        return x + y, new_cache, 0.0
    attn_cache = cache["attn"] if cache is not None else None
    # A hybrid block's two mixers enter their regions from one input.
    entered = axis is not None and kind == "hybrid"
    if entered:
        h = tp_enter(h, axis, seq_split)
    a, new_attn_cache = attn_lib.attention_layer(
        params.attn, h, cfg, positions, cache=attn_cache, window=window,
        causal=causal, impl=impl, seq_split=seq_split, entered=entered)
    new_cache = None if cache is None else dict(attn=new_attn_cache)
    if kind == "hybrid":
        s, new_ssm_cache = ssm_lib.ssm_layer(
            params.ssm, h, cfg, cache=cache["ssm"] if cache is not None
            else None, impl=impl, seq_split=seq_split, entered=entered)
        x = x + 0.5 * (a + rms_norm(s, ln(params.ln_ssm), cfg.rmsnorm_eps))
        if cache is not None:
            new_cache["ssm"] = new_ssm_cache
    else:
        x = x + a
    h2 = rms_norm(x, ln(params.ln2), cfg.rmsnorm_eps)
    aux = 0.0
    if kind == "moe":
        m, aux = moe_lib.moe_layer(params.moe, h2, cfg)
    else:
        m = mlp_lib.mlp(params.mlp, h2, seq_split=seq_split)
    return x + m, new_cache, aux


def init_run_cache(cfg: ModelConfig, run: Run, B: int, S: int,
                   dtype: torch.dtype, device):
    """A run's decode caches, stacked: ``attn`` = `KVCache` with ``k``/``v``
    ``[count, B, Hkv, S', Dh]`` and ``length`` ``[count]``, where ``S'`` is
    the window for a windowed run (a ring) and ``S`` otherwise (a dense
    or MoE run holds nothing else); a hybrid run also ``ssm`` = `SSMCache`
    with ``h [count, B, d_inner, n]`` (float32) and ``conv [count, B, K-1,
    d_inner]``. An xLSTM run's cache is its state alone, as in the
    reference: `MLSTMCache` (``C [count, B, H, dh, dh]``, ``n``, ``conv``)
    or `SLSTMCache` (``c``, ``n``, ``h``, ``m``, each ``[count, B, d]``),
    and ``S`` is unused."""
    _check_kind(run.kind)

    def stack(one):
        return type(one)(*(t.expand((run.count,) + t.shape).clone()
                           for t in one))
    if run.kind == "mlstm":
        return stack(xlstm_lib.init_mlstm_cache(cfg, B, dtype, device))
    if run.kind == "slstm":
        return stack(xlstm_lib.init_slstm_cache(cfg, B, device))
    cache = dict(attn=stack(attn_lib.init_kv_cache(
        cfg, B, S if run.window == 0 else min(S, run.window), dtype,
        device)))
    if run.kind == "hybrid":
        cache["ssm"] = stack(ssm_lib.init_ssm_cache(cfg, B, dtype, device))
    return cache


def run_cache_spec(cfg: ModelConfig, run: Run, batch_spec=("data",)):
    """A run's cache layout on a mesh (`init_run_cache`'s nesting): each
    layer's (`attention.kv_cache_spec`, `ssm.ssm_cache_spec`,
    `xlstm.mlstm_cache_spec`, `xlstm.slstm_cache_spec`) with the stacked
    layer dimension whole."""
    _check_kind(run.kind)
    if run.kind == "mlstm":
        base = xlstm_lib.mlstm_cache_spec(cfg, batch_spec)
    elif run.kind == "slstm":
        base = xlstm_lib.slstm_cache_spec(cfg, batch_spec)
    else:
        base = dict(attn=attn_lib.kv_cache_spec(cfg, batch_spec))
        if run.kind == "hybrid":
            base["ssm"] = ssm_lib.ssm_cache_spec(cfg, batch_spec)
    return map_specs(lambda spec: P(None, *spec), base)


def layer_cache(run_cache, li: int):
    """Layer ``li``'s slice of a stacked run cache (views, not copies)."""
    if not isinstance(run_cache, dict):  # an xLSTM run's state
        return type(run_cache)(*(t[li] for t in run_cache))
    c = run_cache["attn"]
    out = dict(attn=attn_lib.KVCache(c.k[li], c.v[li], c.length[li]))
    if "ssm" in run_cache:
        s = run_cache["ssm"]
        out["ssm"] = ssm_lib.SSMCache(s.h[li], s.conv[li])
    return out
