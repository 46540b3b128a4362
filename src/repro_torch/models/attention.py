"""GQA attention: init, prefill (blockwise, causal or not), decode against
a KV cache, sliding-window ring caches, and the encoder-decoder's
cross-attention against an encoder memory. The JAX package's
``repro.models.attention`` on tensors.

Q heads are padded up to a multiple of ``tp_size`` with zero-weight heads
when the architecture's head count does not divide it (``cfg.padded_heads``;
their ``wq`` columns and ``wo`` rows are zero, so outputs are exact).

Where attention runs (``impl``):

* ``"auto"`` — the CUDA kernels on a CUDA tensor, the plain versions on a
  CPU tensor. Prefill runs the flash kernel
  (`kernels.flash_attention.flash_attention_cuda`, the ``wgmma`` kernel at
  bf16 prefill widths, with the layer's sliding window if it has one) on
  the real heads ``q[:, :, :num_heads]`` against
  the un-expanded k/v, and pads the padded heads back with zeros: exact,
  since their ``wo`` rows are zero and the kernel's head map
  ``i // (Hq / Hkv)`` is `expand_kv_heads`' map on the real heads. Decode
  runs the split-K decode kernel on the cache in place
  (`kernels.flash_attention.decode_attention_cuda`), reading the cache's
  ``length`` from device memory; a windowed layer's cache is a ring that
  holds only in-window keys, so the kernel needs no window there. Both
  kernels take the config's logit softcap (grok's 30), applied to the
  scaled scores before the masks as the reference does. A head_dim
  without a kernel instance raises on the card: nothing gives way to the
  plain versions.
* ``"plain"`` — `blockwise_causal_attention` and `decode_attention` on any
  device (the reference's algorithms; each call adds one to
  `PLAIN_CALLS`).

`update_cache` writes the new step in place (the reference returns new
buffers): a linear cache at ``min(length, S - 1)``, a windowed one as a
ring at ``length % S``, with the index computed on the device.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import counting
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import P
from repro_torch.kernels.flash_attention import flash_attention as kfa
from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import init_linear

_NEG_INF = -1e30
IMPLS = ("auto", "plain")

#: Calls of the plain attention versions since `reset_plain_calls`.
PLAIN_CALLS: Dict[str, int] = {"blockwise_causal_attention": 0,
                               "decode_attention": 0, "chunked_cross": 0}


def reset_plain_calls() -> None:
    for k in PLAIN_CALLS:
        PLAIN_CALLS[k] = 0


class KVCache(NamedTuple):
    k: torch.Tensor       # [B, Hkv, S, Dh]
    v: torch.Tensor       # [B, Hkv, S, Dh]
    length: torch.Tensor  # [] int32 — number of steps written


class Attention(nn.Module):
    """``wq [d, Hq_pad * Dh]``, ``wk``/``wv [d, Hkv * Dh]``, ``wo [Hq_pad
    * Dh, d]`` as ``nn.Linear``s (weights stored ``[out, in]``), with the
    QKV bias where the config has one."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.padded_heads, cfg.num_kv_heads
        self.wq = init_linear(gen, d, hq * dh, dtype, bias=cfg.qkv_bias)
        self.wk = init_linear(gen, d, hkv * dh, dtype, bias=cfg.qkv_bias)
        self.wv = init_linear(gen, d, hkv * dh, dtype, bias=cfg.qkv_bias)
        self.wo = init_linear(gen, hq * dh, d, dtype)
        if cfg.num_heads != hq:
            # Zero the padded heads so wo ignores them exactly.
            mask = (torch.arange(hq, device=gen.device) < cfg.num_heads
                    ).repeat_interleave(dh).to(dtype)
            with torch.no_grad():
                self.wq.weight.mul_(mask[:, None])
                self.wo.weight.mul_(mask[None, :])


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype: torch.dtype) -> Attention:
    return Attention(cfg, gen, dtype)


def _project_qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x [B, T, d] -> q [B, T, Hq, Dh], k/v [B, T, Hkv, Dh] (rope applied)."""
    B, T, _ = x.shape
    dh = cfg.resolved_head_dim
    q = params.wq(x).reshape(B, T, cfg.padded_heads, dh)
    k = params.wk(x).reshape(B, T, cfg.num_kv_heads, dh)
    v = params.wv(x).reshape(B, T, cfg.num_kv_heads, dh)
    if cfg.rope_mode == "mrope":
        q, k = rope_lib.apply_mrope(q, k, positions, cfg.rope_theta,
                                    cfg.mrope_sections)
    else:
        q, k = rope_lib.apply_rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    if cap > 0.0:
        return cap * torch.tanh(s / cap)
    return s


def expand_kv_heads(k: torch.Tensor, v: torch.Tensor, hq: int,
                    hq_orig: int):
    """Expand ``[B, T, Hkv, Dh]`` k/v to ``hq`` heads by the reference's
    static index map: q head i reads kv head ``min(i // g, Hkv - 1)`` with
    ``g = hq_orig // Hkv``, so padded heads read the last kv head."""
    hkv = k.shape[2]
    if hkv == hq:
        return k, v
    g = max(hq_orig // hkv, 1)
    idx = torch.tensor([min(i // g, hkv - 1) for i in range(hq)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def blockwise_causal_attention(q, k, v, *, chunk: int, window: int = 0,
                               softcap: float = 0.0, causal: bool = True):
    """Flash-style attention with a static block loop: q/k/v ``[B, T, H,
    Dh]`` (kv pre-expanded to H heads, `expand_kv_heads`), blocks above the
    diagonal or out of the window skipped, an online softmax in float32.
    The products sum in float32 over operands in the inputs' dtype (the
    softmax weights rounded to it before the second), as the reference's
    ``preferred_element_type=float32`` products do."""
    PLAIN_CALLS["blockwise_causal_attention"] += 1
    if counting.shapes_only(q):
        return torch.empty_like(q)   # counted by the kernel's formula
    B, T, H, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    nq = -(-T // chunk)
    pad = nq * chunk - T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    qb = q.reshape(B, nq, chunk, H, Dh).permute(0, 3, 1, 2, 4)
    kb = k.reshape(B, nq, chunk, H, Dh).permute(0, 3, 1, 2, 4)
    vb = v.reshape(B, nq, chunk, H, Dh).permute(0, 3, 1, 2, 4)

    pos = torch.arange(chunk, device=q.device)
    out_blocks = []
    for qi in range(nq):
        acc = torch.zeros((B, H, chunk, Dh), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, H, chunk, 1), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, chunk, 1), dtype=torch.float32,
                        device=q.device)
        lo = 0
        if window > 0:
            lo = max(0, qi - (window + chunk - 1) // chunk)
        hi = qi + 1 if causal else nq
        for ki in range(lo, hi):
            s = (qb[:, :, qi].float() @ kb[:, :, ki].float().mT) * scale
            s = _softcap(s, softcap)
            qpos = qi * chunk + pos[:, None]
            kpos = ki * chunk + pos[None, :]
            mask = kpos < T  # key padding
            if causal:
                mask = mask & (qpos >= kpos)
            if window > 0:
                mask = mask & (qpos - kpos < window)
            s = torch.where(mask, s, s.new_tensor(_NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(qb.dtype).float() @ vb[:, :, ki].float()
            m = m_new
        out_blocks.append(acc / torch.clamp(l, min=1e-30))
    out = torch.stack(out_blocks, dim=2)  # [B, H, nq, C, Dh]
    out = out.permute(0, 2, 3, 1, 4).reshape(B, nq * chunk, H, Dh)
    return out[:, :T].to(q.dtype)


def decode_attention(q: torch.Tensor, cache: KVCache, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-token decode, plain: q ``[B, Tq, Hq, Dh]`` against the cache,
    valid rows ``pos < length`` (a windowed cache is a ring whose resident
    rows are all in the window)."""
    PLAIN_CALLS["decode_attention"] += 1
    out = kfa.decode_attention_plain(q.transpose(1, 2), cache.k, cache.v,
                                     cache.length, softcap=softcap)
    return out.transpose(1, 2)


def init_kv_cache(cfg: ModelConfig, B: int, S: int, dtype: torch.dtype,
                  device) -> KVCache:
    dh = cfg.resolved_head_dim
    shape = (B, cfg.num_kv_heads, S, dh)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def kv_cache_spec(cfg: ModelConfig, batch_spec=("data",)) -> KVCache:
    """A KV cache's layout on a mesh: the batch over ``batch_spec`` and the
    kv heads over "model" where they divide it (`ModelConfig
    .shard_kv_heads`); ``length`` replicated."""
    kv = "model" if cfg.shard_kv_heads else None
    return KVCache(k=P(batch_spec, kv, None, None),
                   v=P(batch_spec, kv, None, None), length=P())


def update_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 *, window: int = 0) -> KVCache:
    """Write one step (k/v ``[B, 1, Hkv, Dh]``) into the buffers in place —
    a ring at ``length % S`` if windowed, else at ``min(length, S - 1)`` —
    and return the cache with ``length + 1``."""
    S = cache.k.shape[2]
    length = cache.length.reshape(1).long()
    idx = length % S if window > 0 else torch.clamp(length, max=S - 1)
    cache.k.index_copy_(2, idx, k_new.transpose(1, 2).to(cache.k.dtype))
    cache.v.index_copy_(2, idx, v_new.transpose(1, 2).to(cache.v.dtype))
    return KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


def _pad_heads(ctx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """ctx ``[B, T, num_heads, Dh]`` -> ``[B, T, padded_heads, Dh]``, the
    padded heads zero."""
    extra = cfg.padded_heads - cfg.num_heads
    return F.pad(ctx, (0, 0, 0, extra)) if extra else ctx


def _region(impl: str, region):
    """Under ``impl="auto"`` (where the card runs the kernel), the kernel
    wrapper's count region (``kfa.counted_*``) of one call: the kernel
    and the plain version count alike, as the kernel's formula.
    ``"plain"`` (training) counts the plain version's operations."""
    return region if impl == "auto" else contextlib.nullcontext()


def attention_layer(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, *,
                    cache: Optional[KVCache] = None, window: int = 0,
                    causal: bool = True, impl: str = "auto"
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full attention sublayer. Returns (output ``[B, T, d]``, updated
    cache): prefill when ``cache`` is None, else one decode step (T == 1)
    against the cache. ``impl``: see the module docstring."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; one of {IMPLS}")
    kernel = impl == "auto" and x.is_cuda
    q, k, v = _project_qkv(params, x, cfg, positions)
    H = cfg.num_heads
    B, T, _, dh = q.shape
    if cache is None:
        new_cache = None
        qh, kh, vh = (t.transpose(1, 2) for t in (q[:, :, :H], k, v))
        with _region(impl, kfa.counted_flash(qh, kh, causal, window)):
            if kernel:
                o = kfa.flash_attention_cuda(
                    qh.contiguous(), kh.contiguous(), vh.contiguous(),
                    causal=causal, window=window,
                    softcap=cfg.attn_logit_softcap)
                ctx = _pad_heads(o.transpose(1, 2), cfg)
            else:
                ke, ve = expand_kv_heads(k, v, cfg.padded_heads, H)
                ctx = blockwise_causal_attention(
                    q, ke, ve, chunk=min(cfg.attn_chunk, x.shape[1]),
                    window=window, softcap=cfg.attn_logit_softcap,
                    causal=causal)
            # One layout out of every path, so that what follows counts
            # alike (`repro_torch.counting`).
            ctx = ctx.contiguous()
    else:
        new_cache = update_cache(cache, k, v, window=window)
        # Decode runs on the real heads only: the padded q heads have zero
        # wq/wo rows, and slicing keeps the grouped [Hkv, g] shape.
        q_att = q[:, :, :H]
        qh = q_att.transpose(1, 2)
        with _region(impl, kfa.counted_decode(qh, new_cache.k)):
            if kernel:
                o = kfa.decode_attention_cuda(
                    qh.contiguous(), new_cache.k,
                    new_cache.v, new_cache.length,
                    softcap=cfg.attn_logit_softcap)
                ctx = o.transpose(1, 2)
            else:
                ctx = decode_attention(q_att, new_cache, window=window,
                                       softcap=cfg.attn_logit_softcap)
            ctx = _pad_heads(ctx, cfg).contiguous()
    B, T = x.shape[:2]
    return params.wo(ctx.reshape(B, T, -1)), new_cache


def chunked_cross(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  chunk: int) -> torch.Tensor:
    """Non-causal cross-attention, plain: q ``[B, T, H, Dh]`` against the
    memory's k/v ``[B, S, H, Dh]`` (pre-expanded to H heads,
    `expand_kv_heads`), in chunks of ``chunk`` queries so the scores stay
    O(chunk * S). Both products in float32 (q, k, p and v widened), as
    the reference's ``_chunked_cross``; the output in q's dtype."""
    PLAIN_CALLS["chunked_cross"] += 1
    if counting.shapes_only(q):
        return torch.empty_like(q)   # counted by the kernel's formula
    T, Dh = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(Dh)
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, T, chunk):
        s = torch.einsum("bqhd,bshd->bhqs", q[:, q0:q0 + chunk].float(),
                         kf) * scale
        outs.append(torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, -1),
                                 vf))
    return torch.cat(outs, dim=1).to(q.dtype)


def cross_attention_layer(params: Attention, x: torch.Tensor,
                          memory: torch.Tensor, cfg: ModelConfig, *,
                          impl: str = "auto") -> torch.Tensor:
    """Encoder-decoder cross-attention sublayer: q from ``x [B, T, d]``,
    k/v from ``memory [B, S, d]``, through the layer's own projections
    with no RoPE and no QKV bias (even where the config has one), as the
    reference does; non-causal. The memory's k/v are projected anew on
    every call (in every layer of every decode step), as in the
    reference. Returns ``[B, T, d]``. ``impl``: see the module
    docstring."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; one of {IMPLS}")
    B, T, _ = x.shape
    S = memory.shape[1]
    dh, H = cfg.resolved_head_dim, cfg.num_heads
    q = F.linear(x, params.wq.weight).reshape(B, T, cfg.padded_heads, dh)
    k = F.linear(memory, params.wk.weight).reshape(B, S, cfg.num_kv_heads, dh)
    v = F.linear(memory, params.wv.weight).reshape(B, S, cfg.num_kv_heads, dh)
    qh, kh, vh = (t.transpose(1, 2) for t in (q[:, :, :H], k, v))
    with _region(impl, kfa.counted_flash(qh, kh, False)):
        if impl == "auto" and x.is_cuda:
            o = kfa.flash_attention_cuda(
                qh.contiguous(), kh.contiguous(), vh.contiguous(),
                causal=False)
            ctx = _pad_heads(o.transpose(1, 2), cfg)
        else:
            ke, ve = expand_kv_heads(k, v, cfg.padded_heads, H)
            ctx = chunked_cross(q, ke, ve, chunk=min(cfg.attn_chunk, T))
        ctx = ctx.contiguous()
    return params.wo(ctx.reshape(B, T, -1))
