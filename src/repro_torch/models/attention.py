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

Tensor parallelism (a module whose ``tp_axis`` names the mesh axis,
`launch.sharding.shard_tensor_parallel`): the rank holds the reference's
"model" block of every weight: its block of the padded q heads (``wq``,
``bq`` and ``wo``'s rows), and its block of the kv heads where
``cfg.shard_kv_heads`` holds and they split over the mesh's axis, else
``wk``/``wv`` whole. Its q heads read kv heads by the reference's map
(`head_map`: padded heads read the last kv head), restated on the rank:
at ``tp_size`` 16 and a "model" of 2, qwen2-1.5b's rank 0 holds q heads
0-7 on kv heads 0 (six) and 1 (two), rank 1 heads 8-15 (four real) on kv
head 1. The layer enters its region from the residual stream and leaves
it with the partial products of ``wo`` summed (`layers.tp_enter`,
`layers.tp_exit`; a sequence-parallel stream is gathered and scattered
along T). A decode cache is the rank's block as the decode plan lays it
out, read in place: its kv heads, or the whole cache where the kv heads
are replicated and the cache is short, or its block of the sequence
where the plan splits the cache's sequence over the axis
(`caches_split_along_sequence`): then every rank runs every real q head
against its rows, and the ranks' rows merge by their log-sum-exps. A
windowed layer's ring splits so too where it has the plan's rows (a
window at least as long as the caches); a decode step needs no window
mask there, as the reference's has none: a ring holds in-window keys
only. The encoder-decoder's cross-attention runs the rank's q heads
against the k/v of its kv heads, projected from the memory
(`cross_attention_layer`).
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
from repro_torch.distributed import P, all_gather, axis_index, axis_size
from repro_torch.kernels.flash_attention import flash_attention as kfa
from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import (init_linear, tp_axis, tp_enter,
                                       tp_exit, tp_weight)

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


def head_map(cfg: ModelConfig) -> Tuple[int, ...]:
    """The reference's static q head -> kv head map (`expand_kv_heads`):
    q head ``i`` of the padded heads reads ``min(i // g, Hkv - 1)``, ``g =
    num_heads // Hkv``."""
    hkv = cfg.num_kv_heads
    g = max(cfg.num_heads // hkv, 1)
    return tuple(min(i // g, hkv - 1) for i in range(cfg.padded_heads))


class Heads(NamedTuple):
    """The heads a rank holds: q heads ``[q0, q0 + n_q)`` of the padded
    heads, of which the first ``real`` are real; ``n_kv`` kv heads, its
    block of them where ``kv_split``, else all; ``map``: each held q
    head's kv head among those held. One device (or a module holding its
    weights whole) holds them all."""
    q0: int
    n_q: int
    real: int
    n_kv: int
    kv_split: bool
    map: Tuple[int, ...]


def rank_heads(params: Attention, cfg: ModelConfig) -> Heads:
    """The heads of this rank's `Attention` (all of them where it is not
    tensor-parallel), from its weights' shapes and the rank's coordinate
    on its ``tp_axis``."""
    dh = cfg.resolved_head_dim
    n_q, n_kv = (params.wq.weight.shape[0] // dh,
                 params.wk.weight.shape[0] // dh)
    axis = tp_axis(params)
    r = axis_index(axis) if axis is not None else 0
    q0 = r * n_q
    split = n_kv < cfg.num_kv_heads
    kv0 = r * n_kv if split else 0
    full = head_map(cfg)
    return Heads(q0=q0, n_q=n_q, real=max(0, min(cfg.num_heads - q0, n_q)),
                 n_kv=n_kv, kv_split=split,
                 map=tuple(full[q0 + j] - kv0 for j in range(n_q)))


def _grouped(hmap: Tuple[int, ...], n_kv: int) -> bool:
    """Whether q head ``j`` of ``hmap`` reads kv head ``j // (len / n_kv)``
    of ``n_kv``: the kernels' own map, which needs no map passed."""
    n = len(hmap)
    return n > 0 and n % n_kv == 0 and hmap == tuple(
        j // (n // n_kv) for j in range(n))


def _project_qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, heads: Heads):
    """x [B, T, d] -> q [B, T, Hq, Dh], k/v [B, T, Hkv, Dh] (rope applied):
    the rank's heads (`rank_heads`; all of them on one device), where
    under tensor parallelism ``wk`` and ``wv`` held whole feed the rank's
    own heads (`layers.tp_weight`)."""
    B, T, _ = x.shape
    dh = cfg.resolved_head_dim
    axis = tp_axis(params)
    whole_kv = axis is not None and not heads.kv_split
    q = params.wq(x).reshape(B, T, heads.n_q, dh)
    k, v = (F.linear(x, tp_weight(lin.weight, axis, whole_kv),
                     None if lin.bias is None
                     else tp_weight(lin.bias, axis, whole_kv))
            .reshape(B, T, heads.n_kv, dh) for lin in (params.wk, params.wv))
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
                     softcap: float = 0.0, head_map=None,
                     return_lse: bool = False):
    """Single-token decode, plain: q ``[B, Tq, Hq, Dh]`` against the cache,
    valid rows ``pos < length`` (a windowed cache is a ring whose resident
    rows are all in the window); q head ``i`` against kv head
    ``head_map[i]`` where a map is given. ``return_lse``: also the rows'
    log-sum-exps ``[B, Hq, Tq]`` (`kfa.decode_attention_plain`)."""
    PLAIN_CALLS["decode_attention"] += 1
    out = kfa.decode_attention_plain(q.transpose(1, 2), cache.k, cache.v,
                                     cache.length, softcap=softcap,
                                     head_map=head_map,
                                     return_lse=return_lse)
    if return_lse:
        return out[0].transpose(1, 2), out[1]
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


def _pad_heads(ctx: torch.Tensor, cfg: ModelConfig,
               n_q: Optional[int] = None) -> torch.Tensor:
    """ctx ``[B, T, real heads, Dh]`` -> ``[B, T, n_q, Dh]`` (default all
    ``padded_heads``), the padded heads zero."""
    extra = (cfg.padded_heads if n_q is None else n_q) - ctx.shape[2]
    return F.pad(ctx, (0, 0, 0, extra)) if extra else ctx


#: The decode plan's word on its KV caches (`caches_split_along_sequence`).
_SEQ_SPLIT: list = []


@contextlib.contextmanager
def caches_split_along_sequence(axis: str, capacity: int):
    """Within the block, a tensor-parallel decode step's KV caches of
    ``capacity`` rows (the decode plan's; not a shorter ring) are split
    along their sequence over ``axis``: the rank holds rows ``[c S', (c
    + 1) S')`` of each, ``c`` its coordinate, ``S' = capacity / size``, as
    the reference lays out the caches of kv heads that do not split over
    "model"."""
    _SEQ_SPLIT.append((axis, capacity))
    try:
        yield
    finally:
        _SEQ_SPLIT.pop()


def _sequence_block(cache: KVCache, window: int):
    """(axis, capacity, first row) where this layer's cache is the rank's
    block of its sequence (`caches_split_along_sequence`), else None."""
    if not _SEQ_SPLIT:
        return None
    axis, S = _SEQ_SPLIT[-1]
    if (window and window < S) or S < 16:
        return None      # a ring shorter than the plan's caches: whole
    n = axis_size(axis)
    if cache.k.shape[2] * n != S:
        raise ValueError(f"a cache block of {cache.k.shape[2]} rows is not "
                         f"1/{n} of {S}")
    return axis, S, axis_index(axis) * cache.k.shape[2]


def update_cache_block(cache: KVCache, k_new: torch.Tensor,
                       v_new: torch.Tensor, *, window: int, capacity: int,
                       first: int) -> KVCache:
    """`update_cache` on the rank's block of a cache split along its
    sequence: rows ``[first, first + S')`` of ``capacity``. The step's row
    (where `update_cache` would write it) is written where this block
    holds it; elsewhere the block's row there is rewritten unchanged, so
    no rank waits on the host. Returns the cache with ``length + 1``."""
    Sb = cache.k.shape[2]
    length = cache.length.reshape(1).long()
    idx = length % capacity if window > 0 else torch.clamp(
        length, max=capacity - 1)
    local = idx - first
    mine = (local >= 0) & (local < Sb)
    local = local.clamp(0, Sb - 1)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        row = new.transpose(1, 2).to(buf.dtype)
        buf.index_copy_(2, local, torch.where(
            mine, row, buf.index_select(2, local)))
    return KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


def _merge_over(o: torch.Tensor, lse: torch.Tensor, axis: str
                ) -> torch.Tensor:
    """Decode rows whose keys lie in several ranks' blocks of a cache: each
    rank's normalised rows ``o [B, H, Tq, Dh]`` and log-sum-exps ``lse
    [B, H, Tq]`` gathered over ``axis`` and weighed by ``exp(lse_r -
    logsumexp_r lse_r)`` in float32 (a rank without keys weighs 0)."""
    os_, ls = all_gather((o.float(), lse), axis)
    total = torch.logsumexp(ls, dim=0)
    w = torch.exp(ls - total)
    return (w[..., None] * os_).sum(dim=0).to(o.dtype)


def _region(impl: str, region):
    """Under ``impl="auto"`` (where the card runs the kernel), the kernel
    wrapper's count region (``kfa.counted_*``) of one call: the kernel
    and the plain version count alike, as the kernel's formula.
    ``"plain"`` (training) counts the plain version's operations."""
    return region if impl == "auto" else contextlib.nullcontext()


def attention_layer(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, *,
                    cache: Optional[KVCache] = None, window: int = 0,
                    causal: bool = True, impl: str = "auto",
                    seq_split: bool = False, entered: bool = False
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full attention sublayer. Returns (output ``[B, T, d]``, updated
    cache): prefill when ``cache`` is None, else one decode step (T == 1)
    against the cache. ``impl``: see the module docstring. Under tensor
    parallelism ``x`` is the residual stream as the rank holds it (its
    block of the sequence where ``seq_split``) and so is the output, or
    ``x`` is the region's input already where ``entered``."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; one of {IMPLS}")
    axis = tp_axis(params)
    if axis is not None and not entered:
        x = tp_enter(x, axis, seq_split)
    kernel = impl == "auto" and x.is_cuda
    heads = rank_heads(params, cfg)
    q, k, v = _project_qkv(params, x, cfg, positions, heads)
    B, T = x.shape[:2]
    if cache is None:
        new_cache = None
        ctx = _prefill_attention(q, k, v, heads, cfg, causal=causal,
                                 window=window, impl=impl, kernel=kernel)
    else:
        ctx, new_cache = _decode_attention_step(
            q, k, v, cache, heads, cfg, axis, window=window, impl=impl,
            kernel=kernel)
    out = params.wo(ctx.reshape(B, T, -1))
    if axis is not None:
        out = tp_exit(out, axis, seq_split)
    return out, new_cache


def _kv_for_kernel(k: torch.Tensor, v: torch.Tensor,
                   hmap: Tuple[int, ...]):
    """The k/v ``[B, T, H', Dh]`` the prefill kernels take for q heads
    reading kv heads ``hmap``: the kv heads themselves where ``hmap`` is
    the kernels' own grouped map over them; else k/v built per q head.
    Those are a tensor-parallel rank's heads whose kv heads are replicated
    (qwen2-1.5b's rank 0 at "model" 2: six q heads on kv head 0, two on
    kv head 1): a prefill's k/v are fresh activations, so building them
    per layer copies no cache."""
    if _grouped(hmap, k.shape[2]):
        return k, v
    idx = torch.tensor(hmap, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _expanded(k: torch.Tensor, v: torch.Tensor, hmap: Tuple[int, ...]):
    """k/v ``[B, T, n_kv, Dh]`` expanded to one head per q head of
    ``hmap`` (the reference's `expand_kv_heads`, restated on a rank's
    heads); k/v themselves where the map is the identity."""
    if hmap == tuple(range(k.shape[2])):
        return k, v
    idx = torch.tensor(hmap, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _prefill_attention(q, k, v, heads: Heads, cfg: ModelConfig, *,
                       causal: bool, window: int, impl: str, kernel: bool
                       ) -> torch.Tensor:
    """Attention over the sequence of the rank's q heads ``q [B, T, n_q,
    Dh]`` against k/v ``[B, T, n_kv, Dh]``. The kernel runs the real heads
    and pads the padded ones with zeros; the plain version runs every
    head on k/v expanded by the map, as the reference does."""
    real, hmap = heads.real, heads.map[:heads.real]
    kk, vk = _kv_for_kernel(k, v, hmap) if real else (k, v)
    qh, kh, vh = (t.transpose(1, 2) for t in (q[:, :, :real], kk, vk))
    with _region(impl, kfa.counted_flash(qh, kh, causal, window)):
        if kernel:
            if real:
                o = kfa.flash_attention_cuda(
                    qh.contiguous(), kh.contiguous(), vh.contiguous(),
                    causal=causal, window=window,
                    softcap=cfg.attn_logit_softcap)
                ctx = _pad_heads(o.transpose(1, 2), cfg, heads.n_q)
            else:
                ctx = torch.zeros_like(q)
        else:
            ke, ve = _expanded(k, v, heads.map)
            ctx = blockwise_causal_attention(
                q, ke, ve, chunk=min(cfg.attn_chunk, q.shape[1]),
                window=window, softcap=cfg.attn_logit_softcap,
                causal=causal)
        # One layout out of every path, so that what follows counts
        # alike (`repro_torch.counting`).
        return ctx.contiguous()


def _decode_call(qh: torch.Tensor, cache: KVCache, length: torch.Tensor,
                 hmap: Tuple[int, ...], cfg: ModelConfig, *, impl: str,
                 kernel: bool, lse: bool = False):
    """One decode call of ``qh [B, H, Tq, Dh]`` against ``cache`` read in
    place with ``length`` keys: the split-K kernel on the card, else the
    plain version; q head ``i`` reads kv head ``hmap[i]`` (passed as a
    map unless it is the kernel's own grouped map)."""
    hm = None if _grouped(hmap, cache.k.shape[1]) else hmap
    with _region(impl, kfa.counted_decode(qh, cache.k, hm)):
        if kernel:
            return kfa.decode_attention_cuda(
                qh.contiguous(), cache.k, cache.v, length,
                softcap=cfg.attn_logit_softcap, head_map=hm, return_lse=lse)
        out = decode_attention(qh.transpose(1, 2), KVCache(
            cache.k, cache.v, length), softcap=cfg.attn_logit_softcap,
            head_map=hm, return_lse=lse)
        return (out[0].transpose(1, 2), out[1]) if lse else \
            out.transpose(1, 2)


def _decode_attention_step(q, k, v, cache: KVCache, heads: Heads,
                           cfg: ModelConfig, axis: Optional[str], *,
                           window: int, impl: str, kernel: bool):
    """One decode step of the rank's q heads against its cache block,
    written in place: ``(ctx [B, 1, n_q, Dh], the cache)``. Decode runs on
    the real heads only: the padded q heads have zero wq/wo rows (the
    reference slices them off too)."""
    seq = None
    if axis is not None and not heads.kv_split:
        seq = _sequence_block(cache, window)
    if seq is None:
        new_cache = update_cache(cache, k, v, window=window)
        qh = q[:, :, :heads.real].transpose(1, 2)
        o = _decode_call(qh, new_cache, new_cache.length,
                         heads.map[:heads.real], cfg, impl=impl,
                         kernel=kernel)
        ctx = o.transpose(1, 2)
    else:
        # The rank holds its block of every kv head's sequence: every
        # real q head runs against it, and the ranks' rows merge.
        _, S, first = seq
        new_cache = update_cache_block(cache, k, v, window=window,
                                       capacity=S, first=first)
        Sb = cache.k.shape[2]
        n = (new_cache.length.clamp(max=S) - first).clamp(0, Sb).to(
            torch.int32)
        H = cfg.num_heads
        q_all = all_gather(q, axis, axis=2, tiled=True)[:, :, :H]
        o, lse = _decode_call(q_all.transpose(1, 2), new_cache, n,
                              head_map(cfg)[:H], cfg, impl=impl,
                              kernel=kernel, lse=True)
        o = _merge_over(o, lse, axis)
        ctx = o[:, heads.q0:heads.q0 + heads.real].transpose(1, 2)
    return _pad_heads(ctx, cfg, heads.n_q).contiguous(), new_cache


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
                          impl: str = "auto", seq_split: bool = False
                          ) -> torch.Tensor:
    """Encoder-decoder cross-attention sublayer: q from ``x [B, T, d]``,
    k/v from ``memory [B, S, d]``, through the layer's own projections
    with no RoPE and no QKV bias (even where the config has one), as the
    reference does; non-causal. The memory's k/v are projected anew on
    every call (in every layer of every decode step), as in the
    reference. Returns ``[B, T, d]``. ``impl``: see the module
    docstring.

    Under tensor parallelism the rank runs its q heads (``wq``
    column-parallel) against the k/v of its kv heads, projected from the
    memory (whole on every rank: `models.transformer` enters the region
    once for every layer) by its block of ``wk``/``wv`` (whole where the
    kv heads do not split, read through the rank's head map), and leaves
    with the partial products of ``wo`` summed; ``x`` and the output are
    the residual stream as the rank holds it (its block of T where
    ``seq_split``)."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; one of {IMPLS}")
    axis = tp_axis(params)
    if axis is not None:
        x = tp_enter(x, axis, seq_split)
    B, T, _ = x.shape
    S = memory.shape[1]
    dh = cfg.resolved_head_dim
    heads = rank_heads(params, cfg)
    whole_kv = axis is not None and not heads.kv_split
    q = F.linear(x, params.wq.weight).reshape(B, T, heads.n_q, dh)
    k, v = (F.linear(memory, tp_weight(lin.weight, axis, whole_kv))
            .reshape(B, S, heads.n_kv, dh) for lin in (params.wk, params.wv))
    real, hmap = heads.real, heads.map[:heads.real]
    kk, vk = _kv_for_kernel(k, v, hmap) if real else (k, v)
    qh, kh, vh = (t.transpose(1, 2) for t in (q[:, :, :real], kk, vk))
    with _region(impl, kfa.counted_flash(qh, kh, False)):
        if impl == "auto" and x.is_cuda:
            if real:
                o = kfa.flash_attention_cuda(
                    qh.contiguous(), kh.contiguous(), vh.contiguous(),
                    causal=False)
                ctx = _pad_heads(o.transpose(1, 2), cfg, heads.n_q)
            else:
                ctx = torch.zeros_like(q)
        else:
            ke, ve = _expanded(k, v, heads.map)
            ctx = chunked_cross(q, ke, ve, chunk=min(cfg.attn_chunk, T))
        ctx = ctx.contiguous()
    out = params.wo(ctx.reshape(B, T, -1))
    return out if axis is None else tp_exit(out, axis, seq_split)
