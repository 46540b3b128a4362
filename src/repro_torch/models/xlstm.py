"""xLSTM blocks (PyTorch): the chunkwise-parallel mLSTM (matrix memory)
and the sequential sLSTM (scalar memory with recurrent gate mixing). The
JAX package's ``repro.models.xlstm`` on tensors, with its documented
deviations kept: the mLSTM's gates are sigmoid-bounded (log-sigmoid
forget and input gates), the sLSTM keeps exponential gating with the
``m`` stabiliser and block-diagonal recurrent weights.

mLSTM prefill runs the reference's chunkwise form: inside each chunk of
``cfg.scan_chunk`` steps the decay matrix and the chunk's writes ``S``,
``zn`` to the running state; across chunks the matrix memory follows
``C_n = F_n C_{n-1} + S_n`` (the normaliser ``n`` likewise). That is the
diagonal linear recurrence of the ``ssm_scan`` kernel, so the port runs
it as one scan over ``[B, nc, H (dh^2 + dh)]`` float32 per layer (the
reference runs a ``lax.scan`` over chunks): `ssm_scan_cuda` on a CUDA
tensor under ``impl="auto"``, `ssm_scan_plain` under ``impl="plain"`` or
on a CPU tensor, counted in ``models.ssm.PLAIN_CALLS``. The pre-chunk
states are the inclusive scan shifted by one chunk, zeros first.

Decode is one step whose state has a fixed size, whatever the length of
the text: the mLSTM writes ``C``, ``n`` and the conv history into the
cache's buffers in place (``C`` by ``mul_`` and ``baddbmm_``, with no
``[B, H, dh, dh]`` temporary), the sLSTM its ``c, n, h, m``.

Sequence parallelism (`_mlstm_sp`): a prefill under ``with mesh:`` on a
rank of a mesh whose "model" axis has ``tp > 1`` ranks, with ``T`` a
multiple of ``tp`` chunks, runs each mLSTM layer sequence-parallel, as
the reference's ``shard_map`` does. The activations stay ``[B_local, T,
d]`` on every rank of "model" (replicated, as the reference's attention
and projections); each rank takes its ``T / tp`` slice, the ranks
exchange their slices' state contributions ``(F, C, n)``
(`_mlstm_chunk_aggregate`, composed by `_mlstm_state_combine`) with
`repro_torch.core.scan.device_exclusive_scan`, each runs the chunked form
from the state ``(C_in, n_in)`` that reaches its slice (its chunk carry
on ``ssm_scan``), and an ``all_gather`` along T gives every rank the whole
``h``: what ``shard_map``'s ``out_specs`` does. It trains under autograd
(the plain chunked form; the slices enter through `pvary`, the exchange's
`ppermute` and the ``all_gather`` have their transposes).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import counting
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scan import device_exclusive_scan
from repro_torch.distributed import P, all_gather, axis_index, pvary
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (_active_mesh, init_linear,
                                       init_rms_norm, normal_init, rms_norm,
                                       silu)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMCache(NamedTuple):
    C: torch.Tensor     # [B, H, dh, dh] float32 matrix memory
    n: torch.Tensor     # [B, H, dh] float32 normaliser
    conv: torch.Tensor  # [B, K-1, din] last inputs of the causal conv


class MLSTM(nn.Module):
    """``in_proj [d, 2 din]``, ``wq``/``wk``/``wv [din, din]``,
    ``w_gates [d, 2H]`` and ``out_proj [din, d]`` as ``nn.Linear``s
    (weights stored ``[out, in]``); ``conv_w [K, din]`` and ``norm_w
    [din]`` as parameters."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        d, H, K = cfg.d_model, cfg.num_heads, cfg.ssm_conv
        din = int(cfg.mlstm_proj_factor * d)
        self.in_proj = init_linear(gen, d, 2 * din, dtype)
        self.conv_w = nn.Parameter(normal_init(gen, (K, din), dtype,
                                               scale=0.5))
        self.wq = init_linear(gen, din, din, dtype)
        self.wk = init_linear(gen, din, din, dtype)
        self.wv = init_linear(gen, din, din, dtype)
        self.w_gates = init_linear(gen, d, 2 * H, dtype)
        self.norm_w = init_rms_norm(din, dtype, gen.device)
        self.out_proj = init_linear(gen, din, d, dtype)


def init_mlstm(cfg: ModelConfig, gen: torch.Generator,
               dtype: torch.dtype) -> MLSTM:
    return MLSTM(cfg, gen, dtype)


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2)  # [B, H, T, dh]


def _chunk_states(Ftot: torch.Tensor, S: torch.Tensor, zn: torch.Tensor,
                  impl: str, state=None):
    """The chunk-to-chunk recurrence from ``state`` (``(C [B, H, dh, dh],
    n [B, H, dh])`` float32, default zero), as one scan: ``Ftot [B, H,
    nc]``, ``S [B, H, nc, dh, dh]``, ``zn [B, H, nc, dh]`` laid out as
    ``a, b [B, nc, H (dh^2 + dh)]``, the state folded into ``b[:, 0]``.
    Returns the pre-chunk states ``Cs [B, H, nc, dh, dh]``, ``ns [B, H,
    nc, dh]`` and the final ``(C, n)``."""
    B, H, nc, dh = zn.shape
    w = dh * dh + dh
    b = torch.cat([S.transpose(1, 2).flatten(-2), zn.transpose(1, 2)],
                  dim=-1).view(B, nc, H * w)
    a = Ftot.transpose(1, 2)[..., None].expand(B, nc, H, w).contiguous() \
        .view(B, nc, H * w)
    if state is None:
        h0 = b.new_zeros((B, 1, H, w))
    else:
        h0 = torch.cat([state[0].flatten(-2), state[1]], dim=-1) \
            .float()[:, None]
        b[:, 0] += a[:, 0] * h0.reshape(B, H * w)
    hs = ssm_lib._scan(a, b, impl).view(B, nc, H, w)
    del a, b
    prev = torch.cat([h0, hs[:, :-1]], dim=1)
    Cs = prev[..., :dh * dh].unflatten(-1, (dh, dh)).transpose(1, 2)
    ns = prev[..., dh * dh:].transpose(1, 2)
    last = hs[:, -1]
    return Cs, ns, (last[..., :dh * dh].unflatten(-1, (dh, dh)),
                    last[..., dh * dh:])


def _mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lf: torch.Tensor, li: torch.Tensor, CT: int, state=None,
                   *, impl: str = "auto"):
    """Chunkwise-parallel mLSTM attention from ``state`` (``(C, n)``,
    default zero).

    ``q``/``k``/``v [B, H, T, dh]`` (q pre-scaled); ``lf``/``li [B, H,
    T]`` the log-forget and log-input gates (both <= 0). Returns (``h
    [B, H, T, dh]`` float32, the final ``(C, n)``). The last chunk is
    padded with ``lf = 0`` (the state kept) and ``li = -1e30`` (no
    write). ``impl`` says where the chunk scan runs, as in
    `models.ssm.ssm_layer`."""
    B, H, T, dh = q.shape
    q, k, v, lf, li = (t.float() for t in (q, k, v, lf, li))
    pad = (-T) % CT
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        lf = F.pad(lf, (0, pad))
        li = F.pad(li, (0, pad), value=-1e30)
    nc = (T + pad) // CT
    qc, kc, vc = (t.reshape(B, H, nc, CT, dh) for t in (q, k, v))
    Lf = torch.cumsum(lf.reshape(B, H, nc, CT), dim=-1)
    lic = li.reshape(B, H, nc, CT)
    # Intra-chunk decay matrix D[t, s] = exp(Lf_t - Lf_s + li_s), s <= t.
    tri = torch.ones((CT, CT), dtype=torch.bool, device=q.device).tril()
    Dm = torch.exp((Lf[..., :, None] - Lf[..., None, :] + lic[..., None, :])
                   .masked_fill(~tri, -1e30))           # [B, H, nc, CT, CT]
    # Per-chunk writes to the running state (value at chunk end).
    kw = torch.exp(Lf[..., -1:] - Lf + lic)[..., None] * kc
    S = kw.transpose(-1, -2) @ vc                       # [B, H, nc, dh, dh]
    zn = kw.sum(dim=-2)                                 # [B, H, nc, dh]
    Cs, ns, final = _chunk_states(torch.exp(Lf[..., -1]), S, zn, impl,
                                  state)
    del kw, S, zn
    DS = Dm * (qc @ kc.transpose(-1, -2))               # [B, H, nc, CT, CT]
    eL = torch.exp(Lf)
    inter = eL[..., None] * (qc @ Cs)
    denom = (DS.sum(dim=-1) + eL * (qc @ ns[..., None])[..., 0]) \
        .abs().clamp_min(1.0)
    h = (DS @ vc + inter) / denom[..., None]
    return h.reshape(B, H, nc * CT, dh)[:, :, :T], final


def _mlstm_chunk_aggregate(k: torch.Tensor, v: torch.Tensor,
                           lf: torch.Tensor, li: torch.Tensor, CT: int):
    """A slice's contribution to the running state from a zero state:
    ``(Ftot [B, H], C_end [B, H, dh, dh], n_end [B, H, dh])`` float32, the
    element of the cross-rank state scan. No ``[CT, CT]`` intra-chunk
    terms: each chunk's writes decayed to the slice's end and summed."""
    B, H, T, dh = k.shape
    k, v, lf, li = (t.float() for t in (k, v, lf, li))
    pad = (-T) % CT
    if pad:
        k, v = (F.pad(t, (0, 0, 0, pad)) for t in (k, v))
        lf = F.pad(lf, (0, pad))
        li = F.pad(li, (0, pad), value=-1e30)
    nc = (T + pad) // CT
    kc, vc = (t.reshape(B, H, nc, CT, dh) for t in (k, v))
    Lf = torch.cumsum(lf.reshape(B, H, nc, CT), dim=-1)
    kw = torch.exp(Lf[..., -1:] - Lf + li.reshape(B, H, nc, CT))[..., None] \
        * kc
    S = kw.transpose(-1, -2) @ vc                       # [B, H, nc, dh, dh]
    zn = kw.sum(dim=-2)                                 # [B, H, nc, dh]
    Lc = Lf[..., -1]                                    # [B, H, nc]
    total = Lc.sum(dim=-1)
    suffix = torch.exp(total[..., None] - torch.cumsum(Lc, dim=-1))
    C_end = torch.einsum("bhn,bhnkv->bhkv", suffix, S)
    n_end = torch.einsum("bhn,bhnk->bhk", suffix, zn)
    return torch.exp(total), C_end, n_end


def _mlstm_state_combine(ei, ej):
    """Cross-rank composition of mLSTM state contributions, ``i`` earlier:
    the paper's smoothing combine (Eq. 19) with a per-head scalar ``E``
    and a matrix "mean", ``(F_i F_j, F_j C_i + C_j, F_j n_i + n_j)``."""
    Fi, Ci, ni = ei
    Fj, Cj, nj = ej
    return (Fi * Fj, Fj[..., None, None] * Ci + Cj,
            Fj[..., None] * ni + nj)


def _mlstm_sp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lf: torch.Tensor, li: torch.Tensor, CT: int, mesh, *,
              impl: str = "auto") -> torch.Tensor:
    """Sequence-parallel mLSTM on this rank of ``mesh``'s "model" axis:
    the inputs ``[B, H, T, ...]`` are the whole sequence (replicated over
    "model"); the rank runs the chunked form on its ``T / tp`` slice from
    the state its predecessors leave (`device_exclusive_scan` of the
    slices' `_mlstm_chunk_aggregate`), and every rank gets the whole ``h
    [B, H, T, dh]`` back by an ``all_gather`` along T, in q's dtype (the
    layer casts h to it next)."""
    tp = mesh.shape["model"]
    Tl = q.shape[2] // tp
    sl = slice(axis_index("model") * Tl, (axis_index("model") + 1) * Tl)
    # Replicated over "model", each rank takes its slice: under autograd
    # the slices' cotangents are summed back over "model" (pvary).
    q, k, v, lf, li = pvary((q, k, v, lf, li), "model")
    q, k, v = (t[:, :, sl] for t in (q, k, v))
    lf, li = lf[..., sl], li[..., sl]
    agg = _mlstm_chunk_aggregate(k, v, lf, li, CT)
    ident = (torch.ones_like(agg[0]), torch.zeros_like(agg[1]),
             torch.zeros_like(agg[2]))
    _, C_in, n_in = device_exclusive_scan(
        _mlstm_state_combine, agg, axis_name="model", identity=ident)
    h, _ = _mlstm_chunked(q, k, v, lf, li, CT, state=(C_in, n_in),
                          impl=impl)
    return all_gather(h.to(q.dtype), "model", axis=2, tiled=True)


def _memory_step(C: torch.Tensor, n: torch.Tensor, f: torch.Tensor,
                 i: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """One decode step of the matrix memory, in place: ``C <- f C + (i k)
    v^T`` (``mul_``, then ``baddbmm_`` of the outer product: no ``[B, H,
    dh, dh]`` temporary) and ``n <- f n + i k``. Returns the readout ``C^T
    q / max(|n . q|, 1)`` ``[B, H, 1, dh]``. ``C [B, H, dh, dh]`` and
    ``n``, ``q``, ``k``, ``v [B, H, dh]`` float32; gates ``f, i [B, H]``."""
    B, H, dh = q.shape
    C.mul_(f[..., None, None])
    C.view(B * H, dh, dh).baddbmm_((i[..., None] * k).reshape(B * H, dh, 1),
                                   v.reshape(B * H, 1, dh))
    n.mul_(f[..., None]).add_(i[..., None] * k)
    den = (n * q).sum(dim=-1).abs().clamp_min(1.0)
    return (q[..., None, :] @ C) / den[..., None, None]


def mlstm_layer(params: MLSTM, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[MLSTMCache] = None, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Optional[MLSTMCache]]:
    """x ``[B, T, d]`` -> (y ``[B, T, d]``, the cache after the step).
    Prefill when ``cache`` is None (returns no cache, as the reference;
    sequence-parallel under a mesh with "model" ranks, `_mlstm_sp`); else
    one decode step (T == 1) that writes ``cache`` in place."""
    if impl not in ssm_lib.IMPLS:
        raise ValueError(f"mlstm impl {impl!r}; one of {ssm_lib.IMPLS}")
    B, T, _ = x.shape
    H = cfg.num_heads
    din = params.norm_w.shape[0]
    dh = din // H
    xz = params.in_proj(x)
    u, og = xz[..., :din], xz[..., din:]

    hist = cache.conv if cache is not None else None
    uc = silu(ssm_lib._causal_conv(u, params.conv_w, history=hist))
    q = _heads(params.wq(uc), H) / (dh ** 0.5)
    k = _heads(params.wk(uc), H)
    v = _heads(params.wv(u), H)
    gates = params.w_gates(x).float()
    lf = F.logsigmoid(gates[..., :H]).transpose(1, 2)  # [B, H, T]
    li = F.logsigmoid(gates[..., H:]).transpose(1, 2)

    if cache is not None:
        h = _memory_step(cache.C, cache.n, torch.exp(lf[..., 0]),
                         torch.exp(li[..., 0]),
                         *(t[:, :, 0].float() for t in (q, k, v)))
        new_conv = torch.cat([cache.conv, u.to(cache.conv.dtype)], dim=1)
        cache.conv.copy_(new_conv[:, 1:])
    else:
        mesh = _active_mesh()
        CT = min(cfg.scan_chunk, T)
        use_sp = (mesh is not None and "model" in mesh.axis_names
                  and mesh.shape["model"] > 1
                  and T % (mesh.shape["model"] * CT) == 0)
        if use_sp:
            h = _mlstm_sp(q, k, v, lf, li, CT, mesh, impl=impl)
        else:
            h, _ = _mlstm_chunked(q, k, v, lf, li, CT, impl=impl)

    h = h.transpose(1, 2).reshape(B, -1, din).to(x.dtype)
    h = rms_norm(h, params.norm_w, cfg.rmsnorm_eps)
    y = params.out_proj(h * torch.sigmoid(og.float()).to(x.dtype))
    return y, cache


def init_mlstm_cache(cfg: ModelConfig, B: int, dtype: torch.dtype,
                     device) -> MLSTMCache:
    din = int(cfg.mlstm_proj_factor * cfg.d_model)
    dh = din // cfg.num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(
        C=torch.zeros((B, cfg.num_heads, dh, dh), **f32),
        n=torch.zeros((B, cfg.num_heads, dh), **f32),
        conv=torch.zeros((B, cfg.ssm_conv - 1, din), dtype=dtype,
                         device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def mlstm_cache_spec(cfg: ModelConfig, batch_spec=("data",)) -> MLSTMCache:
    """An mLSTM state's layout on a mesh: the batch over ``batch_spec``,
    the head width over "model"."""
    return MLSTMCache(C=P(batch_spec, None, "model", None),
                      n=P(batch_spec, None, "model"),
                      conv=P(batch_spec, None, "model"))


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # [B, d] float32
    n: torch.Tensor  # [B, d]
    h: torch.Tensor  # [B, d]
    m: torch.Tensor  # [B, d] stabiliser


class SLSTM(nn.Module):
    """``w_in [d, 4d]``, ``up [d, 2 ff]`` and ``down [ff, d]`` as
    ``nn.Linear``s; the block-diagonal recurrent weights ``r [H, dh, 4
    dh]``, the gate bias ``b [4d]`` and ``norm_w [d]`` as parameters."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        dh = d // H
        ff = int(d * 4 / 3 / 64) * 64 or 64
        self.w_in = init_linear(gen, d, 4 * d, dtype)
        self.r = nn.Parameter(normal_init(gen, (H, dh, 4 * dh), dtype))
        self.b = nn.Parameter(torch.zeros((4 * d,), dtype=dtype,
                                          device=gen.device))
        self.up = init_linear(gen, d, 2 * ff, dtype)
        self.down = init_linear(gen, ff, d, dtype)
        self.norm_w = init_rms_norm(d, dtype, gen.device)


def init_slstm(cfg: ModelConfig, gen: torch.Generator,
               dtype: torch.dtype) -> SLSTM:
    return SLSTM(cfg, gen, dtype)


def _slstm_step(r: torch.Tensor, b: torch.Tensor, carry,
                pre_x: torch.Tensor, H: int):
    """One sLSTM step, float32. ``pre_x [B, 4d]`` is the input part; the
    recurrent part is added here. Gate layout: ``[i | f | z | o]``, each
    ``[B, d]`` after the recurrent part's ``[B, H, 4, dh]`` is
    transposed to ``[B, 4, H, dh]``."""
    c, n, h, m = carry
    B, d = h.shape
    dh = d // H
    rec = torch.einsum("bhk,hkj->bhj", h.reshape(B, H, dh),
                       r.float())                        # [B, H, 4 dh]
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * d)
    pre = pre_x + rec + b.float()
    ig, fg, zg, og = pre.chunk(4, dim=-1)
    # Stabilised exponential gating (xLSTM Eq. sLSTM).
    log_f = F.logsigmoid(fg)
    m_new = torch.maximum(log_f + m, ig)
    i = torch.exp(ig - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * torch.tanh(zg)
    n_new = (f * n + i).clamp_min(1e-6)
    h_new = torch.sigmoid(og) * (c_new / n_new)
    return c_new, n_new, h_new, m_new


def slstm_layer(params: SLSTM, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[SLSTMCache] = None
                ) -> Tuple[torch.Tensor, Optional[SLSTMCache]]:
    """x ``[B, T, d]`` -> (y ``[B, T, d]``, the cache after the step).
    Prefill (``cache`` None) steps through T from ``c = n = h = 0``, ``m
    = -1e30``; decode takes one step and writes ``cache`` in place."""
    B, T, d = x.shape
    H = cfg.num_heads
    pre = params.w_in(x).float()                         # [B, T, 4d]
    if cache is None:
        carry0 = init_slstm_cache(cfg, B, x.device)

        def loop(pre, r, b):
            carry, hs = carry0, []
            # unbind, not pre[:, t]: its backward is one stack, where T
            # selects' would write T zero-filled [B, T, 4d] gradients.
            for pre_t in pre.unbind(1):
                carry = _slstm_step(r, b, carry, pre_t, H)
                hs.append(carry[2])
            return torch.stack(hs, dim=1)
        n = counting.LOOP_STEPS
        if counting.active() and x.is_meta and T > n and T % n == 0:
            # A count's trip-count shortcut: runs of n and 2 n steps.
            h = counting.repeated(loop, n, pre, params.r, params.b)
        else:
            h = loop(pre, params.r, params.b)
        h = h.to(x.dtype)                                # [B, T, d]
    else:
        for buf, new in zip(cache, _slstm_step(params.r, params.b, cache,
                                               pre[:, 0], H)):
            buf.copy_(new)
        h = cache.h[:, None, :].to(x.dtype)
    h = rms_norm(h, params.norm_w, cfg.rmsnorm_eps)
    up = params.up(h)
    ff = up.shape[-1] // 2
    # jax.nn.gelu's default is the tanh approximation.
    y = params.down(F.gelu(up[..., :ff], approximate="tanh") * up[..., ff:])
    return y, cache


def init_slstm_cache(cfg: ModelConfig, B: int, device) -> SLSTMCache:
    z = torch.zeros((B, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMCache(c=z, n=z.clone(), h=z.clone(),
                      m=torch.full_like(z, -1e30))


def slstm_cache_spec(cfg: ModelConfig, batch_spec=("data",)) -> SLSTMCache:
    """An sLSTM state's layout on a mesh: the batch over ``batch_spec``,
    the width over "model"."""
    spec = P(batch_spec, "model")
    return SLSTMCache(c=spec, n=spec, h=spec, m=spec)
