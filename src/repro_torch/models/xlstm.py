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
``[B, H, dh, dh]`` temporary), the sLSTM its ``c, n, h, m``. The
sequence-parallel mLSTM (``_mlstm_sp``) needs a mesh and waits for the
cross-device slice (ROADMAP queue A, item 4).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (init_linear, init_rms_norm,
                                       normal_init, rms_norm, silu)


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
                  kernel: bool):
    """The chunk-to-chunk recurrence from a zero state, as one scan:
    ``Ftot [B, H, nc]``, ``S [B, H, nc, dh, dh]``, ``zn [B, H, nc, dh]``
    laid out as ``a, b [B, nc, H (dh^2 + dh)]``. Returns the pre-chunk
    states ``Cs [B, H, nc, dh, dh]``, ``ns [B, H, nc, dh]`` and the final
    ``(C, n)``."""
    B, H, nc, dh = zn.shape
    w = dh * dh + dh
    b = torch.cat([S.transpose(1, 2).flatten(-2), zn.transpose(1, 2)],
                  dim=-1).view(B, nc, H * w)
    a = Ftot.transpose(1, 2)[..., None].expand(B, nc, H, w).contiguous() \
        .view(B, nc, H * w)
    hs = ssm_lib._scan(a, b, kernel).view(B, nc, H, w)
    del a, b
    prev = torch.cat([hs.new_zeros((B, 1, H, w)), hs[:, :-1]], dim=1)
    Cs = prev[..., :dh * dh].unflatten(-1, (dh, dh)).transpose(1, 2)
    ns = prev[..., dh * dh:].transpose(1, 2)
    last = hs[:, -1]
    return Cs, ns, (last[..., :dh * dh].unflatten(-1, (dh, dh)),
                    last[..., dh * dh:])


def _mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lf: torch.Tensor, li: torch.Tensor, CT: int, *,
                   impl: str = "auto"):
    """Chunkwise-parallel mLSTM attention from a zero state.

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
    Cs, ns, final = _chunk_states(torch.exp(Lf[..., -1]), S, zn,
                                  impl == "auto" and q.is_cuda)
    del kw, S, zn
    DS = Dm * (qc @ kc.transpose(-1, -2))               # [B, H, nc, CT, CT]
    eL = torch.exp(Lf)
    inter = eL[..., None] * (qc @ Cs)
    denom = (DS.sum(dim=-1) + eL * (qc @ ns[..., None])[..., 0]) \
        .abs().clamp_min(1.0)
    h = (DS @ vc + inter) / denom[..., None]
    return h.reshape(B, H, nc * CT, dh)[:, :, :T], final


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
    Prefill when ``cache`` is None (returns no cache, as the reference);
    else one decode step (T == 1) that writes ``cache`` in place."""
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
        h, _ = _mlstm_chunked(q, k, v, lf, li, min(cfg.scan_chunk, T),
                              impl=impl)

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


def _slstm_step(params: SLSTM, carry, pre_x: torch.Tensor, H: int):
    """One sLSTM step, float32. ``pre_x [B, 4d]`` is the input part; the
    recurrent part is added here. Gate layout: ``[i | f | z | o]``, each
    ``[B, d]`` after the recurrent part's ``[B, H, 4, dh]`` is
    transposed to ``[B, 4, H, dh]``."""
    c, n, h, m = carry
    B, d = h.shape
    dh = d // H
    rec = torch.einsum("bhk,hkj->bhj", h.reshape(B, H, dh),
                       params.r.float())                 # [B, H, 4 dh]
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * d)
    pre = pre_x + rec + params.b.float()
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
        carry = init_slstm_cache(cfg, B, x.device)
        hs = []
        for t in range(T):
            carry = _slstm_step(params, carry, pre[:, t], H)
            hs.append(carry[2])
        h = torch.stack(hs, dim=1).to(x.dtype)           # [B, T, d]
    else:
        for buf, new in zip(cache, _slstm_step(params, cache, pre[:, 0], H)):
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
