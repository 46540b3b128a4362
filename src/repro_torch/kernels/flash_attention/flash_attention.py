"""Blocked causal GQA attention with an online softmax: a hand-written CUDA
kernel for Hopper and its plain PyTorch version.

The kernel (``src/repro_torch/csrc/flash_attention.cu``) replaces the
Pallas TPU kernel ``flash_attention_batched`` of
``repro/kernels/flash_attention/flash_attention.py``: one CTA per (query
tile, query head, batch) streams the key/value tiles of its GQA head
through shared memory and keeps the running max, denominator and
accumulator in float32 (see the source note in the ``.cu`` file).

``flash_attention_plain`` computes the same function with tensor ops, one
query block at a time with an online softmax over key blocks, in float32,
so its memory stays O(block_q · block_k) per head. It serves CPU tensors
and is the on-card reference.

Conventions of both (and of the oracle ``ref.attention_ref``): queries are
right-aligned to the keys (query ``i`` at position ``Tk - Tq + i``);
causal masking uses -1e30; a row that sees no key (causal, ``Tq > Tk``)
averages ``v`` over the ``Tk`` real keys. The JAX kernel averages its
block padding there too, so for those rows it differs from its own oracle.

``flash_attention_cuda`` is the kernel wrapper. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises — never a
fallback. Each launch adds one to ``LAUNCHES["flash_attention"]``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

#: Kernel launches since the last `reset_launch_counts`.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

#: Head dims with a compiled kernel instance (the repo's configs and the
#: JAX suite use 16, 32, 64 and 128).
HEAD_DIMS = (16, 32, 64, 128, 256)

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}

#: ``nvcc`` parts of ``csrc/flash_attention.cu``, compiled at the same
#: time: one per head_dim (both dtypes), and the C entry point.
BUILD_PARTS = tuple((f"-DFA_HEAD_DIM={d}",) for d in HEAD_DIMS) + (
    ("-DFA_ENTRY_POINTS",),)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless ``q [B, Hq, Tq, Dh]`` and ``k, v [B, Hkv, Tk, Dh]``
    fit together (``Hkv`` divides ``Hq``; ``Tk >= 1`` unless the output is
    empty)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         "[B, Hq, Tq, Dh] and two equal [B, Hkv, Tk, Dh]")
    B, Hq, Tq, Dh = q.shape
    Bk, Hkv, Tk, Dk = k.shape
    if Bk != B or Dk != Dh:
        raise ValueError(f"flash_attention: batch/head_dim of q "
                         f"{(B, Dh)} and k {(Bk, Dk)} differ")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hkv={Hkv} does not divide "
                         f"Hq={Hq}")
    if Tk < 1 and q.numel():
        raise ValueError("flash_attention: no keys (Tk = 0)")


def _key_end(first_qpos: int, end_qpos: int, Tk: int, causal: bool) -> int:
    """Keys a query block must visit: up to its last position when causal,
    all of them when its first row sees no key (it averages them all)."""
    if not causal or first_qpos < 0:
        return Tk
    return min(Tk, end_qpos)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None, block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """``q [B, Hq, Tq, Dh]``, ``k/v [B, Hkv, Tk, Dh]`` -> ``[B, Hq, Tq, Dh]``
    in q's dtype: per block of ``block_q`` queries, an online softmax over
    blocks of ``block_k`` keys in float32. The query heads of one GQA group
    share their key/value head by broadcasting (no copy)."""
    check_shapes(q, k, v)
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1:3]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    qf = q.float().reshape(B, Hkv, group, Tq, Dh)
    kf = k.float()[:, :, None]    # [B, Hkv, 1, Tk, Dh]
    vf = v.float()[:, :, None]
    q_offset = Tk - Tq
    for q0 in range(0, Tq, block_q):
        q1 = min(q0 + block_q, Tq)
        qb = qf[:, :, :, q0:q1]
        m = qb.new_full(qb.shape[:-1] + (1,), _NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        qpos = torch.arange(q_offset + q0, q_offset + q1,
                            device=q.device)[:, None]
        for k0 in range(0, _key_end(q_offset + q0, q_offset + q1, Tk,
                                    causal), block_k):
            k1 = min(k0 + block_k, Tk)
            s = (qb @ kf[:, :, :, k0:k1].mT) * scale
            if causal:
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                s = torch.where(qpos >= kpos, s, s.new_tensor(_NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, :, k0:k1]
            m = m_new
        acc = acc / torch.where(l > 0, l, torch.ones_like(l))
        out[:, :, q0:q1] = acc.reshape(B, Hq, q1 - q0, Dh).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _library():
    """Build (first call) and bind the kernel's C interface."""
    from repro_torch.kernels.build import build

    lib = build("flash_attention", BUILD_PARTS).lib
    if not getattr(lib, "_fa_bound", False):
        i, ll, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.fa_attention.argtypes = [i, i, ll, i, i, ll, ll, i,
                                     ctypes.c_float, ptr, ptr, ptr, ptr, ptr]
        lib.fa_attention.restype = ctypes.c_int
        lib._fa_bound = True
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention over contiguous ``q [B, Hq, Tq, Dh]``, ``k/v [B, Hkv, Tk,
    Dh]``, float32 or bfloat16, ``Dh`` in `HEAD_DIMS`.

    CPU tensors take `flash_attention_plain`; CUDA tensors launch the
    hand-written kernel (nothing for an empty output) or raise."""
    check_shapes(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1:3]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not float32 "
                        "or bfloat16")
    if any(t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise TypeError("flash_attention: q, k, v differ in dtype or device")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {Dh} has no kernel "
                         f"instance; built: {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: non-contiguous input; the kernel "
                         "reads densely packed [B, H, T, Dh] arrays")
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().fa_attention(
        _DTYPE_CODE[q.dtype], Dh, B, Hq, Hkv, Tq, Tk, int(causal),
        float(scale), *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
