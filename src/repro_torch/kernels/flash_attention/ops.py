"""Public wrapper of the flash attention kernel.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version, as in
``kalman_combine/ops.py``; nothing falls back from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref as _ref
from .flash_attention import flash_attention_cuda, flash_attention_plain


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """``q [B, Hq, Tq, Dh]``, ``k/v [B, Hkv, Tk, Dh]`` -> ``[B, Hq, Tq, Dh]``
    in q's dtype; queries right-aligned to the keys, ``scale`` defaulting
    to ``Dh ** -0.5``.

    ``block_q``/``block_k`` are the tile sizes of the plain version (and of
    the TPU kernel); the CUDA kernels use their own compiled tiles. They
    change results only by rounding.
    """
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q={block_q} and block_k={block_k} must "
                         "be >= 1")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, scale=scale)


attention_ref = _ref.attention_ref
