"""Oracle for the flash_attention kernel: materialized-scores softmax
attention with the GQA key/value heads repeated, causal masking and f32
accumulation."""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """``q [B, Hq, Tq, Dh]``, ``k/v [B, Hkv, Tk, Dh]`` -> ``[B, Hq, Tq, Dh]``.

    Queries are right-aligned with the keys (query ``i`` sits at absolute
    position ``Tk - Tq + i``). A query that sees no key averages ``v`` over
    all ``Tk`` keys.
    """
    Hq, Tq, Dh = q.shape[1:]
    Hkv, Tk = k.shape[1:3]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    k = k.repeat_interleave(group, dim=1).float()
    v = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    if causal:
        qpos = (Tk - Tq) + torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, s.new_tensor(_NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)
