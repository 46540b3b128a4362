"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE.

The JAX package's ``repro.models.rope`` on tensors. Angles are computed in
float32 whatever the activations' dtype; the rotated values are cast back
to it. M-RoPE splits the rotary channels into three sections (temporal /
height / width) driven by 3-row position ids; for pure-text tokens the
three rows are equal and M-RoPE reduces exactly to RoPE. Both rotate each
head on its own, so a tensor-parallel rank rotates its heads with the
positions of the whole sequence (a sequence-parallel stream is gathered
before q and k are projected) and needs nothing of this module changed.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(head_dim: int, theta: float, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., T] -> (cos, sin) each [..., T, head_dim/2]."""
    ang = positions[..., None].float() * _inv_freq(head_dim, theta,
                                                   positions.device)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    """x [..., T, H, D]; cos/sin [..., T, D/2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # add head axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, T, Hq, D], k [B, T, Hkv, D], positions [B, T] (int)."""
    cos, sin = rope_angles(q.shape[-1], theta, positions)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def mrope_angles(head_dim: int, theta: float, positions: torch.Tensor,
                 sections: Sequence[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE: positions [3, B, T]; sections sum to head_dim/2. Channel
    block ``i`` (of size sections[i], in rotary-frequency space) takes its
    angle from positions row i."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    ang_all = positions[..., None].float() * _inv_freq(
        head_dim, theta, positions.device)              # [3, B, T, half]
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                      # [B, T, half]
    return torch.cos(ang), torch.sin(ang)


def apply_mrope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                theta: float, sections: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, T, Hq, D], k [B, T, Hkv, D], positions [3, B, T]."""
    cos, sin = mrope_angles(q.shape[-1], theta, positions, sections)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def text_mrope_positions(B: int, T: int, offset=0, device=None
                         ) -> torch.Tensor:
    """Pure-text M-RoPE positions: all three rows equal (== RoPE)."""
    pos = offset + torch.arange(T, dtype=torch.int32, device=device)
    return pos.expand(3, B, T)


def vision_mrope_positions(B: int, grid_t: int, grid_h: int, grid_w: int,
                           device=None) -> torch.Tensor:
    """Patch-token M-RoPE positions for a (t, h, w) grid, flattened in
    raster order. Returns [3, B, t*h*w]."""
    kw = dict(device=device)
    t = torch.arange(grid_t, **kw).repeat_interleave(grid_h * grid_w)
    h = torch.arange(grid_h, **kw).repeat_interleave(grid_w).repeat(grid_t)
    w = torch.arange(grid_w, **kw).repeat(grid_t * grid_h)
    pos = torch.stack([t, h, w]).to(torch.int32)       # [3, T]
    return pos[:, None, :].expand(3, B, pos.shape[1])
