"""Rotary position embeddings (``repro/layers/rope.py``, standard RoPE).

The rotation pairs the two HALVES of the head dimension, x[:D/2] with
x[D/2:], as the reference computes it (its docstring says even/odd
pairs, its code splits halves).  Angles are fp32 and the result is cast
back to x's dtype.  M-RoPE arrives with the qwen2-vl slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape positions.shape + (head_dim // 2,)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2),
    broadcast over heads."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, S, Hq, D), k: (B, S, Hk, D), positions: (B, S) absolute."""
    cos, sin = rope_angles(positions, q.shape[-1], theta)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)
