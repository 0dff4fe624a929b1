"""Rotary position embeddings (``repro/layers/rope.py``): standard RoPE
and Qwen2-VL's M-RoPE.

The rotation pairs the two HALVES of the head dimension, x[:D/2] with
x[D/2:], as the reference computes it (its docstring says even/odd
pairs, its code splits halves).  Angles are fp32 and the result is cast
back to x's dtype.

M-RoPE (arXiv:2409.12191) splits the D/2 frequency slots into three
sections rotated by the (temporal, height, width) position ids.  The
vision frontend is a stub, so the ids arrive precomputed beside the patch
embeddings; text tokens have t == h == w, where M-RoPE is standard RoPE.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """The default (t, h, w) split of the ``head_dim // 2`` frequency
    slots: Qwen2-VL's 1:1.5:1.5, (16, 24, 24) at head dim 128, scaled to
    the head dim ((1, 1, 2) at 8)."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                sections: Optional[Sequence[int]] = None,
                theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE.  q: (B, S, Hq, D), k: (B, S, Hk, D), positions:
    (B, S, 3) = (t, h, w) ids; frequency slot i of section s rotates by
    the ids of axis s.  ``sections`` must sum to ``D // 2`` (default
    ``mrope_sections(D)``); ``ValueError`` otherwise."""
    half = q.shape[-1] // 2
    if sections is None:
        sections = mrope_sections(q.shape[-1])
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"{half}")
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    # section s of the slots takes axis s: (B, S, half), with no index
    # tensor to copy to the device
    pos = torch.cat([positions[..., s:s + 1].float().expand(
        *positions.shape[:-1], n) for s, n in enumerate(sections)], dim=-1)
    ang = pos * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)
