"""Normalization layers (``repro/layers/norms.py``).

``rms_norm`` is the RMSNorm kernel's wrapper: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs the plain fp32 version.  A
``DTensor`` runs it on each rank's local rows (``hints.on_shards``): a
row dim stays sharded, while the last dim, which the norm reduces over,
and a ``Partial`` sum are gathered first, and the weight is replicated.
``layer_norm`` is a plain tensor function: the reference's has no
kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import rmsnorm as _rmsnorm
from .hints import on_shards


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; compute in fp32, cast back."""
    rows = {i: i for i in range(x.dim() - 1)}
    return on_shards(lambda xs, w: _rmsnorm.rms_norm(xs, w, eps),
                     (x, weight), (rows, {}), rows)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; compute in fp32, cast back."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * (var + eps) ** -0.5
    return (y * weight.float() + bias.float()).to(x.dtype)
