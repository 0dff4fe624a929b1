"""Normalization layers (``repro/layers/norms.py``).

``rms_norm`` is the RMSNorm kernel's wrapper: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs the plain fp32 version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import rmsnorm as _rmsnorm


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; compute in fp32, cast back."""
    return _rmsnorm.rms_norm(x, weight, eps)
