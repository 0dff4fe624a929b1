"""Feed-forward layers (``repro/layers/mlp.py``): SwiGLU (gated) and GELU.

The GELU branch uses the tanh approximation because ``jax.nn.gelu``
defaults to it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def normal_param(gen: torch.Generator, shape, scale: float,
                 dtype: torch.dtype, device) -> nn.Parameter:
    """A trainable N(0, scale^2) parameter, drawn in fp32 on ``gen``'s
    device, then moved to ``device`` and cast to ``dtype``.  On the meta
    device nothing is drawn: the parameter has the shape and dtype only
    (a model's layout at full size, for the sharding rules)."""
    if device is not None and torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))
    w = torch.randn(shape, generator=gen, device=gen.device) * scale
    return nn.Parameter(w.to(device=device, dtype=dtype))


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, dtype: torch.dtype = torch.bfloat16,
             device=None) -> nn.ParameterDict:
    """Weights drawn on ``gen``'s device from N(0, 1/fan_in), as in the
    reference (same shapes and scales, not the same values)."""
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    p = nn.ParameterDict({
        "w_up": normal_param(gen, (d_model, d_ff), s_in, dtype, device),
        "w_down": normal_param(gen, (d_ff, d_model), s_out, dtype,
                               device),
    })
    if gated:
        p["w_gate"] = normal_param(gen, (d_model, d_ff), s_in, dtype,
                                   device)
    return p


def mlp_forward(params: nn.ParameterDict, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_model)."""
    up = x @ params["w_up"]
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ params["w_down"]
