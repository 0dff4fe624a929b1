"""Mamba2 SSD mixer (``repro/layers/ssm.py``): the attention-free
sequence layer.

``mamba2_forward`` (training) runs the whole sequence through the SSD
scan of ``repro_torch.kernels.ssd_scan`` (the hand-written CUDA kernel on
CUDA tensors, its plain version on CPU tensors) and adds the D-skip term
in x's dtype, as ``repro/kernels/ssd_scan/ops.py`` does.
``mamba2_decode_step`` (serving) advances the recurrence by one token:
O(1) in the context length, no scan.

Parameters are an ``nn.ParameterDict`` keyed and laid out as the
reference's pytree: ``w_x``, ``w_z`` (d_model, d_inner), ``w_bcdt``
(d_model, 2 G N + H), the depthwise conv taps ``conv_x`` (K, d_inner) and
``conv_bc`` (K, 2 G N) with their biases, ``norm_w`` (d_inner,), ``w_out``
(d_inner, d_model) in the model's dtype, and ``a_log``, ``dt_bias``,
``d_skip`` (H,) in fp32 whatever the model's dtype.

Numerics follow the reference: the causal conv sums its K shifted
products in the parameters' dtype from tap 0 on (``F.conv1d`` would sum
in another order, and in fp32 on a card through cuDNN in TF32); dt is
``softplus`` as ``jax.nn.softplus`` computes it, ``logaddexp(v, 0)``
(``F.softplus`` switches to the identity above 20), in fp32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ssd_scan as _ssd
from .hints import on_shards, split_last
from .mlp import normal_param
from .norms import rms_norm


def init_mamba2(gen: torch.Generator, d_model: int, d_inner: int,
                d_state: int, n_heads: int, d_conv: int = 4,
                n_groups: int = 1, dtype: torch.dtype = torch.bfloat16,
                device=None) -> nn.ParameterDict:
    """Weights drawn on ``gen``'s device with the reference's shapes and
    scales (not its values); ``a_log = log(linspace(1, 16, H))``, dt bias
    0 and D-skip 1 in fp32, as in the reference."""
    if d_inner % n_heads:
        raise ValueError("d_inner must divide into n_heads")
    s = 1.0 / math.sqrt(d_model)
    gn = n_groups * d_state

    def fp32(values: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(values.to(device=device, dtype=torch.float32))

    return nn.ParameterDict({
        "w_x": normal_param(gen, (d_model, d_inner), s, dtype, device),
        "w_z": normal_param(gen, (d_model, d_inner), s, dtype, device),
        "w_bcdt": normal_param(gen, (d_model, 2 * gn + n_heads), s, dtype,
                               device),
        "conv_x": normal_param(gen, (d_conv, d_inner), 0.1, dtype, device),
        "conv_x_b": nn.Parameter(torch.zeros(d_inner, dtype=dtype,
                                             device=device)),
        "conv_bc": normal_param(gen, (d_conv, 2 * gn), 0.1, dtype, device),
        "conv_bc_b": nn.Parameter(torch.zeros(2 * gn, dtype=dtype,
                                              device=device)),
        "a_log": fp32(torch.log(torch.linspace(1.0, 16.0, n_heads))),
        "dt_bias": fp32(torch.zeros(n_heads)),
        "d_skip": fp32(torch.ones(n_heads)),
        "norm_w": nn.Parameter(torch.ones(d_inner, dtype=dtype,
                                          device=device)),
        "w_out": normal_param(gen, (d_inner, d_model),
                              1.0 / math.sqrt(d_inner), dtype, device),
    })


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(v)) as ``logaddexp(v, 0)``."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU.  x: (B, S, C); w: (K, C).  The K
    shifted products are summed from tap 0 on, as the reference does.
    On DTensors each rank convolves its own batch rows and channels
    (``on_shards``; the sequence is gathered): DTensor's rule for the
    padding fails in torch 2.11."""
    def conv(x, w, b):
        K, S = w.shape[0], x.shape[1]
        xp = F.pad(x, (0, 0, K - 1, 0))
        out = xp[:, 0:S, :] * w[0]
        for i in range(1, K):
            out = out + xp[:, i:i + S, :] * w[i]
        return F.silu(out + b)

    chans = {"batch": 0, "chan": 2}
    return on_shards(conv, (x, w, b), (chans, {"chan": 1}, {"chan": 0}),
                     chans)


def _project(params: nn.ParameterDict, x: torch.Tensor, d_state: int,
             n_groups: int):
    """Shared input projections -> (z, xi, bc, dt) before the convs."""
    gn = n_groups * d_state
    z = x @ params["w_z"]
    xi = x @ params["w_x"]
    bcdt = x @ params["w_bcdt"]
    return z, xi, bcdt[..., :2 * gn], bcdt[..., 2 * gn:]


def mamba2_forward(params: nn.ParameterDict, x: torch.Tensor, *,
                   d_inner: int, d_state: int, n_heads: int,
                   n_groups: int = 1, chunk: int = 128) -> torch.Tensor:
    """Full-sequence Mamba2 mixer.  x: (B, S, d_model)."""
    B, S, _ = x.shape
    P = d_inner // n_heads
    gn = n_groups * d_state
    z, xi, bc, dt = _project(params, x, d_state, n_groups)
    xi = _causal_conv(xi, params["conv_x"], params["conv_x_b"])
    bc = _causal_conv(bc, params["conv_bc"], params["conv_bc_b"])
    b, c = bc[..., :gn].contiguous(), bc[..., gn:].contiguous()
    dt = softplus(dt.float() + params["dt_bias"])          # (B, S, H) fp32
    xh = split_last(xi, B, S, n_heads, P)
    # on DTensors: each rank scans its batch rows and, where the mesh
    # dims on them divide H, its heads (B and C are every head's)
    heads = {"batch": 0, "heads": 2}
    y = on_shards(lambda *t: _ssd.ssd_scan(*t, chunk=chunk),
                  (xh, dt, params["a_log"], b, c),
                  (heads, heads, {"heads": 0}, {"batch": 0},
                   {"batch": 0}), heads)
    y = y + xh * params["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y * F.silu(z), params["norm_w"])
    return (y @ params["w_out"]).to(x.dtype)


def mamba2_decode_step(params: nn.ParameterDict, x: torch.Tensor,
                       ssm_state: torch.Tensor, conv_state: dict, *,
                       d_inner: int, d_state: int, n_heads: int,
                       n_groups: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One decode step.  x: (B, 1, d_model); ssm_state: (B, H, P, N)
    fp32; conv_state: ``{"x": (B, K-1, d_inner), "bc": (B, K-1, 2 G N)}``.
    Returns (y (B, 1, d_model), new state, new conv windows); the inputs
    are not modified."""
    B = x.shape[0]
    P = d_inner // n_heads
    gn = n_groups * d_state
    K = params["conv_x"].shape[0]
    z, xi, bc, dt = _project(params, x, d_state, n_groups)

    def conv_step(state, new, w, bias):
        win = torch.cat([state, new], dim=1)               # (B, K, C)
        out = win[:, 0, :] * w[0]
        for i in range(1, K):
            out = out + win[:, i, :] * w[i]
        return F.silu(out + bias)[:, None, :], win[:, 1:, :]

    xi, ncx = conv_step(conv_state["x"], xi, params["conv_x"],
                        params["conv_x_b"])
    bc, ncb = conv_step(conv_state["bc"], bc, params["conv_bc"],
                        params["conv_bc_b"])
    b, c = bc[..., :gn], bc[..., gn:]
    dt = softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])
    a = torch.exp(dt[:, 0, :] * A)                         # (B, H)
    xh = split_last(xi, B, n_heads, P)
    upd = (dt[:, 0, :, None, None] * xh[..., None].float()
           * b[:, 0, None, None, :].float())               # (B, H, P, N)
    new_state = ssm_state * a[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, c[:, 0].float())
    y = y + xh.float() * params["d_skip"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"])
    return ((y @ params["w_out"]).to(x.dtype), new_state,
            {"x": ncx, "bc": ncb})
