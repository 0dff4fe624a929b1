"""Mixture-of-Experts FFN (``repro/layers/moe.py``): top-k routing and
optional shared experts, by dense dispatch.

Every expert processes every token, weighted by the routing weights, as
in the reference.  Of the reference's three layouts this is the one it
takes on one device (the "model" mesh axis is 1 and ``CHUNK_MAJOR`` is
False): a loop over the experts in index order, one expert's
intermediates live at a time, accumulated in ``x``'s dtype.  The expert
products are plain matrix products, which the reference leaves to XLA;
here they are ``torch.matmul``.  An expert that no token picked is not
skipped: knowing that needs the routes on the host, and its weight is
zero.

Parameters keep the reference's layout: ``router`` (d, E) fp32 in every
model dtype, ``w_up``/``w_gate`` (E, d, f) and ``w_down`` (E, f, d).
Shared experts are an MLP stored as the submodule ``shared``, so their
parameters are named ``shared.w_up`` ... and map to the reference's
``ffn/shared/w_up``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .mlp import init_mlp, mlp_forward, normal_param


class MoEParams(nn.ParameterDict):
    """A MoE FFN's parameters: the routed experts' leaves by name, as in a
    ``ParameterDict``, and the shared experts' MLP, or None, as the
    submodule ``shared``."""

    def __init__(self, leaves: Mapping[str, nn.Parameter],
                 shared: Optional[nn.ParameterDict] = None):
        super().__init__(leaves)
        self.shared = shared


def init_moe(gen: torch.Generator, d_model: int, d_ff_expert: int,
             n_routed: int, top_k: int, n_shared: int = 0,
             gated: bool = True, dtype: torch.dtype = torch.bfloat16,
             device=None) -> MoEParams:
    """Weights drawn on ``gen``'s device with the reference's shapes and
    scales (not its values); the router stays fp32.  ``top_k`` is unused,
    as in the reference."""
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff_expert)
    leaves = {
        "router": normal_param(gen, (d_model, n_routed), s_in,
                               torch.float32, device),
        "w_up": normal_param(gen, (n_routed, d_model, d_ff_expert), s_in,
                             dtype, device),
        "w_down": normal_param(gen, (n_routed, d_ff_expert, d_model), s_out,
                               dtype, device),
    }
    if gated:
        leaves["w_gate"] = normal_param(gen, (n_routed, d_model, d_ff_expert),
                                        s_in, dtype, device)
    shared = None
    if n_shared:
        shared = init_mlp(gen, d_model, d_ff_expert * n_shared, gated=gated,
                          dtype=dtype, device=device)
    return MoEParams(leaves, shared)


def route(params: nn.ParameterDict, x: torch.Tensor, top_k: int,
          router_noise: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gates, experts)``, each (..., top_k): the softmax over each
    token's top-k router logits (fp32) and those experts' indices, in the
    order of ``jax.lax.top_k``: descending, and the lower index first
    among equal logits (a stable sort; ``torch.topk`` promises no order
    for ties)."""
    logits = x.float() @ params["router"]
    if router_noise is not None:
        logits = logits + router_noise
    vals, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[..., :top_k], dim=-1), experts[..., :top_k]


def moe_forward(params: MoEParams, x: torch.Tensor, top_k: int,
                router_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model).  Routing weights are
    renormalised over the top-k (the Mixtral convention)."""
    gates, experts = route(params, x, top_k, router_noise)
    n_routed = params["router"].shape[1]
    combine = torch.zeros(*x.shape[:-1], n_routed, dtype=torch.float32,
                          device=x.device).scatter_add(-1, experts, gates)
    combine = combine.to(x.dtype)
    gated = "w_gate" in params
    out = torch.zeros_like(x)
    for e in range(n_routed):
        up = x @ params["w_up"][e]
        h = (F.silu(x @ params["w_gate"][e]) * up if gated
             else F.gelu(up, approximate="tanh"))
        out = out + (h @ params["w_down"][e]) * combine[..., e, None]
    if params.shared is not None:
        out = out + mlp_forward(params.shared, x)
    return out
