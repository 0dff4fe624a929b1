"""Mixture-of-Experts FFN (``repro/layers/moe.py``): top-k routing and
optional shared experts, by dense dispatch.

Every expert processes every token, weighted by the routing weights, as
in the reference, in one of its three layouts, picked as it picks them:

  * the expert-sharded einsum, where an active mesh's "model" axis is
    above 1 and divides the experts: one (E, B, S, f) product with E on
    "model", so each rank holds (E/m, B, S, f) of it;
  * ``CHUNK_MAJOR`` (a module flag, off by default): token chunks of
    ``min(4096, B S)``, zero-padded, each running every expert in one
    stacked product, with the combine weights folded in before the down
    projection, which then sums over experts and d_ff in one step;
  * otherwise a loop over the experts in index order, one expert's
    intermediates live at a time, accumulated in ``x``'s dtype (the
    layout on one device).

The expert products are plain matrix products, which the reference
leaves to XLA; here they are ``torch.matmul`` and ``torch.einsum``.  An
expert that no token picked is not skipped: knowing that needs the
routes on the host, and its weight is zero.

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

from repro_torch.tracing import span

from .hints import mesh_axis_size, on_shards
from .mlp import init_mlp, mlp_forward, normal_param

# the chunk-major dense-dispatch layout for expert counts the model axis
# does not divide (the reference's measured trade: the expert loop wins
# forward-only serving, chunk-major wins training's backward traffic)
CHUNK_MAJOR = False
CHUNK_TOKENS = 4096


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


def _act(up: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    return (F.silu(gate) * up if gate is not None
            else F.gelu(up, approximate="tanh"))


def _hidden(x: torch.Tensor, w_up: torch.Tensor,
            w_gate: Optional[torch.Tensor]) -> torch.Tensor:
    up = torch.einsum("bsd,edf->ebsf", x, w_up)
    gate = None if w_gate is None else torch.einsum("bsd,edf->ebsf", x,
                                                    w_gate)
    return _act(up, gate)


# on a mesh: x's batch and the experts keep their sharding
_X, _W = {"batch": 0}, {"experts": 0}
_H = {"experts": 0, "batch": 1}


def expert_hidden(params: nn.ParameterDict,
                  x: torch.Tensor) -> torch.Tensor:
    """The expert-sharded layout's (E, B, S, f) activations of every
    expert on every token of x (B, S, d); on DTensors each rank's (E/m,
    B/d, S, f) share (``on_shards``)."""
    return on_shards(_hidden, (x, params["w_up"], params.get("w_gate")),
                     (_X, _W, _W), _H)


def _expert_einsum(params: nn.ParameterDict, x: torch.Tensor,
                   combine: torch.Tensor) -> torch.Tensor:
    """One (E, B, S, f) einsum for all experts, the combine contracting E
    last.  On DTensors it runs on each rank's shards (``on_shards``): the
    rank's experts (E on "model", as the expert weights' placements put
    them) over its batch rows, and the experts' shares are summed across
    "model" afterwards (a partial-sum output)."""
    def local(x, comb, w_up, w_gate, w_down):
        y = torch.einsum("ebsf,efd->ebsd", _hidden(x, w_up, w_gate), w_down)
        return torch.einsum("ebsd,bse->bsd", y, comb)

    return on_shards(local, (x, combine, params["w_up"],
                             params.get("w_gate"), params["w_down"]),
                     (_X, {"batch": 0, "experts": 2}, _W, _W, _W),
                     {"batch": 0, "experts": "sum"})


def _chunk_major(params: nn.ParameterDict, x: torch.Tensor,
                 combine: torch.Tensor) -> torch.Tensor:
    """For each chunk of ``min(CHUNK_TOKENS, B S)`` tokens (the last
    zero-padded), all experts in one stacked product, the combine weights
    folded into the activations, and one product over (expert, d_ff)."""
    B, S, d = x.shape
    n_tok = B * S
    ck = min(CHUNK_TOKENS, n_tok)
    n_pad = -(-n_tok // ck) * ck - n_tok
    xf = F.pad(x.reshape(n_tok, d), (0, 0, 0, n_pad))
    cf = F.pad(combine.reshape(n_tok, -1), (0, 0, 0, n_pad))
    gated = "w_gate" in params
    ys = []
    for i in range(0, n_tok + n_pad, ck):
        xk, ce = xf[i:i + ck], cf[i:i + ck]                # (ck, d), (ck, E)
        up = torch.einsum("cd,edf->ecf", xk, params["w_up"])
        gate = (torch.einsum("cd,edf->ecf", xk, params["w_gate"])
                if gated else None)
        h = _act(up, gate) * ce.T[:, :, None]
        ys.append(torch.einsum("ecf,efd->cd", h, params["w_down"]))
    return torch.cat(ys)[:n_tok].reshape(B, S, d)


def moe_forward(params: MoEParams, x: torch.Tensor, top_k: int,
                router_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model).  Routing weights are
    renormalised over the top-k (the Mixtral convention).  While a
    ``torch.profiler`` profile records, the call is a ``moe_forward``
    span (``repro_torch.tracing``)."""
    with span("moe_forward"):
        return _moe_forward(params, x, top_k, router_noise)


def _moe_forward(params: MoEParams, x: torch.Tensor, top_k: int,
                 router_noise: Optional[torch.Tensor]) -> torch.Tensor:
    gates, experts = route(params, x, top_k, router_noise)
    n_routed = params["router"].shape[1]
    combine = torch.zeros(*x.shape[:-1], n_routed, dtype=torch.float32,
                          device=x.device).scatter_add(-1, experts, gates)
    combine = combine.to(x.dtype)
    m = mesh_axis_size("model")
    if m > 1 and n_routed % m == 0:
        out = _expert_einsum(params, x, combine)
    elif CHUNK_MAJOR:
        out = _chunk_major(params, x, combine)
    else:
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
