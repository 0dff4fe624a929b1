"""Expert parallelism (``repro/parallel/ep.py``): capacity-based
all-to-all MoE dispatch.

The model's MoE layer (``layers/moe.py``) is a dense dispatch: exact, but
every expert computes every token.  This is the gathered path the APEX
planner's "ep" template maps to:

  * tokens are split over the "model" axis (sequence-split), experts too
    (``E / tp`` a rank);
  * each rank routes its tokens (fp32 router, replicated) and buckets
    them per expert with a fixed CAPACITY ``max(1, int(cap_factor *
    T_local * top_k / E))``, dropping overflow (GShard semantics: drops
    are counted and returned, never silent);
  * one ``all_to_all_single`` over the model group sends the buckets to
    their experts' owners, the rank runs its experts over every bucket it
    received, a second returns the outputs, and a gate-weighted
    scatter-add combines them.

The expert products are plain ``torch.matmul`` over the local experts, as
the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.layers.mlp import mlp_forward
from repro_torch.layers.moe import route
from .sharding import axis_sizes


def _bucket_by_expert(x: torch.Tensor, idx: torch.Tensor, n_exp: int,
                      cap: int):
    """Bucket token-assignments into (n_exp, cap, d) buffers, dropping
    overflow.  x: (T, d); idx: (T, k) expert ids.  An assignment's slot
    is its rank among the assignments to its expert, in token order (a
    stable sort).  Returns (buffers, (tok_of_assign, e_idx, s_idx, kept),
    n_dropped).

    A dropped assignment adds a masked zero at (expert 0, slot cap - 1),
    as in the reference; the accumulating ``index_put_`` keeps a kept
    token in that slot as it is."""
    T, d = x.shape
    k = idx.shape[1]
    n = T * k
    flat_e = idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ar = torch.arange(n, device=x.device)
    pos_in_run = ar - first
    inv = torch.empty_like(order)
    inv[order] = ar
    slot = pos_in_run[inv]
    kept = slot < cap
    drops = (~kept).sum()
    tok_of_assign = torch.arange(T, device=x.device).repeat_interleave(k)
    e_idx = torch.where(kept, flat_e, 0)
    s_idx = torch.where(kept, slot, cap - 1)
    rows = torch.where(kept[:, None], x[tok_of_assign], 0)
    buffers = torch.zeros(n_exp, cap, d, dtype=x.dtype, device=x.device)
    buffers.index_put_((e_idx, s_idx), rows, accumulate=True)
    return buffers, (tok_of_assign, e_idx, s_idx, kept), drops


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def _axis_mean(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return t / axis_sizes(mesh)[axis]


def moe_ep_forward(params, x: torch.Tensor, top_k: int, mesh,
                   axis: str = "model", cap_factor: float = 1.25
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's share of the EP MoE over ``axis``.

    params: a ``MoEParams`` holding the replicated fp32 ``router`` (d, E)
    and this rank's ``E / tp`` experts of ``w_up``/``w_gate`` (e, d, f)
    and ``w_down`` (e, f, d), experts ``get_local_rank(axis) * e``
    onward; shared experts, if any, as ``params.shared``.  x: (B_l, S_l,
    d), this rank's tokens.  Returns (y (B_l, S_l, d), the dropped share
    of assignments averaged over the model, data and pod axes, fp32)."""
    sizes = axis_sizes(mesh)
    tp = sizes[axis]
    n_exp = params["router"].shape[1]
    if n_exp % tp:
        raise ValueError(f"{n_exp} experts not divisible by axis {tp}")
    e_local = n_exp // tp
    if params["w_up"].shape[0] != e_local:
        raise ValueError(f"w_up holds {params['w_up'].shape[0]} experts; "
                         f"a rank of {axis}={tp} holds {e_local}")
    Bl, Sl, d = x.shape
    T = Bl * Sl
    xt = x.reshape(T, d)
    gates, top_idx = route(params, xt, top_k)
    cap = max(1, int(cap_factor * T * top_k / n_exp))
    buffers, (tok_a, e_idx, s_idx, kept), drops = _bucket_by_expert(
        xt, top_idx, n_exp, cap)
    group = mesh.get_group(axis)
    # dispatch: chunk j of (tp, e_local, cap, d) to rank j; chunk i of
    # what comes back holds rank i's buckets for this rank's experts
    h = _all_to_all(buffers.reshape(tp, e_local, cap, d), group)
    up = h @ params["w_up"]                                # (tp, e, cap, f)
    if "w_gate" in params:
        up = F.silu(h @ params["w_gate"]) * up
    else:
        up = F.gelu(up, approximate="tanh")
    yv = up @ params["w_down"]                             # (tp, e, cap, d)
    yb = _all_to_all(yv, group).reshape(n_exp, cap, d)     # expert-major
    vals = yb[e_idx, s_idx]                                # (T*k, d)
    weight = gates.reshape(-1) * kept
    vals = vals * weight.to(vals.dtype)[:, None]
    y = torch.zeros(T, d, dtype=vals.dtype, device=x.device)
    y.index_add_(0, tok_a, vals)
    drop_frac = drops.float() / (T * top_k)
    drop_frac = _axis_mean(drop_frac, mesh, axis)
    for ax in ("pod", "data"):
        if ax in sizes:
            drop_frac = _axis_mean(drop_frac, mesh, ax)
    y = y.reshape(Bl, Sl, d).to(x.dtype)
    if getattr(params, "shared", None) is not None:
        y = y + mlp_forward(params.shared, x)
    return y, drop_frac
