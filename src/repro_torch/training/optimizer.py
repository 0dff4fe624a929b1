"""AdamW with fp32 master weights (``repro/training/optimizer.py``).

State: ``master``, ``m`` and ``v`` map each parameter name to an fp32
tensor; ``step`` is a 0-d int32 tensor on the host.  The update follows
the reference line for line: a global-norm clip taken in fp32 over every
gradient, bias-corrected moments, weight decay applied to the fp32
master inside the learning-rate product (``torch.optim.AdamW`` applies
it elsewhere), and the parameters re-cast from the masters.  Unlike the
reference's pure function, the update writes the moments, the masters
and the parameters in place, which saves a copy of each at full size,
and it works through the leaves in groups of at most ``GROUP_ELEMS``
elements, so its fp32 temporaries (the scaled gradients, the
denominators, the updates) take a group's size, not the model's (one
fp32 copy of mamba2-2.7b's parameters is 10 GiB).  Every operation is
elementwise, so the grouping changes no number.  Leaves of any float dtype go through,
bf16 and fp32 alike in one model.
"""

from __future__ import annotations

import math
from typing import List, Mapping, NamedTuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]

GROUP_ELEMS = 1 << 28            # 1 GiB of fp32 per group of leaves


class AdamWState(NamedTuple):
    master: dict
    m: dict
    v: dict
    step: torch.Tensor


def _named(params: Params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _groups(master: Mapping[str, torch.Tensor]) -> List[List[str]]:
    """The leaf names in order, cut into runs of at most ``GROUP_ELEMS``
    elements (a larger leaf makes a group of its own)."""
    groups: List[List[str]] = [[]]
    size = 0
    for n, w in master.items():
        if groups[-1] and size + w.numel() > GROUP_ELEMS:
            groups.append([])
            size = 0
        groups[-1].append(n)
        size += w.numel()
    return groups


def adamw_init(params: Params) -> AdamWState:
    """fp32 masters copied from ``params``, zero moments, step 0."""
    master = {n: p.detach().float().clone()
              for n, p in _named(params).items()}
    return AdamWState(
        master=master,
        m={n: torch.zeros_like(w) for n, w in master.items()},
        v={n: torch.zeros_like(w) for n, w in master.items()},
        step=torch.zeros((), dtype=torch.int32))


@torch.no_grad()
def adamw_update(params: Params, grads: Mapping[str, torch.Tensor],
                 state: AdamWState, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step.  ``grads`` maps every parameter name to its
    gradient (any float dtype).  Returns ``(params, state, metrics)``
    with ``metrics["grad_norm"]`` (fp32, before the clip) and
    ``metrics["step"]``; params and state are updated in place."""
    named = _named(params)
    groups = _groups(state.master)
    step = state.step + 1
    norms = []
    for names in groups:
        norms.extend(torch._foreach_norm([grads[n].float() for n in names]))
    gnorm = torch.stack(norms).square().sum().sqrt()
    scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
    bc1 = 1.0 - b1 ** int(step)
    bc2 = 1.0 - b2 ** int(step)
    for names in groups:
        g32 = torch._foreach_mul([grads[n].float() for n in names], scale)
        m = [state.m[n] for n in names]
        v = [state.v[n] for n in names]
        master = [state.master[n] for n in names]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g32, g32, value=1 - b2)
        del g32
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, master, alpha=weight_decay)
        torch._foreach_add_(master, upd, alpha=-lr)
        del upd
        for n, w in zip(names, master):
            named[n].copy_(w)
    new_state = AdamWState(master=state.master, m=state.m, v=state.v,
                           step=step)
    return params, new_state, {"grad_norm": gnorm, "step": step}


def cosine_lr(step, peak_lr: float = 3e-4, warmup: int = 100,
              total: int = 10000, floor: float = 0.1) -> float:
    """Linear warmup, then cosine decay to ``floor * peak_lr``."""
    s = float(step)
    if s < warmup:
        return peak_lr * s / max(warmup, 1)
    prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi
                                                               * prog)))
