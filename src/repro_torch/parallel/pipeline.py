"""GPipe-style pipeline parallelism (``repro/parallel/pipeline.py``).

The layer stack is split over a "stage" mesh axis; microbatches stream
through the stages with a ring handoff after every tick, on the classic
GPipe schedule of ``n_micro + n_stages - 1`` ticks: at tick t stage 0
ingests microbatch t (while any remain), every stage runs its layers on
the microbatch it holds, the last stage retires microbatch
``t - (n_stages - 1)``, and each stage passes its output to the next
(stage 0 receives the last stage's and overwrites it on ingest).  Every
stage runs every tick, as in the reference.  At the end the last stage's
outputs are summed over the stage axis, so every rank returns them.

Placing the "stage" axis on the pod boundary makes the handoff the only
inter-pod traffic; ``training/compress.py`` can quantise it.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .sharding import axis_sizes, make_mesh


def _ring_shift(y: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``ppermute`` over ``axis``, rank i -> (i + 1) % n; the identity at
    size 1, where no P2P op is issued."""
    n = axis_sizes(mesh)[axis]
    if n == 1:
        return y
    group = mesh.get_group(axis)
    i = mesh.get_local_rank(axis)
    to = dist.get_global_rank(group, (i + 1) % n)
    frm = dist.get_global_rank(group, (i - 1) % n)
    buf = torch.empty_like(y)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y.contiguous(), to, group),
        dist.P2POp(dist.irecv, buf, frm, group)])
    for r in reqs:
        r.wait()
    return buf


def pipeline_forward(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                     mesh, n_stages: int,
                     stage_axis: str = "stage") -> torch.Tensor:
    """Run microbatches through the pipeline.

    stage_fn(stage_params, x) -> x: this rank's stage's layers.
    stage_params: this rank's stage's parameters (not a stacked tree).
    x_micro: (n_micro, mb, ...) microbatched inputs, the same on every
    rank.  Returns (n_micro, mb, ...) outputs on every rank."""
    if axis_sizes(mesh)[stage_axis] != n_stages:
        raise ValueError(f"mesh axis {stage_axis!r} has "
                         f"{axis_sizes(mesh)[stage_axis]} ranks, not "
                         f"{n_stages} stages")
    n_micro = x_micro.shape[0]
    idx = mesh.get_local_rank(stage_axis)
    last = n_stages - 1
    state = torch.zeros_like(x_micro[0])        # in-flight microbatch
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        if idx == 0 and t < n_micro:
            state = x_micro[t]
        y = stage_fn(stage_params, state)
        done = t - last
        if idx == last and done >= 0:
            outs[done] = y
        state = _ring_shift(y, mesh, stage_axis)
    # only the last stage wrote ``outs``; share it
    dist.all_reduce(outs, op=dist.ReduceOp.SUM,
                    group=mesh.get_group(stage_axis))
    return outs


def make_pp_mesh(n_stages: int, tp: int = 1, device=None):
    """A ("stage", "model") mesh of the first n_stages * tp ranks."""
    return make_mesh((n_stages, tp), ("stage", "model"), device)
