"""Sequence-parallel decode attention (``repro/parallel/sp_decode.py``):
the flash-decoding combine across the "model" axis.

KV caches are sequence-sharded over "model" (``parallel/sharding.py``).
Each rank attends over its own slice of the cache with the decode
kernel (``kernels.decode_attention``, its plain version on CPU tensors),
which also returns each row's log-sum-exp ``lse_i`` of its scaled
scores, and the ranks combine with a log-sum-exp reduction:

    L* = max_i lse_i,  out = sum_i(out_i e^{lse_i - L*}) / sum_i e^{lse_i - L*}

so a step moves O(B Hq D) reduced bytes instead of gathering O(S kv_dim)
cache bytes.  The reference's partial is plain XLA over fp32 (m, l, acc)
states; ``out_i e^{lse_i}`` is its ``acc_i e^{m_i}``, so the combine is
the same function.  The partial outputs come back in q's dtype: a bf16
call rounds each rank's output once before the fp32 combine.

A rank whose slice holds no valid slot gives lse = -1e30 (the kernel
writes 0 for its output, the plain version the mean of its v rows): its
weight e^{lse - L*} is 0 once any rank holds a valid slot.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import decode_attention as _kernel


def _partial(q, k, v, n):
    """One rank's attention over its slots: (out (B, Hq, Dv) in q's
    dtype, lse (B, Hq) fp32), ``n`` (B,) int32 its valid slots."""
    return _kernel.decode_attention(q, k, v, n, with_lse=True)


def sp_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, lengths: torch.Tensor,
                        mesh, axis: str = "model") -> torch.Tensor:
    """One rank's share of sequence-parallel decode attention.

    q: (B, Hq, D), one token per sequence; cache_k/v: (B, s_local, Hkv, D),
    this rank's slots ``get_local_rank(axis) * s_local`` onward of caches
    of ``s_local * mesh[axis]`` slots; lengths: (B,) valid lengths.  B is
    the rank's batch shard (the data axes split it).  Returns (B, Hq, Dv)
    in q's dtype, the same on every rank of ``axis``."""
    s_local = cache_k.shape[1]
    base = mesh.get_local_rank(axis) * s_local
    n = (lengths - base).clamp(0, s_local).to(torch.int32)
    out, lse = _partial(q.contiguous(), cache_k.contiguous(),
                        cache_v.contiguous(), n)
    group = mesh.get_group(axis)
    lse_star = lse.clone()
    dist.all_reduce(lse_star, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - lse_star)
    num = out.float() * w[..., None]
    den = w
    dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(den, op=dist.ReduceOp.SUM, group=group)
    out = num / torch.clamp_min(den, 1e-30)[..., None]
    return out.to(q.dtype)
