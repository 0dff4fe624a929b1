"""Sequence-parallel decode attention (``repro/parallel/sp_decode.py``):
the flash-decoding combine across the "model" axis.

KV caches are sequence-sharded over "model" (``parallel/sharding.py``).
Each rank computes a PARTIAL online softmax over its own slice of the
cache, and the ranks combine with a log-sum-exp reduction:

    m* = max_i m_i,  out = sum_i(acc_i e^{m_i - m*}) / sum_i(l_i e^{m_i - m*})

so a step moves O(B Hq D) reduced bytes instead of gathering O(S kv_dim)
cache bytes.  The partial is plain torch, as the reference's is plain
XLA: fp32 scores and accumulators over the rank's slots.

A rank whose slice holds no valid slot gives m = NEG_INF, l = s_local and
acc = sum of its v rows (every score is the same -1e30).  This is
harmless only because its weight e^{m - m*} is 0 once any rank holds a
valid slot; the port mirrors the reference here and does not special-case
it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _partial_softmax(q, k, v, valid):
    """Per-rank partial attention.  q: (B, Hq, D); k/v: (B, Sl, Hkv, D);
    valid: (B, Sl) bool.  Returns (m (B, Hq), l (B, Hq), acc (B, Hq,
    Dv)), fp32; q head h reads kv head h // (Hq // Hkv)."""
    B, Hq, D = q.shape
    Sl, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qg = q.float().reshape(B, Hkv, rep, D)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k.float()) / math.sqrt(D)
    s = s.reshape(B, Hq, Sl)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                     # (B, Hq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bgrk,bkgd->bgrd", p.reshape(B, Hkv, rep, Sl),
                       v.float())
    return m, l, acc.reshape(B, Hq, v.shape[-1])


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
    slots = base + torch.arange(s_local, device=q.device)[None, :]
    valid = slots < lengths[:, None]
    m, l, acc = _partial_softmax(q, cache_k, cache_v, valid)
    group = mesh.get_group(axis)
    m_star = m.clone()
    dist.all_reduce(m_star, op=dist.ReduceOp.MAX, group=group)
    alpha = torch.exp(m - m_star)
    num = acc * alpha[..., None]
    den = l * alpha
    dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(den, op=dist.ReduceOp.SUM, group=group)
    out = num / torch.clamp_min(den, 1e-30)[..., None]
    return out.to(q.dtype)
