"""GQA and MLA attention (``repro/layers/attention.py``): the
full-sequence path for training and the decode step for serving.

  * ``gqa_attention`` (training) projects, rotates and attends through
    ``blockwise_attention``, whose forward is
    ``repro_torch.kernels.flash_attention`` (the hand-written CUDA kernel
    on CUDA tensors, its plain version on CPU tensors) and whose backward
    is plain PyTorch, as the reference's custom VJP is XLA code.
  * ``gqa_decode_step`` (serving) writes the new token's K/V into the
    cache, then attends through ``repro_torch.kernels.decode_attention``.
  * ``mla_attention`` and ``mla_decode_step`` are DeepSeek-V2's
    multi-head latent attention over a cache of one latent ``c_kv`` and
    one rotated RoPE key ``k_pe`` per token, which the step expands to
    per-head keys (192 wide) and values (128) through ``wukv``, as the
    reference does, and attends through the same two kernels (their
    wrappers pad v to the width of q and k).

``rope="mrope"`` (qwen2-vl) rotates q and k by (t, h, w) position ids
(``apply_mrope``); the decode step broadcasts a token's one position to
all three axes, as the reference does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.device import to_cache_dtype
from repro_torch.kernels import decode_attention as _attn_kernel
from repro_torch.kernels import flash_attention as _flash
from .hints import is_dtensor, on_shards, shard_offset, split_last
from .mlp import normal_param
from .rope import apply_mrope, apply_rope


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qkv_bias: bool = False,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> nn.ParameterDict:
    """Projection weights in the JAX layout (``x @ W``), same shapes and
    scales as the reference; biases start at zero."""
    s = 1.0 / math.sqrt(d_model)
    p = nn.ParameterDict({
        "wq": normal_param(gen, (d_model, n_heads * head_dim), s, dtype,
                           device),
        "wk": normal_param(gen, (d_model, n_kv_heads * head_dim), s, dtype,
                           device),
        "wv": normal_param(gen, (d_model, n_kv_heads * head_dim), s, dtype,
                           device),
        "wo": normal_param(gen, (n_heads * head_dim, d_model),
                           1.0 / math.sqrt(n_heads * head_dim), dtype,
                           device),
    })
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = nn.Parameter(
                torch.zeros(width * head_dim, dtype=dtype, device=device))
    return p


def _project_qkv(params: nn.ParameterDict, x: torch.Tensor, n_heads: int,
                 n_kv_heads: int, head_dim: int):
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (split_last(q, B, S, n_heads, head_dim),
            split_last(k, B, S, n_kv_heads, head_dim),
            split_last(v, B, S, n_kv_heads, head_dim))


class _BlockwiseAttention(torch.autograd.Function):
    """Flash forward (kernel or plain version), flash backward recomputed
    tile by tile from the saved lse (``attention.py:_bw_fwd/_bw_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block, q_offset):
        out, lse = _flash.flash_attention(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_block, kv_block, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = blockwise_attention_grads(q, k, v, out, lse, dout,
                                          *ctx.args)
        return (*grads, None, None, None, None, None)


def blockwise_attention_grads(q, k, v, out, lse, dout, causal: bool,
                              window: Optional[int], q_block: int,
                              kv_block: int, q_offset: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of attention from its output and lse: a copy of the
    reference's ``_bw_bwd``.  Per ``q_block x kv_block`` tile, ``p`` is
    recomputed as ``exp(s - lse)``; with ``Dsum = rowsum(dout * out)`` in
    fp32, ``ds = p (dout V^T - Dsum) scale``.  The GQA reps are folded
    onto the kv heads by the einsums.  All in fp32, cast back to the
    inputs' dtypes; memory is O(S) beyond one tile.

    The ragged last tiles are sliced, not padded, and tiles wholly
    outside the mask are skipped: they contribute exactly zero.  Masked
    scores get ``p = 0`` explicitly, as in the forward."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qb = min(q_block, max(Sq, 1))
    kb = min(kv_block, max(Skv, 1))
    qf = q.float().reshape(B, Sq, Hkv, rep, D)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(B, Sq, Hkv, rep, Dv)
    # D_i = rowsum(dout * out): (B, Hkv, rep, Sq)
    dsum = torch.einsum("bqgrd,bqgrd->bgrq", dof,
                        out.float().reshape(B, Sq, Hkv, rep, Dv))
    lse = lse.reshape(B, Hkv, rep, Sq)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0 in range(0, Skv, kb):
        k1 = min(k0 + kb, Skv)
        k_blk, v_blk = kf[:, k0:k1], vf[:, k0:k1]
        for q0 in range(0, Sq, qb):
            q1 = min(q0 + qb, Sq)
            if causal and k0 > q_offset + q1 - 1:
                continue
            if window is not None and k1 - 1 <= q_offset + q0 - window:
                continue
            mask = _flash.attention_mask(q1 - q0, k1 - k0, causal=causal,
                                         window=window,
                                         q_offset=q_offset + q0 - k0,
                                         device=q.device)
            q_blk, do_blk = qf[:, q0:q1], dof[:, q0:q1]
            s = torch.einsum("bqgrd,bkgd->bgrqk", q_blk, k_blk) * scale
            p = torch.exp(s - lse[..., q0:q1, None]).masked_fill(~mask, 0.0)
            dv[:, k0:k1] += torch.einsum("bgrqk,bqgrd->bkgd", p, do_blk)
            dp = torch.einsum("bqgrd,bkgd->bgrqk", do_blk, v_blk)
            ds = p * (dp - dsum[..., q0:q1, None]) * scale
            dq[:, q0:q1] += torch.einsum("bgrqk,bkgd->bqgrd", ds, k_blk)
            dk[:, k0:k1] += torch.einsum("bgrqk,bqgrd->bkgd", ds, q_blk)
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None, q_block: int = 512,
                        kv_block: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention without materializing the S x S scores.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0 (GQA).
    ``q_offset``: absolute position of q[:, 0] relative to k[:, 0].
    Returns (B, Sq, Hq, D) in q's dtype.  ``q_block``/``kv_block`` tile
    the backward pass; the forward is the flash kernel's own tiling.
    Differentiable: the backward recomputes p from the saved lse.

    On DTensors it runs on each rank's local shards (``on_shards``): the
    batch keeps its sharding, the heads theirs where the mesh dims on
    them divide Hq and Hkv alike, and every other dim is gathered."""
    roles = {"batch": 0, "heads": 2}
    return on_shards(
        lambda qs, ks, vs: _BlockwiseAttention.apply(
            qs, ks, vs, causal, window, q_block, kv_block, q_offset),
        (q, k, v), (roles, roles, roles), roles)


def gqa_attention(params: nn.ParameterDict, x: torch.Tensor,
                  positions: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                  head_dim: int, window: Optional[int] = None,
                  rope: str = "rope",
                  rope_theta: float = 10000.0) -> torch.Tensor:
    """Full-sequence GQA (training).  x: (B, S, d_model); positions:
    (B, S) absolute, or (B, S, 3) (t, h, w) ids under M-RoPE."""
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    if rope == "rope":
        q, k = apply_rope(q, k, positions, rope_theta)
    elif rope == "mrope":
        q, k = apply_mrope(q, k, positions, theta=rope_theta)
    elif rope != "none":
        raise NotImplementedError(f"rope={rope!r} is not ported yet")
    out = blockwise_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=True, window=window)
    B, S = x.shape[:2]
    return out.reshape(B, S, n_heads * head_dim) @ params["wo"]


def gqa_decode_step(params: nn.ParameterDict, x: torch.Tensor,
                    cache_k: torch.Tensor, cache_v: torch.Tensor,
                    cache_len: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, head_dim: int,
                    window: Optional[int] = None, rope: str = "rope",
                    rope_theta: float = 10000.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step.  x: (B, 1, d_model); cache_k/v: (B, Smax, Hkv, D);
    cache_len: (B,) ABSOLUTE sequence lengths so far.

    The new K/V row is written into ``cache_k``/``cache_v`` IN PLACE
    (indexed assignment where the reference returns an updated copy from
    ``dynamic_update_slice``); the caches are also returned, so the call
    reads like the reference.  The write slot is clamped to the last row,
    as ``dynamic_update_slice`` clamps its start index.

    Sliding-window layers use a RING cache: any cache of at most
    ``window + 16`` slots is a ring, written at ``cache_len % Smax``; K is
    rotated at its absolute position when written, so attention needs no
    further window mask.  Returns (y, cache_k, cache_v).
    """
    B = x.shape[0]
    Smax = cache_k.shape[1]
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    pos = cache_len[:, None]                               # (B, 1) absolute
    if rope == "rope":
        q, k = apply_rope(q, k, pos, rope_theta)
    elif rope == "mrope":
        q, k = apply_mrope(q, k, pos[..., None].expand(B, 1, 3),
                           theta=rope_theta)
    elif rope != "none":
        raise NotImplementedError(f"rope={rope!r} is not ported yet")
    ring = window is not None and Smax <= window + 16
    idx = cache_len % Smax if ring else cache_len.clamp(0, Smax - 1)
    write_cache_rows(cache_k, k[:, 0], idx)
    write_cache_rows(cache_v, v[:, 0], idx)
    n_valid = torch.clamp(cache_len + 1, max=Smax).to(torch.int32)
    out = attend_decode(q[:, 0].contiguous(), cache_k, cache_v, n_valid)
    y = out.reshape(B, 1, n_heads * head_dim) @ params["wo"]
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# the decode step's cache writes and attention, on one device or a mesh
# ---------------------------------------------------------------------------

def _batch_local(t: torch.Tensor, like) -> torch.Tensor:
    """This rank's rows of ``t`` (B, ...), a DTensor or a plain tensor
    that every rank holds whole, cut as the DTensor ``like`` cuts its
    batch dim 0."""
    mesh = like.device_mesh
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    want = [Shard(0) if p == Shard(0) else Replicate()
            for p in like.placements]
    return t.redistribute(mesh, want).to_local()


def write_cache_rows(cache: torch.Tensor, new: torch.Tensor,
                     idx: torch.Tensor) -> None:
    """``cache[b, idx[b]] = new[b]`` in place, for every row b, cast by
    ``to_cache_dtype``: cache (B, Smax, ...), new (B, ...), idx (B,).

    On a DTensor cache each rank writes its own shard (its batch rows
    whose slot falls in its sequence shard), in place; a cache sharded
    along any other dim raises.  The write is a ``where`` at a clamped
    slot, not a masked index, so meta tensors go through too."""
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = to_cache_dtype(new, cache.dtype)
        return
    for p in cache.placements:
        if not (isinstance(p, Replicate)
                or (isinstance(p, Shard) and p.dim in (0, 1))):
            raise ValueError(f"write_cache_rows: cache placements "
                             f"{cache.placements}: only the batch and "
                             f"sequence dims may be sharded")
    local = cache.to_local()
    new_l = _batch_local(new, cache)
    j = _batch_local(idx, cache) - shard_offset(cache, 1)[1]
    mine = (j >= 0) & (j < local.shape[1])
    j = j.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    keep = mine.reshape(-1, *([1] * (new_l.dim() - 1)))
    local[rows, j] = torch.where(keep, to_cache_dtype(new_l, local.dtype),
                                 local[rows, j])


def attend_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention of q (B, Hq, D) over the first ``lengths[b]``
    slots of k (B, Smax, Hkv, D), v (B, Smax, Hkv, Dv):
    ``kernels.decode_attention`` on plain tensors.

    On DTensors it runs on each rank's local shards (``on_shards``, the
    cache's placements first): the batch keeps its sharding, and so do
    the heads where the mesh dims on them divide Hq and Hkv.  Where the
    cache's sequence is sharded (``parallel.sharding.cache_pspecs`` puts
    it on "model"), the kernel runs over each rank's own slots and
    returns each row's log-sum-exp beside its output, by which the ranks
    merge their outputs (``parallel.sp_decode``, the reference's
    flash-decoding combine).  Elsewhere the kernel runs on the local
    shard."""
    if not is_dtensor(k):
        return _attn_kernel.decode_attention(q, k, v, lengths)
    seq_at, _ = shard_offset(k, 1)
    if len(seq_at) > 1:
        raise NotImplementedError("decode attention over a sequence "
                                  "sharded on more than one mesh dim")
    mesh = k.device_mesh

    def attend(qs, ks, vs, ls):
        if not seq_at:
            return _attn_kernel.decode_attention(qs, ks, vs, ls)
        from repro_torch.parallel.sp_decode import sp_decode_attention
        return sp_decode_attention(qs, ks, vs, ls, mesh,
                                   mesh.mesh_dim_names[seq_at[0]])

    # the cache first: its placements pick the roles, so it is never
    # gathered to suit q
    kv = {"batch": 0, "seq": 1, "heads": 2}
    return on_shards(lambda ks, vs, qs, ls: attend(qs, ks, vs, ls),
                     (k, v, q, lengths),
                     (kv, kv, {"batch": 0, "heads": 1}, {"batch": 0}),
                     {"batch": 0, "heads": 1})


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, d_model: int, n_heads: int,
             kv_lora_rank: int, qk_nope_head_dim: int = 128,
             qk_rope_head_dim: int = 64, v_head_dim: int = 128,
             dtype: torch.dtype = torch.bfloat16,
             device=None) -> nn.ParameterDict:
    """MLA weights with the reference's shapes and scales: ``wq`` (d, H
    (dn + dr)), ``wdkv`` (d, r + dr), ``wukv`` (r, H (dn + dv)), ``wo``
    (H dv, d)."""
    qk_head = qk_nope_head_dim + qk_rope_head_dim
    s = 1.0 / math.sqrt(d_model)
    return nn.ParameterDict({
        "wq": normal_param(gen, (d_model, n_heads * qk_head), s, dtype,
                           device),
        "wdkv": normal_param(gen, (d_model, kv_lora_rank + qk_rope_head_dim),
                             s, dtype, device),
        "wukv": normal_param(
            gen, (kv_lora_rank, n_heads * (qk_nope_head_dim + v_head_dim)),
            1.0 / math.sqrt(kv_lora_rank), dtype, device),
        "wo": normal_param(gen, (n_heads * v_head_dim, d_model),
                           1.0 / math.sqrt(n_heads * v_head_dim), dtype,
                           device),
    })


def _mla_expand(params: nn.ParameterDict, c_kv: torch.Tensor, n_heads: int,
                qk_nope: int, v_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latents (B, S, r) -> per-head ``k_nope`` (B, S, H, dn) and ``v``
    (B, S, H, dv): one product with ``wukv``, then views of it."""
    B, S, _ = c_kv.shape
    if is_dtensor(c_kv) and shard_offset(c_kv, 1)[0]:
        # a sequence-sharded latent cache expands on each rank's own
        # slots (the product's (B S, r) view cannot flatten a sharded
        # sequence, torch 2.11)
        slots = {"batch": 0, "seq": 1}
        u = on_shards(torch.matmul, (c_kv, params["wukv"]), (slots, {}),
                      slots)
    else:
        u = c_kv @ params["wukv"]
    u = split_last(u, B, S, n_heads, qk_nope + v_dim)
    return u[..., :qk_nope], u[..., qk_nope:]


def _mla_keys(k_nope: torch.Tensor, k_pe: torch.Tensor) -> torch.Tensor:
    """``cat(k_nope, k_pe)``: every head's key, with the one RoPE key
    ``k_pe`` (B, S, dr) shared by the heads."""
    B, S, H, _ = k_nope.shape
    return torch.cat([k_nope, k_pe[:, :, None, :].expand(
        B, S, H, k_pe.shape[-1])], dim=-1)


def mla_attention(params: nn.ParameterDict, x: torch.Tensor,
                  positions: torch.Tensor, *, n_heads: int,
                  kv_lora_rank: int, qk_nope_head_dim: int = 128,
                  qk_rope_head_dim: int = 64, v_head_dim: int = 128,
                  rope_theta: float = 10000.0) -> torch.Tensor:
    """Full-sequence MLA.  x: (B, S, d_model); positions: (B, S).  The
    latents expand to per-head keys ``cat(k_nope, k_pe)`` and values;
    ``blockwise_attention`` then runs with D = dn + dr, Dv = dv and the
    scale ``1/sqrt(dn + dr)``."""
    B, S, _ = x.shape
    qk_head = qk_nope_head_dim + qk_rope_head_dim
    q = split_last(x @ params["wq"], B, S, n_heads, qk_head)
    q_nope, q_pe = q[..., :qk_nope_head_dim], q[..., qk_nope_head_dim:]
    dkv = x @ params["wdkv"]                               # (B, S, r + dr)
    c_kv, k_pe = dkv[..., :kv_lora_rank], dkv[..., kv_lora_rank:]
    q_pe, k_pe = apply_rope(q_pe, k_pe[:, :, None, :], positions, rope_theta)
    k_nope, v = _mla_expand(params, c_kv, n_heads, qk_nope_head_dim,
                            v_head_dim)
    k = _mla_keys(k_nope, k_pe[:, :, 0])
    q = torch.cat([q_nope, q_pe], dim=-1)
    out = blockwise_attention(q, k, v, causal=True, window=None)
    return out.reshape(B, S, n_heads * v_head_dim) @ params["wo"]


def mla_decode_step(params: nn.ParameterDict, x: torch.Tensor,
                    cache_c: torch.Tensor, cache_kpe: torch.Tensor,
                    cache_len: torch.Tensor, *, n_heads: int,
                    kv_lora_rank: int, qk_nope_head_dim: int = 128,
                    qk_rope_head_dim: int = 64, v_head_dim: int = 128,
                    rope_theta: float = 10000.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over the compressed cache.  x: (B, 1, d_model);
    cache_c: (B, Smax, r) latents; cache_kpe: (B, Smax, dr) rotated RoPE
    keys; cache_len: (B,) absolute lengths so far.

    The new latent and rotated RoPE key are written IN PLACE at
    ``cache_len``, clamped to the last slot as ``dynamic_update_slice``
    clamps.  Then, as the reference does, the whole latent cache expands
    through ``wukv`` to per-head ``k_nope`` and ``v``, and the query
    ``cat(q_nope, q_pe)`` (B, H, dn + dr) attends to the keys
    ``cat(k_nope, k_pe)`` (B, Smax, H, dn + dr) and values (B, Smax, H,
    dv) over the first ``min(cache_len + 1, Smax)`` slots through
    ``kernels.decode_attention`` (Hkv = H, group 1; scale
    ``1/sqrt(dn + dr)``): the reference's two score einsums summed, in
    fp32.  ``v`` is a strided view of the expansion; the wrapper's padding
    of v to the width of q and k copies it into a contiguous tensor.
    Returns (y, cache_c, cache_kpe)."""
    B = x.shape[0]
    Smax = cache_c.shape[1]
    qk_head = qk_nope_head_dim + qk_rope_head_dim
    q = split_last(x @ params["wq"], B, 1, n_heads, qk_head)
    q_nope, q_pe = q[..., :qk_nope_head_dim], q[..., qk_nope_head_dim:]
    dkv = x @ params["wdkv"]
    c_new, kpe_new = dkv[..., :kv_lora_rank], dkv[..., kv_lora_rank:]
    q_pe, kpe_rot = apply_rope(q_pe, kpe_new[:, :, None, :],
                               cache_len[:, None], rope_theta)
    idx = cache_len.clamp(0, Smax - 1)
    write_cache_rows(cache_c, c_new[:, 0], idx)
    write_cache_rows(cache_kpe, kpe_rot[:, 0, 0], idx)
    k_nope, v = _mla_expand(params, cache_c.to(x.dtype), n_heads,
                            qk_nope_head_dim, v_head_dim)
    k = _mla_keys(k_nope, cache_kpe.to(x.dtype))
    q = torch.cat([q_nope, q_pe], dim=-1)[:, 0]
    n_valid = torch.clamp(cache_len + 1, max=Smax).to(torch.int32)
    out = attend_decode(q, k, v, n_valid)
    y = out.reshape(B, 1, n_heads * v_head_dim) @ params["wo"]
    return y, cache_c, cache_kpe
