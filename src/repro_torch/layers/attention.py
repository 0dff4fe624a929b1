"""GQA attention, decode half (``repro/layers/attention.py:305-367``).

``gqa_decode_step`` writes the new token's K/V into the cache, then
attends through ``repro_torch.kernels.decode_attention``: the hand-written
CUDA kernel on CUDA tensors, its plain version on CPU tensors.  The
full-sequence ``gqa_attention``/``blockwise_attention`` (the flash
kernel's slice) and MLA come in later slices.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import decode_attention as _attn_kernel
from .mlp import normal_param
from .rope import apply_rope


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
                torch.zeros(width * head_dim, dtype=dtype, device=device),
                requires_grad=False)
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
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv_heads, head_dim),
            v.reshape(B, S, n_kv_heads, head_dim))


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
    elif rope != "none":
        raise NotImplementedError(f"rope={rope!r} is not ported yet")
    ring = window is not None and Smax <= window + 16
    idx = cache_len % Smax if ring else cache_len.clamp(0, Smax - 1)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, idx] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, idx] = v[:, 0].to(cache_v.dtype)
    n_valid = torch.clamp(cache_len + 1, max=Smax).to(torch.int32)
    out = _attn_kernel.decode_attention(q[:, 0].contiguous(), cache_k,
                                        cache_v, n_valid)
    y = out.reshape(B, 1, n_heads * head_dim) @ params["wo"]
    return y, cache_k, cache_v
