"""Decode attention: the port of ``repro/kernels/decode_attention``
(``decode_attention_pallas``).

One new query token per sequence, ``q (B, Hq, D)``, against caches
``k/v (B, Smax, Hkv, D)`` with ``lengths (B,)`` valid slots each; the
``Hq // Hkv`` query heads of a kv head share its K/V (GQA).

``decode_attention`` launches the CUDA kernel of
``csrc/decode_attention.cu`` on CUDA tensors and runs the plain PyTorch
version ``decode_attention_plain`` on CPU tensors.  There is no fallback:
CUDA inputs the kernel does not take raise.  ``launches`` counts kernel
launches in this process.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

launches = 0

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_GROUP = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_void_p)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """fp32 softmax attention over the first ``lengths[b]`` slots
    (``repro/kernels/decode_attention/ref.py``).  Returns (B, Hq, Dv).

    Agrees with the kernel for ``lengths >= 1``, all that decoding gives
    it.  A row with no valid slot yields the mean of V here, as in the
    reference, and 0 in the kernel, as in the TPU kernel."""
    B, Hq, D = q.shape
    _, Smax, Hkv, Dv = v.shape
    rep = Hq // Hkv
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kr.float()) / math.sqrt(D)
    valid = torch.arange(Smax, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, vr.float())
    return out.to(q.dtype)


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor) -> None:
    """Raise ``ValueError`` on inputs the CUDA kernel does not take."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention kernel: q must be (B, Hq, D) and "
                         "k, v (B, Smax, Hkv, D)")
    B, Hq, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"decode_attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree "
                         f"(the kernel takes Dv == D)")
    Smax, Hkv = k.shape[1], k.shape[2]
    if Smax < 1 or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"decode_attention kernel: Hq={Hq} must be a "
                         f"multiple of Hkv={Hkv}, Smax={Smax} >= 1")
    if not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"decode_attention kernel: group {Hq // Hkv} "
                         f"outside [1, {MAX_GROUP}]")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if not 1 <= B <= 65535:
        raise ValueError(f"decode_attention kernel: batch {B} outside "
                         f"[1, 65535]")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"decode_attention kernel: q/k/v dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype} must be one of "
                         f"{sorted(map(str, _DTYPE_CODES))}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"decode_attention kernel: lengths must be int32 "
                         f"({B},), got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention kernel: k and v must be 16-byte "
                         "aligned")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention kernel: {name} must be "
                             f"contiguous")
        if t.device != q.device:
            raise ValueError(f"decode_attention kernel: {name} on "
                             f"{t.device}, q on {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Attention of q (B, Hq, D) over the first lengths[b] slots of
    k/v (B, Smax, Hkv, D).  Returns (B, Hq, D) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    check_kernel_args(q, k, v, lengths)
    B, Hq, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = build.kernel("apex_decode_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), B, Hkv, Hq // Hkv, Smax, D,
             _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "apex_decode_attention")
    launches += 1
    return out
