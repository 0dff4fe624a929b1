"""Flash attention: the port of ``repro/kernels/flash_attention``
(``flash_attention_pallas``).

Full-sequence causal attention with an optional sliding window,
``q (B, Sq, Hq, D)`` against ``k/v (B, Skv, Hkv, D)``; the ``Hq // Hkv``
query heads of a kv head share its K/V (GQA) and ``q_offset`` is the
absolute position of ``q[:, 0]`` relative to ``k[:, 0]``.  Both versions
return ``(out, lse)``: ``out (B, Sq, Hq, D)`` in q's dtype and the
softmax's log-sum-exp ``lse (B, Hq, Sq)`` in fp32, which the backward
pass of ``layers.attention.blockwise_attention`` recomputes the
probabilities from.

``flash_attention`` launches a CUDA kernel of ``csrc/flash_attention.cu``
on CUDA tensors and runs the plain PyTorch version
``flash_attention_plain`` on CPU tensors.  The kernel follows the dtype:
bf16 runs on the tensor cores (wgmma, TMA copies; 128-row query tiles),
fp32 on the CUDA cores (64-row query tiles).  There is no fallback: CUDA
inputs the kernels do not take raise, and so does a failed launch or
tensor-map encode.  ``launches`` counts kernel launches in this process;
``grid`` gives a call's launch geometry.

A head dim the kernels are not built for (the REDUCED configs' 8 and 24,
zamba2's 112) runs zero-padded to the next one they are
(``padded_head_dim``; ``attend_padded``): q, k and v get zero columns,
the scale stays ``1/sqrt(D)`` of the true D, and ``out`` is sliced back.
Zero columns add nothing to ``q . k`` and give zero output columns, so
``out`` and ``lse`` are those of the unpadded call.  A value head dim Dv
below D (MLA: q and k 192 wide, v 128) pads v to the width of q and k
and slices ``out`` back to Dv.  The padding copies q, k and v once per
call, and only for such head dims.  A head dim above the largest
kernel's raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing

from . import build
from .build import PLAIN_DEVICES

launches = 0

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 10 + (
    ctypes.c_float, ctypes.c_void_p)
# (query rows per block, threads per block) of each kernel: bf16 has two
# consumer warpgroups and a producer warp, fp32 one 128-thread block
_TILES = {torch.bfloat16: (128, 288), torch.float32: (64, 128)}


def attention_mask(sq: int, skv: int, *, causal: bool,
                   window: Optional[int], q_offset: int,
                   device=None) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query row may attend to."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 masked softmax over the whole score matrix
    (``repro/kernels/flash_attention/ref.py``), plus its log-sum-exp.
    Scores are scaled by ``scale``, ``1/sqrt(D)`` unless given.

    Masked scores are ``NEG_INF`` and get probability 0, and the row sum
    is clamped at 1e-30 as in the kernel, so a row with no valid key
    yields 0 and a finite lse; ref.py yields the mean of V there.  Every
    other row agrees with ref.py."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    rep = Hq // Hkv
    kr = k.float().repeat_interleave(rep, dim=2)
    vr = v.float().repeat_interleave(rep, dim=2)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vr)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def padded_head_dim(d: int) -> int:
    """The head dim a call of head dim ``d`` runs at: the least of
    ``HEAD_DIMS`` that is ``>= d`` (8 -> 16, 24 -> 32, 112 -> 128,
    129 .. 256 -> 256).
    Raises ``ValueError`` above the largest."""
    for dim in HEAD_DIMS:
        if d <= dim:
            return dim
    raise ValueError(f"flash_attention kernel: head dim {d} above "
                     f"{HEAD_DIMS[-1]}, the largest of {HEAD_DIMS}")


def attend_padded(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fn(q, k, v, scale=1/sqrt(D), **kw)`` on q and k zero-padded along
    D, and v along its own head dim Dv, to one width,
    ``padded_head_dim(max(D, Dv))``, with ``out`` sliced back to Dv;
    ``fn`` returns ``(out, lse)`` as ``flash_attention_plain`` does.  No
    copy where D == Dv is a kernel's own."""
    D, Dv = q.shape[-1], v.shape[-1]
    width = padded_head_dim(max(D, Dv))
    if width != D:
        q, k = (F.pad(t, (0, width - D)) for t in (q, k))
    if width != Dv:
        v = F.pad(v, (0, width - Dv))
    out, lse = fn(q, k, v, scale=1.0 / math.sqrt(D), **kw)
    return (out[..., :Dv].contiguous() if width != Dv else out), lse


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: Optional[int], q_offset: int) -> None:
    """Raise ``ValueError`` on inputs the CUDA kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention kernel: q must be (B, Sq, Hq, D) "
                         "and k, v (B, Skv, Hkv, D)")
    B, Sq, Hq, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree "
                         f"(the kernel takes Dv == D)")
    Skv, Hkv = k.shape[1], k.shape[2]
    if Sq < 1 or Skv < 1 or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention kernel: Hq={Hq} must be a "
                         f"multiple of Hkv={Hkv}, Sq={Sq} and Skv={Skv} "
                         f">= 1")
    if not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"flash_attention kernel: group {Hq // Hkv} "
                         f"outside [1, {MAX_GROUP}]")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if B * Hq > 65535:
        raise ValueError(f"flash_attention kernel: B * Hq = {B * Hq} > "
                         f"65535")
    if q_offset < 0:
        raise ValueError(f"flash_attention kernel: q_offset {q_offset} < 0")
    if max(Sq, Skv) + q_offset >= 2 ** 30:
        raise ValueError("flash_attention kernel: sequence too long")
    if q.dtype == torch.bfloat16 and -(-Sq // _TILES[q.dtype][0]) > 65535:
        raise ValueError(f"flash_attention kernel: Sq {Sq} needs more than "
                         f"65535 query tiles")
    if window is not None and not 1 <= window < 2 ** 31:
        raise ValueError(f"flash_attention kernel: window {window} outside "
                         f"[1, 2**31)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: q/k/v dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype} must be one of "
                         f"{sorted(map(str, _DTYPE_CODES))}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} on "
                             f"{t.device}, q on {q.device}")
        # the bf16 kernel's TMA maps need 16-byte aligned bases (rows of
        # D >= 16 bf16 keep every stride a multiple of 16 bytes)
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: bf16 {name} must be "
                             f"16-byte aligned")


def grid(q: torch.Tensor) -> Tuple[Tuple[int, int], int]:
    """``((grid x, grid y), threads per block)`` of the kernel a call with
    this ``q (B, Sq, Hq, D)`` launches: ``(B * Hq, query tiles)`` in bf16
    (every head's longest tiles launch first), ``(query tiles, B * Hq)``
    in fp32."""
    B, Sq, Hq, _ = q.shape
    rows, threads = _TILES[q.dtype]
    tiles = -(-Sq // rows)
    if q.dtype == torch.bfloat16:
        return (B * Hq, tiles), threads
    return (tiles, B * Hq), threads


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of q (B, Sq, Hq, D) over k (B, Skv, Hkv, D) and v (B,
    Skv, Hkv, Dv).  Returns ``(out (B, Sq, Hq, Dv) in q's dtype, lse (B,
    Hq, Sq) fp32)``."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return attend_padded(_launch, q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            scale: float, causal: bool, window: Optional[int],
            q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    check_kernel_args(q, k, v, window, q_offset)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    fn = build.kernel("apex_flash_attention", _ARGTYPES)
    with tracing.span("kernel.flash_attention"):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, Sq, Skv, Hq, Hkv, D, q_offset,
                 int(causal), 0 if window is None else window,
                 _DTYPE_CODES[q.dtype], scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "apex_flash_attention")
    launches += 1
    return out, lse
