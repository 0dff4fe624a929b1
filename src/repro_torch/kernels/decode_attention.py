"""Decode attention: the port of ``repro/kernels/decode_attention``
(``decode_attention_pallas``).

One new query token per sequence, ``q (B, Hq, D)``, against caches
``k/v (B, Smax, Hkv, D)`` with ``lengths (B,)`` valid slots each; the
``Hq // Hkv`` query heads of a kv head share its K/V (GQA).

``decode_attention`` launches the CUDA kernel of
``csrc/decode_attention.cuh`` (instances in ``decode_attention*.cu``) on
CUDA tensors and runs the plain PyTorch version
``decode_attention_plain`` on CPU tensors.  There is no fallback:
CUDA inputs the kernel does not take raise.  ``launches`` counts kernel
launches in this process, one per call: the kernel splits the cache into
spans over a (splits, Hkv, B) grid (``split_plan``, ``grid``) and merges
the spans' partial softmax states itself.

A head dim the kernel is not built for (the REDUCED configs' 8, 16 and
24; 32; zamba2's 112) runs zero-padded to the next one it is
(``padded_head_dim``; ``attend_padded``), with the scale ``1/sqrt(D)`` of
the true D and the output sliced back: zero columns add nothing to
``q . k`` and give zero output columns.  The kernel takes one head dim
for q, k and v, so a value head dim Dv below D (MLA: q and k 192 wide, v
128) pads v to the same width as q and k and slices the output back to
Dv.  Cost: the padding copies the whole K/V cache on every call, 64 / D
times its bytes, so it is for the REDUCED configs and MLA (192 and 128
to 256); the other FULL configs' head dims (64, 128, gemma3's 256) copy
nothing.  Head dim 512, the latent width at which the simulator prices
MLA's decode (``core.profiles``), is built for group 1 only
(``max_group``); a head dim above 512 raises.

An fp8 cache (k and v ``float8_e4m3fn``, the serving mode of
``init_cache(cache_dtype=torch.float8_e4m3fn)``) takes an instance of
its own, ``csrc/decode_attention_fp8.cu``: q and the output bf16, head
dim 128 (``FP8_HEAD_DIMS``), groups 1-8.  It reads each e4m3 value once
and converts it in registers; the reference upcasts the cache to the
compute dtype before its einsums, and e4m3 -> bf16 -> fp32 is exact, so
the function is the same.  The plain version's ``.float()`` of an e4m3
tensor is exact too.  Any other mix of dtypes with an fp8 cache raises,
and nothing is padded for it.  ``variant_launches`` counts its launches
under ``(128, group, "e4m3")``.

``with_lse`` asks every instance for each row's log-sum-exp beside its
output: where a cache's sequence is sharded, each rank runs the kernel
over its own slots and the ranks merge the outputs by it
(``parallel.sp_decode``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing

from . import build
from .build import PLAIN_DEVICES

launches = 0
# launches by the kernel instance they took, (head dim as launched,
# group), so a run can show which one its path took
variant_launches: Dict[Tuple[int, int], int] = {}

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256, 512)
MAX_GROUP = 8
# D 512 takes one query head a kv head: at group 8 its block would hold
# 86 KB of static shared memory, past the 48 KB allowed
WIDE_HEAD_DIM = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8 + (
    ctypes.c_float, ctypes.c_void_p)
FP8 = torch.float8_e4m3fn
FP8_HEAD_DIMS = (128,)
_FP8_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7 + (
    ctypes.c_float, ctypes.c_void_p)
SPAN_QUANTUM = 128  # 4 warps x 32-slot tiles: every warp gets whole tiles
MAX_SPLITS = 64     # spans the last block of a row merges (kMaxSplits)
BLOCKS_PER_SM = 4   # the split grid aims at this many blocks per SM
# per (device, stream): int32 tickets of the in-kernel combine, zeroed
# once; every launch leaves them zero
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
# buffers a larger one replaced: a CUDA graph captured on their stream
# still launches with their address
_retired: List[torch.Tensor] = []


def split_plan(smax: int, rows: int, sm_count: int) -> Tuple[int, int]:
    """``(span, splits)`` for caches of ``smax`` slots and ``rows = B *
    Hkv`` (b, kv head) pairs on a card of ``sm_count`` SMs: enough spans
    that ``rows * splits`` blocks fill the card (``BLOCKS_PER_SM`` per
    SM), at most ``MAX_SPLITS``, each a multiple of ``SPAN_QUANTUM`` and
    together covering ``smax`` (span * splits >= smax, every span but the
    last full)."""
    if smax < 1 or rows < 1 or sm_count < 1:
        raise ValueError(f"split_plan: smax {smax}, rows {rows}, sm_count "
                         f"{sm_count} must be >= 1")
    want = -(-BLOCKS_PER_SM * sm_count // rows)
    splits = min(MAX_SPLITS, want, -(-smax // SPAN_QUANTUM))
    span = -(-smax // splits)
    span = -(-span // SPAN_QUANTUM) * SPAN_QUANTUM
    return span, -(-smax // span)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int, int]:
    """``(splits, Hkv, B)``: the blocks a call on CUDA tensors ``q (B, Hq,
    D)``, ``k (B, Smax, Hkv, D)`` launches (128 threads each)."""
    B, Smax, Hkv = k.shape[0], k.shape[1], k.shape[2]
    return split_plan(Smax, B * Hkv, _sm_count(q.device))[1], Hkv, B


def _ticket_buffer(device: torch.device, stream: int,
                   n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           scale: Optional[float] = None,
                           with_lse: bool = False):
    """fp32 softmax attention over the first ``lengths[b]`` slots
    (``repro/kernels/decode_attention/ref.py``), scores scaled by
    ``scale`` (``1/sqrt(D)`` unless given).  Returns (B, Hq, Dv), and
    with ``with_lse`` also each row's log-sum-exp of its scaled scores,
    fp32 (B, Hq).

    Agrees with the kernel for ``lengths >= 1``, all that decoding gives
    it.  A row with no valid slot yields the mean of V here, as in the
    reference, and 0 in the kernel, as in the TPU kernel; its log-sum-exp
    is -1e30 in both (here -1e30 + log Smax, the same float), so a merge
    by log-sum-exp gives it no weight beside a row that has a valid
    slot."""
    B, Hq, D = q.shape
    _, Smax, Hkv, Dv = v.shape
    rep = Hq // Hkv
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kr.float()) * scale
    valid = torch.arange(Smax, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, vr.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out


def max_group(d: int) -> int:
    """The largest group (query heads a kv head) the kernel takes at head
    dim ``d`` of ``HEAD_DIMS``: 1 at ``WIDE_HEAD_DIM``, else
    ``MAX_GROUP``."""
    return 1 if d == WIDE_HEAD_DIM else MAX_GROUP


def padded_head_dim(d: int) -> int:
    """The head dim a call of head dim ``d`` runs at: the least of
    ``HEAD_DIMS`` that is ``>= d`` (8, 16, 24, 32 -> 64; 112 -> 128;
    129 .. 256 -> 256; 257 .. 512 -> 512, group 1 only).
    Raises ``ValueError`` above the largest."""
    for dim in HEAD_DIMS:
        if d <= dim:
            return dim
    raise ValueError(f"decode_attention kernel: head dim {d} above "
                     f"{HEAD_DIMS[-1]}, the largest of {HEAD_DIMS}")


def attend_padded(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v, lengths, scale=1/sqrt(D))`` on q and k zero-padded
    along D, and v along its own head dim Dv, to one width,
    ``padded_head_dim(max(D, Dv))``; the output sliced back to Dv (the
    first of ``fn``'s outputs where it returns a tuple).  No copy where
    D == Dv is the kernel's own."""
    D, Dv = q.shape[-1], v.shape[-1]
    width = padded_head_dim(max(D, Dv))
    if width != D:
        q, k = (F.pad(t, (0, width - D)) for t in (q, k))
    if width != Dv:
        v = F.pad(v, (0, width - Dv))
    res = fn(q, k, v, lengths, scale=1.0 / math.sqrt(D))
    out, *rest = res if isinstance(res, tuple) else (res,)
    if width != Dv:
        out = out[..., :Dv].contiguous()
    return (out, *rest) if rest else out


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
    if not 1 <= Hq // Hkv <= max_group(D):
        raise ValueError(f"decode_attention kernel: group {Hq // Hkv} "
                         f"outside [1, {max_group(D)}] at head dim {D}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if k.dtype == FP8 or v.dtype == FP8:
        if q.dtype != torch.bfloat16 or k.dtype != FP8 or v.dtype != FP8 \
                or D not in FP8_HEAD_DIMS:
            raise ValueError(f"decode_attention kernel: the fp8 instance "
                             f"takes q bf16, k/v {FP8} at head dim "
                             f"{FP8_HEAD_DIMS}; got q/k/v "
                             f"{q.dtype}/{k.dtype}/{v.dtype} at {D}")
    elif q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"decode_attention kernel: q/k/v dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype} must be one of "
                         f"{sorted(map(str, _DTYPE_CODES))}")
    if not 1 <= B <= 65535:
        raise ValueError(f"decode_attention kernel: batch {B} outside "
                         f"[1, 65535]")
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
                     lengths: torch.Tensor, with_lse: bool = False):
    """Attention of q (B, Hq, D) over the first lengths[b] slots of
    k (B, Smax, Hkv, D) and v (B, Smax, Hkv, Dv).  Returns (B, Hq, Dv) in
    q's dtype; with ``with_lse`` also each row's log-sum-exp of its
    scaled scores, fp32 (B, Hq), by which outputs over disjoint slot
    ranges merge (``parallel.sp_decode``)."""
    if q.device.type in PLAIN_DEVICES:
        return decode_attention_plain(q, k, v, lengths, with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if k.dtype == FP8:
        # the fp8 instance's head dim is the cache's own: nothing pads
        return _launch(q, k, v, lengths, scale=1.0 / math.sqrt(q.shape[-1]),
                       with_lse=with_lse)
    return attend_padded(functools.partial(_launch, with_lse=with_lse),
                         q, k, v, lengths)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor, scale: float, with_lse: bool = False):
    global launches
    check_kernel_args(q, k, v, lengths)
    B, Hq, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    span, splits = split_plan(Smax, B * Hkv, _sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, dtype=torch.float32, device=q.device) \
        if with_lse else None
    ws = tickets = None
    if splits > 1:
        ws = torch.empty(B * Hkv * splits * group * (D + 2),
                         dtype=torch.float32, device=q.device)
        tickets = _ticket_buffer(q.device, stream, B * Hkv)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Hkv, group, Smax, D,
            span, splits)
    if k.dtype == FP8:
        name, key = "apex_decode_attention_fp8", (D, group, "e4m3")
        fn, args = build.kernel(name, _FP8_ARGTYPES), (*ptrs, scale, stream)
    else:
        name, key = "apex_decode_attention", (D, group)
        fn = build.kernel(name, _ARGTYPES)
        args = (*ptrs, _DTYPE_CODES[q.dtype], scale, stream)
    with tracing.span("kernel.decode_attention"):
        err = fn(*args)
    build.check(err, name)
    launches += 1
    variant_launches[key] = variant_launches.get(key, 0) + 1
    return (out, lse) if with_lse else out
