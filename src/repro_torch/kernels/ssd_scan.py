"""SSD scan: the port of ``repro/kernels/ssd_scan`` (``ssd_scan_pallas``).

The Mamba2 chunked scan without the D-skip term (``layers.ssm`` adds it):
``x (B, S, H, P)``, softplus-activated ``dt (B, S, H)`` fp32, ``a_log
(H,)`` fp32 and ``b, c (B, S, N)`` (one group) give ``y (B, S, H, P)`` in
x's dtype.  Per (b, h), chunk after chunk of ``Q = min(chunk, S)`` rows,
the sequence padded with zero rows to a multiple of Q, in fp32::

    cum = cumsum(dt * A),  A = -exp(a_log)
    y   = ((C B^T) o L) @ (dt x) + exp(cum) o (C h^T),
          L[i, j] = exp(cum_i - cum_j) for j <= i, else 0
    h  <- exp(cum_last) h + (dt x exp(cum_last - cum))^T B

with the (P, N) state h carried from one chunk to the next, rounded to
x's dtype once at the end.

``ssd_scan`` launches a CUDA kernel of ``csrc/ssd_scan.cu`` on CUDA
tensors and runs the plain PyTorch version ``ssd_scan_plain`` on CPU
tensors.  Two kernels, picked by ``variant`` (a written rule, not a
fallback): ``"wgmma"`` (tensor cores and TMA) for bf16 x, b and c at
chunk 128 with head dim 32 or 64 and state dim 16, 32, 64 or 128, which
is mamba2-2.7b's training and mamba2 REDUCED's; ``"cuda_cores"`` (fp32
FMAs) for every other call, fp32 and other chunks among them.  CUDA
inputs neither takes raise.  ``launches`` counts kernel launches in this
process (forward launches only), one per call whichever kernel runs.

A head dim above ``PANEL_P`` = 64, up to ``MAX_P`` (zamba2's 112), runs
as panels of 64 (``split_panels``, ``merge_panels``): x is zero-padded
to a multiple of 64 and viewed as ``P_pad / 64`` heads of 64 per head,
each panel taking its head's dt and a_log.  That is exact: every column
of x has its own row of the ``(P, N)`` state and its own output column,
and B, C, dt and A are shared by all columns of a head, so a zero column
gives a zero output column.  The panels go through one launch, on the
kernel ``variant`` picks for a head dim of 64; the output is sliced back
to P.  Cost: the pad and the slice copy x and y once per call.

Gradient: on CUDA the kernel sits in a ``torch.autograd.Function`` whose
backward, ``ssd_scan_grads``, runs ``ssd_scan_plain`` again under
autograd and differentiates it.  The TPU kernel has no backward either:
the reference differentiates its chunked scan (``repro/layers/ssm.py``,
``ssd_chunked``) with XLA autodiff.  On the CPU autograd differentiates
``ssd_scan_plain`` itself.

``ssd_scan_sequential`` is a copy of ``ref.py``'s step-by-step
recurrence, the oracle of the tests and of chip_smoke.py.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing

from . import build
from .build import PLAIN_DEVICES

launches = 0
# launches by kernel, so a run can show which one its path took
variant_launches = {"wgmma": 0, "cuda_cores": 0}

NEG_INF = -1e30
PANEL_P = 64          # the widest head dim one kernel block takes
MAX_P = 256           # wider head dims run as panels of PANEL_P
MAX_N = 128
MAX_CHUNK = 128
WGMMA_CHUNK = 128
WGMMA_HEAD_DIMS = (32, 64)
WGMMA_STATE_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8 + (
    ctypes.c_void_p,)
_WGMMA_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)


def variant(x_dtype: torch.dtype, bc_dtype: torch.dtype, head_dim: int,
            d_state: int, chunk: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` when x, b and c are bf16,
    ``chunk == WGMMA_CHUNK`` (a sequence shorter than the chunk is one
    chunk, zero-padded: zero rows leave y and the state exact), the head
    dim as launched (a head dim above ``PANEL_P`` launches as panels of
    ``PANEL_P``) is in ``WGMMA_HEAD_DIMS`` and the state dim in
    ``WGMMA_STATE_DIMS``; ``"cuda_cores"`` otherwise."""
    head_dim = min(head_dim, PANEL_P)
    if (x_dtype == torch.bfloat16 and bc_dtype == torch.bfloat16
            and chunk == WGMMA_CHUNK and head_dim in WGMMA_HEAD_DIMS
            and d_state in WGMMA_STATE_DIMS):
        return "wgmma"
    return "cuda_cores"


def split_panels(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H) and a_log (H,) as the same scan over
    ``H * k`` heads of ``PANEL_P``, ``k = ceil(P / PANEL_P)``: x
    zero-padded to ``k * PANEL_P`` columns and viewed as (B, S, H k,
    PANEL_P), panel j of head h at head ``h k + j``; dt and a_log
    repeated per panel.  ``merge_panels`` undoes it on the output."""
    B, S, H, P = x.shape
    k = -(-P // PANEL_P)
    xp = F.pad(x, (0, k * PANEL_P - P)).reshape(B, S, H * k, PANEL_P)
    return (xp, dt.repeat_interleave(k, dim=-1).contiguous(),
            a_log.repeat_interleave(k).contiguous())


def merge_panels(y: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The output (B, S, H k, PANEL_P) of a ``split_panels`` scan as (B,
    S, H, ``head_dim``): the panels side by side, the padding dropped."""
    B, S, HK, _ = y.shape
    k = -(-head_dim // PANEL_P)
    return y.reshape(B, S, HK // k, k * PANEL_P)[..., :head_dim].contiguous()


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   chunk: int = 128) -> torch.Tensor:
    """The chunked scan in fp32, every chunk at once, then the carried
    state chunk by chunk: what ``_ssd_kernel`` computes, rounded once.

    The decay mask is applied before the exp (``where(j <= i, cum_i -
    cum_j, -1e30)``, as ``repro/layers/ssm.py`` does): exp of the masked
    upper triangle can overflow, and its gradient through a mask applied
    after the exp is inf * 0 = NaN."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    n_chunks = -(-S // Q)
    pad = n_chunks * Q - S
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    A = -torch.exp(a_log.float())                          # (H,)
    xs = xf.reshape(B, n_chunks, Q, H, P)
    dts = dtf.reshape(B, n_chunks, Q, H)
    bs = bf.reshape(B, n_chunks, Q, N)
    cs = cf.reshape(B, n_chunks, Q, N)
    cum = torch.cumsum(dts * A, dim=2)                     # (B, C, Q, H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, C, i, j, H)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(mask[:, :, None], diff, NEG_INF))
    scores = torch.einsum("bcin,bcjn->bcij", cs, bs)
    w = scores[..., None] * L
    xdt = xs * dts[..., None]                              # (B, C, Q, H, P)
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xdt)
    rem = cum[:, :, -1:, :] - cum
    states = torch.einsum("bcihp,bcin->bchpn",
                          xdt * torch.exp(rem)[..., None], bs)
    decay = torch.exp(cum[:, :, -1, :])                    # (B, C, H)
    h = xf.new_zeros(B, H, P, N)
    carried = []                                           # state entering
    for k in range(n_chunks):                              # each chunk
        carried.append(h)
        h = h * decay[:, k, :, None, None] + states[:, k]
    hs = torch.stack(carried, dim=1)                       # (B, C, H, P, N)
    y = y + torch.exp(cum)[..., None] * torch.einsum("bcin,bchpn->bcihp",
                                                     cs, hs)
    return y.reshape(B, n_chunks * Q, H, P)[:, :S].to(x.dtype)


def ssd_scan_sequential(x: torch.Tensor, dt: torch.Tensor,
                        a_log: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """The recurrence one step at a time, in fp32
    (``repro/kernels/ssd_scan/ref.py``)::

        h_t = exp(dt_t A) h_{t-1} + dt_t x_t (outer) B_t,  y_t = h_t C_t
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    A = -torch.exp(a_log.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    h = xf.new_zeros(B, H, P, N)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * A)                       # (B, H)
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * bf[:, t, None, None, :])                  # (B, H, P, N)
        h = h * a[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def check_kernel_args(x: torch.Tensor, dt: torch.Tensor,
                      a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      chunk: int) -> None:
    """Raise ``ValueError`` on inputs the CUDA kernel does not take."""
    if x.dim() != 4:
        raise ValueError("ssd_scan kernel: x must be (B, S, H, P)")
    B, S, H, P = x.shape
    if b.dim() != 3 or tuple(c.shape) != tuple(b.shape) \
            or tuple(b.shape[:2]) != (B, S):
        raise ValueError(f"ssd_scan kernel: b {tuple(b.shape)} and c "
                         f"{tuple(c.shape)} must both be (B, S, N) with "
                         f"(B, S) = {(B, S)}")
    N = b.shape[2]
    if tuple(dt.shape) != (B, S, H) or tuple(a_log.shape) != (H,):
        raise ValueError(f"ssd_scan kernel: dt {tuple(dt.shape)} must be "
                         f"{(B, S, H)} and a_log {tuple(a_log.shape)} "
                         f"({H},)")
    panels = -(-P // PANEL_P)
    if B < 1 or S < 1 or H < 1 or B * H * panels >= 2 ** 31:
        raise ValueError(f"ssd_scan kernel: B={B}, S={S}, H={H} must be "
                         f">= 1 with B * H * {panels} panels < 2**31")
    if not (4 <= P <= MAX_P and P % 4 == 0):
        raise ValueError(f"ssd_scan kernel: head dim {P} is not a multiple "
                         f"of 4 in [4, {MAX_P}]")
    if not (4 <= N <= MAX_N and N % 4 == 0):
        raise ValueError(f"ssd_scan kernel: state dim {N} is not a multiple "
                         f"of 4 in [4, {MAX_N}]")
    if chunk < 1 or min(chunk, S) > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel: chunk {min(chunk, S)} outside "
                         f"[1, {MAX_CHUNK}]")
    if x.dtype not in _DTYPE_CODES or b.dtype not in _DTYPE_CODES \
            or c.dtype != b.dtype:
        raise ValueError(f"ssd_scan kernel: x {x.dtype} and b/c "
                         f"{b.dtype}/{c.dtype} must be one of "
                         f"{sorted(map(str, _DTYPE_CODES))}, b and c alike")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise ValueError(f"ssd_scan kernel: dt {dt.dtype} and a_log "
                         f"{a_log.dtype} must be float32")
    wgmma = variant(x.dtype, b.dtype, P, N, chunk) == "wgmma"
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("b", b),
                    ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"ssd_scan kernel: {name} on {t.device}, x on "
                             f"{x.device}")
        # the wgmma kernel reads x, b and c through TMA maps, whose bases
        # must be 16-byte aligned; a head dim split into panels reads a
        # padded copy of x
        aligned = ("b", "c") if P > PANEL_P else ("x", "b", "c")
        if wgmma and name in aligned and t.data_ptr() % 16:
            raise ValueError(f"ssd_scan kernel: bf16 {name} must be 16-byte "
                             f"aligned")


def ssd_scan_grads(x, dt, a_log, b, c, dy, chunk: int = 128
                   ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, da_log, db, dc) of ``ssd_scan_plain`` for the output
    gradient ``dy``: the plain version run again under autograd and
    differentiated, each gradient in its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
        y = ssd_scan_plain(*leaves, chunk=chunk)
        return torch.autograd.grad(y, leaves, dy)


class _SSDScanKernel(torch.autograd.Function):
    """The CUDA kernel forward, the plain version's autograd backward."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk):
        ctx.save_for_backward(x, dt, a_log, b, c)
        ctx.chunk = chunk
        return _launch(x, dt, a_log, b, c, chunk)

    @staticmethod
    def backward(ctx, dy):
        grads = ssd_scan_grads(*ctx.saved_tensors, dy.contiguous(),
                               chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             chunk: int = 128) -> torch.Tensor:
    """The SSD scan of ``x (B, S, H, P)``; returns y (B, S, H, P) in x's
    dtype, without the D-skip term."""
    if x.device.type in PLAIN_DEVICES:
        return ssd_scan_plain(x, dt, a_log, b, c, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    check_kernel_args(x, dt, a_log, b, c, chunk)
    return _SSDScanKernel.apply(x, dt, a_log, b, c, chunk)


def _launch(x, dt, a_log, b, c, chunk: int,
            kernel: Optional[str] = None) -> torch.Tensor:
    """Launch ``kernel`` (``variant``'s pick unless given: chip_smoke.py
    times the two kernels on the same inputs) on checked inputs; a head
    dim above ``PANEL_P`` as its panels, in the same one launch."""
    global launches
    P = x.shape[3]
    N = b.shape[2]
    kernel = kernel or variant(x.dtype, b.dtype, P, N, chunk)
    if kernel not in variant_launches:
        raise ValueError(f"ssd_scan: no kernel {kernel!r}")
    if P > PANEL_P:
        x, dt, a_log = split_panels(x, dt, a_log)
    B, S, H, Pk = x.shape
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), B, S, H, Pk, N)
    if kernel == "wgmma":
        name = "apex_ssd_scan_wgmma"
        fn, args = build.kernel(name, _WGMMA_ARGTYPES), (*ptrs, stream)
    else:
        name = "apex_ssd_scan"
        fn = build.kernel(name, _ARGTYPES)
        args = (*ptrs, min(chunk, S), _DTYPE_CODES[x.dtype],
                _DTYPE_CODES[b.dtype], stream)
    with tracing.span("kernel.ssd_scan"):
        err = fn(*args)
    build.check(err, name)
    launches += 1
    variant_launches[kernel] += 1
    return y if Pk == P else merge_panels(y, P)
