"""RMSNorm: the port of ``repro/kernels/rmsnorm`` (``rms_norm_pallas``).

``rms_norm`` launches a CUDA kernel of ``csrc/rmsnorm.cu`` on a CUDA
tensor and runs the plain PyTorch version ``rms_norm_plain`` on a CPU
tensor.  There is no fallback: a CUDA tensor the kernels do not take
raises.  ``launches`` counts kernel launches in this process (forward
launches only: the gradient is plain PyTorch), one per call whichever
kernel ``variant`` picks.

On CUDA the kernel sits in a ``torch.autograd.Function`` whose backward
is ``rms_norm_grads``, the fp32 derivative of ``rms_norm_plain``.  The
reference's gradient is XLA autodiff of ``repro/layers/norms.py``, not a
Pallas kernel, so plain PyTorch is its counterpart.  On the CPU autograd
differentiates ``rms_norm_plain`` itself.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import tracing

from . import build
from .build import PLAIN_DEVICES

launches = 0

MAX_D = 8192
MAX_VECS = 8         # 16-byte vectors of a row one lane of the kernel holds
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def variant(d: int, itemsize: int, aligned: bool) -> Tuple[int, int]:
    """``(warps_per_row, vecs)``: which kernel of ``csrc/rmsnorm.cu`` a
    call with rows of ``d`` elements of ``itemsize`` bytes takes.

    The vector kernel, when ``d`` is a multiple of the 16-byte vector
    (8 bf16, 4 fp32) and x, weight and output are 16-byte aligned
    (``aligned``): the fewest warps per row of 1, 2, 4 and 8 that give
    each lane at most ``MAX_VECS`` vectors, and ``vecs`` the vectors a
    lane then holds (d 896 bf16: (1, 4); 2560: (2, 5); 5120: (4, 5)).
    Otherwise ``(0, 0)``: the rows kernel, a block per row."""
    per_vec = 16 // itemsize
    if d % per_vec or not aligned:
        return 0, 0
    n_vec = d // per_vec
    for warps in (1, 2, 4, 8):
        vecs = -(-n_vec // (32 * warps))
        if vecs <= MAX_VECS:
            return warps, vecs
    return 0, 0


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; compute in fp32, cast back
    (``repro/layers/norms.py:rms_norm``)."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    return (y * weight.float()).to(dtype)


def check_kernel_args(x: torch.Tensor, weight: torch.Tensor) -> None:
    """Raise ``ValueError`` on inputs the CUDA kernel does not take."""
    for name, t in (("x", x), ("weight", weight)):
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"rms_norm kernel: {name} dtype {t.dtype} not "
                             f"in {sorted(map(str, _DTYPE_CODES))}")
        if not t.is_contiguous():
            raise ValueError(f"rms_norm kernel: {name} must be contiguous")
    if weight.device != x.device:
        raise ValueError(f"rms_norm kernel: weight on {weight.device}, "
                         f"x on {x.device}")
    if x.dim() < 1:
        raise ValueError("rms_norm kernel: x must have a last axis")
    d = x.shape[-1]
    if tuple(weight.shape) != (d,):
        raise ValueError(f"rms_norm kernel: weight shape "
                         f"{tuple(weight.shape)} != ({d},)")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rms_norm kernel: d={d} outside [1, {MAX_D}]")
    if x.numel() // d >= 2 ** 31:
        raise ValueError("rms_norm kernel: too many rows")


def rms_norm_grads(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-6
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dweight) of ``rms_norm_plain(x, weight, eps)`` for the output
    gradient ``dy``, computed in fp32 and cast to x's and weight's
    dtypes."""
    xf = x.float()
    g = dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dw = (g * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    gw = g * weight.float()
    dx = r * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dw.to(weight.dtype)


class _RMSNormKernel(torch.autograd.Function):
    """The CUDA kernel forward, the fp32 derivative backward."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _launch(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_grads(x, weight, dy, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x (..., d)`` by ``weight (d,)``, in x's dtype."""
    if x.device.type in PLAIN_DEVICES:
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    check_kernel_args(x, weight)
    return _RMSNormKernel.apply(x, weight, eps)


def _launch(x: torch.Tensor, weight: torch.Tensor,
            eps: float) -> torch.Tensor:
    global launches
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    if rows == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, weight, out))
    warps, vecs = variant(x.shape[-1], x.element_size(), aligned)
    fn = build.kernel("apex_rmsnorm", _ARGTYPES)
    with tracing.span("kernel.rmsnorm"):
        err = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows,
                 x.shape[-1], eps, _DTYPE_CODES[x.dtype],
                 _DTYPE_CODES[weight.dtype], warps, vecs,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "apex_rmsnorm")
    launches += 1
    return out
