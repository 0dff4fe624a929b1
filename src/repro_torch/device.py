"""Device and dtype resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float8_e4m3fn": torch.float8_e4m3fn}
# e4m3fn's largest finite value is 448 and the next step would be 480:
# a magnitude up to their midpoint 464 rounds (to even) down to 448,
# anything past it overflows
E4M3_OVERFLOW = 464.0


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA: it returns ``cuda`` when a card is visible and
    raises ``RuntimeError`` otherwise.  It never picks the CPU on its own;
    a caller that wants the CPU passes ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Map a dtype name ("bfloat16", "float32", "float8_e4m3fn") to a
    torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(DTYPES)}") from None


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a cache's storage ``dtype``, as the reference's
    ``astype`` casts it.

    For ``float8_e4m3fn`` that is ``ml_dtypes``' cast: round to nearest
    even, and NaN (of x's sign) for a magnitude past 464, infinities
    included, where e4m3fn has no finite value to round to.  Torch's
    ``.to()`` saturates those to +-448 instead.  Every other dtype is
    ``x.to(dtype)``."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    xf = x.float()
    nan = torch.copysign(torch.full_like(xf, float("nan")), xf)
    return torch.where(xf.abs() > E4M3_OVERFLOW, nan.to(dtype), y)
