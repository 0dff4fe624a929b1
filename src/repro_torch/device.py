"""Device and dtype resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    """Map a config dtype name ("bfloat16", "float32") to a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(DTYPES)}") from None
