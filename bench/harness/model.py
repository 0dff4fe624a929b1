"""A configuration's weights, drawn on the device from the seed.

The weights are the benchmark's own input.  Their layout is the
family's (``bench/families/<family>.py``, ``leaves``).  They are drawn
in the type they are served in, into one flat buffer per dtype, a few
large ``normal_`` calls each, and every leaf is a view of its buffer,
scaled in place.  The same seed on the same device gives the same
values, so a check can draw them again once the program has changed its
copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import spec

# elements a normal_ call fills; each leaf starts on a 256-element boundary
CHUNK = 1 << 30
ALIGN = 256
NORM_SPREAD = 0.1


def leaves(conf: dict) -> List[Tuple[str, tuple, torch.dtype, float]]:
    """(name, shape, dtype, scale) of every weight of ``conf``; a scale of
    0 marks an RMSNorm weight, drawn as ``1 + NORM_SPREAD * N(0, 1)``."""
    return spec.family(conf["family"]).leaves(conf)


def param_count(conf: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaves(conf))


@torch.no_grad()
def draw(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of ``conf``, drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    layout: Dict[torch.dtype, list] = {}
    for name, shape, dt, scale in leaves(conf):
        layout.setdefault(dt, []).append((name, shape, scale))
    out = {}
    for dt in sorted(layout, key=str):
        offsets, total = [], 0
        for name, shape, scale in layout[dt]:
            offsets.append(total)
            total += -(-math.prod(shape) // ALIGN) * ALIGN
        buf = torch.empty(total, dtype=dt, device=device)
        for a in range(0, total, CHUNK):
            buf[a:a + CHUNK].normal_(generator=gen)
        for (name, shape, scale), off in zip(layout[dt], offsets):
            v = buf[off:off + math.prod(shape)].view(shape)
            if scale:
                v.mul_(scale)
            else:
                v.mul_(NORM_SPREAD).add_(1.0)
            out[name] = v
    return out


def port_model(conf: dict, weights: Dict[str, torch.Tensor]):
    """The program's config and parameters for ``conf``, each parameter
    the very tensor of ``weights`` (no copy)."""
    return spec.family(conf["family"]).port_model(conf, weights)
