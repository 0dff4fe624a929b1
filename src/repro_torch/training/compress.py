"""Int8 gradient compression with stochastic rounding
(``repro/training/compress.py``).

Used for the cross-pod gradient reduction of the pipeline / multi-pod
training path: per-tensor absmax scaling to int8 quarters the bytes of
fp32 gradients on the slowest link.  Stochastic rounding keeps the
quantizer unbiased (E[dequant(quant(x))] == x), so momentum-based
optimizers see zero-mean noise instead of bias.

The reference draws its rounding noise from ``jax.random``; here it comes
from a ``torch.Generator`` on the tensor's device.  The arithmetic is the
reference's: an fp32 scale ``max(max|x|, 1e-12) / 127``, ``y = x /
scale``, rounded up with probability ``y - floor(y)``, clipped to +-127.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.convert import map_tree


def quantize_int8(x: torch.Tensor, gen: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, fp32 scale).  Stochastic rounding; ``gen`` lives
    on ``x``'s device."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    y = xf / scale
    lo = torch.floor(y)
    up = torch.rand(y.shape, generator=gen, device=y.device) < (y - lo)
    q = torch.clamp(lo + up.float(), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, gen: torch.Generator):
    """Quantize every leaf of a tree of nested dicts and lists; returns
    (codes tree, scales tree).  Each leaf draws from a generator of its
    own on its device, seeded in leaf order from ``gen``, as the
    reference splits its key once per leaf."""
    def one(leaf: torch.Tensor):
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                                 device=gen.device))
        own = torch.Generator(device=leaf.device).manual_seed(seed)
        return quantize_int8(leaf, own)

    pairs = map_tree(one, grads)
    return map_tree(lambda p: p[0], pairs), map_tree(lambda p: p[1], pairs)


def decompress_tree(codes, scales):
    """The inverse of ``compress_tree`` up to rounding: fp32 leaves."""
    return map_tree(dequantize_int8, codes, scales)
