"""Carry the JAX reference's parameters and caches into the port.

Both functions take the reference's pytree as host numpy arrays
(``jax.device_get(tree)``): nested dicts with the repeating block's
parameters stacked on a leading R axis.  bf16 arrays
(``ml_dtypes.bfloat16``) cross as raw bits, with no rounding through
fp32.  Weights keep the JAX layout, so conversion is a copy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (DecoderLayer, Transformer,
                                            check_supported)


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array as a torch tensor; bf16 crosses bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _param(a, device) -> nn.Parameter:
    return nn.Parameter(to_torch(a, device), requires_grad=False)


def _param_dict(tree: Mapping, device, r=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: _param(a if r is None else np.asarray(a)[r], device)
        for name, a in tree.items()})


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device=None) -> Transformer:
    """The port's ``Transformer`` holding the reference's weights.

    ``tree`` is ``jax.device_get(repro.models.transformer.init_params(
    key, cfg))`` for a dense decoder config."""
    check_supported(cfg)
    blocks = nn.ModuleList()
    for r in range(cfg.block_repeat):
        layers = {}
        for i in range(len(cfg.block_pattern)):
            lt = tree["blocks"][f"l{i}"]
            layers[f"l{i}"] = DecoderLayer(
                _param(np.asarray(lt["norm1"])[r], device),
                _param_dict(lt["attn"], device, r),
                _param(np.asarray(lt["norm2"])[r], device),
                _param_dict(lt["ffn"], device, r))
        blocks.append(nn.ModuleDict(layers))
    head = _param(tree["head"], device) if "head" in tree else None
    return Transformer(_param(tree["embed"], device),
                       _param(tree["final_norm"], device), blocks, head)


def cache_from_jax(tree: Mapping, device=None) -> dict:
    """The port's cache from the reference's ``init_cache``/``prefill``
    cache pytree (attention layers only): same keys and shapes."""
    return {
        "blocks": {slot: {name: to_torch(a, device)
                          for name, a in lc.items()}
                   for slot, lc in tree["blocks"].items()},
        "len": to_torch(tree["len"], device).to(torch.int32),
    }
