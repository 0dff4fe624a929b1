"""Attention-head padding (``repro/parallel/padding.py``): a deploy-time
transform that aligns head counts with the "model" mesh axis.

Several archs have head counts that do not divide a 16-wide "model" axis
(qwen1.5-32b: 40 q/kv heads; qwen2-vl: 28 / 4; qwen2-0.5b: 14 / 2), and
their attention projections then replicate (``parallel/sharding.py``).
The reference pads q and kv heads alike to the next multiple of the axis,
with zero weights: ``wq``/``bq`` to ``hq_p * hd`` columns, ``wk``/``wv``/
``bk``/``bv`` to ``hkv_p * hd``, and ``wo`` with zero ROWS, so that the
padded heads' outputs vanish.  Only the ``attn`` and ``xattn`` leaves are
padded.

The reference calls this "mathematically exact".  It is exact only when
q heads equal kv heads (MHA: qwen1.5-32b's 40 -> 48).  For GQA, padding
both counts to the same multiple changes the group: after padding q head
``h`` reads kv head ``h``, where it read ``h // group`` before.  On the
JAX package's REDUCED configs in fp32, qwen2-0.5b (7 q / 1 kv heads,
padded to 16 / 16) moves the logits by 6.35 at most, beside logits of
4.22 at most, while qwen1.5-32b (5 / 5) moves them by 0.  The port
follows the reference, fault included, and does not repair it
(``tests/test_torch_parallel.py`` pins it).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


def _pad_dim(x: torch.Tensor, dim: int, new: int) -> torch.Tensor:
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - dim) + 1] = new - x.shape[dim]
    return F.pad(x, pad)


def _clone_tree(m: nn.Module) -> nn.Module:
    """A copy of the module tree that shares every parameter: its own
    ``_parameters`` and ``_modules`` dicts, so that replacing a parameter
    in the copy leaves ``m`` as it was."""
    c = copy.copy(m)
    c._parameters = dict(m._parameters)
    c._buffers = dict(m._buffers)
    c._modules = {k: None if v is None else _clone_tree(v)
                  for k, v in m._modules.items()}
    return c


def pad_attention_heads(params: Transformer, cfg: ModelConfig,
                        multiple: int = 16) -> Tuple[Transformer,
                                                     ModelConfig]:
    """Zero-pad attention heads to the next multiple of ``multiple``.

    Returns (padded params, padded cfg); the padded params share every
    leaf that is not padded with ``params``.  No-op when already aligned;
    MLA raises ``NotImplementedError``.  Exact for MHA only (module
    docstring)."""
    pcfg = padded_config(cfg, multiple)
    if pcfg is cfg:
        return params, cfg
    if cfg.attn_kind == "mla":
        raise NotImplementedError("MLA archs are already head-aligned")
    hd, hq_p, hkv_p = pcfg.head_dim, pcfg.n_heads, pcfg.n_kv_heads
    # leaf -> (dim, padded size)
    rule = {"wq": (1, hq_p * hd), "wk": (1, hkv_p * hd),
            "wv": (1, hkv_p * hd), "wo": (0, hq_p * hd),
            "bq": (0, hq_p * hd), "bk": (0, hkv_p * hd),
            "bv": (0, hkv_p * hd)}
    new = _clone_tree(params)
    with torch.no_grad():
        for name, module in new.named_modules():
            if name.rsplit(".", 1)[-1] not in ("attn", "xattn"):
                continue
            for leaf, p in list(module._parameters.items()):
                if leaf in rule:
                    dim, size = rule[leaf]
                    module._parameters[leaf] = nn.Parameter(
                        _pad_dim(p, dim, size), requires_grad=p.requires_grad)
    return new, pcfg


def padded_config(cfg: ModelConfig, multiple: int = 16) -> ModelConfig:
    """Config-only variant (shapes for a dry-run)."""
    hq_p = -(-cfg.n_heads // multiple) * multiple
    hkv_p = -(-cfg.n_kv_heads // multiple) * multiple
    if hq_p == cfg.n_heads and hkv_p == cfg.n_kv_heads:
        return cfg
    return dataclasses.replace(cfg, n_heads=hq_p, n_kv_heads=hkv_p,
                               head_dim=cfg.resolved_head_dim)
