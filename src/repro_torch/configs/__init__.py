"""Architecture registry of the port: one module per architecture, each
exporting ``FULL`` (the published dims) and ``REDUCED`` (a same-family
miniature for CPU tests), copied from ``repro/configs``.

The port carries the dense GQA decoders (gemma3-12b among them, with
its blocks of five sliding-window layers and one global layer), the
attention-free Mamba2 model, the MoE decoder mixtral-8x7b and the MLA
decoder deepseek-v2-lite-16b (64 experts, a dense first layer), the
M-RoPE backbone qwen2-vl-7b (embedding inputs: its vision frontend is a
stub), the encoder-decoder seamless-m4t-large-v2 (its speech frontend
a stub) and the hybrid zamba2-7b (78 Mamba2 layers and one shared
attention block applied after every sixth): every architecture of the
JAX registry.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "internlm2_1_8b",
    "qwen2_0_5b",
    "qwen1_5_32b",
    "mamba2_2_7b",
    "mixtral_8x7b",
    "gemma3_12b",
    "deepseek_v2_lite_16b",
    "qwen2_vl_7b",
    "seamless_m4t_large_v2",
    "zamba2_7b",
]

# canonical ids as given in the assignment -> module names
ALIASES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen1.5-32b": "qwen1_5_32b",
    "mamba2-2.7b": "mamba2_2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "gemma3-12b": "gemma3_12b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "zamba2-7b": "zamba2_7b",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).FULL


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED


def all_configs() -> Dict[str, ModelConfig]:
    """Module name -> FULL config of every architecture."""
    return {a: get_config(a) for a in ARCHS}


def shape_skips(name: str) -> Dict[str, str]:
    """shape id -> reason, for the dry-run cells this arch skips."""
    return getattr(_module(name), "SKIP_SHAPES", {})


def at_depth(cfg: ModelConfig, depth: Optional[int]) -> ModelConfig:
    """``cfg`` cut to its first ``depth`` blocks at full width, prefix
    blocks (deepseek's dense first layer) counted; ``cfg`` itself for
    None.  A depth that keeps no block past the prefix raises
    ``ValueError``."""
    if depth is None:
        return cfg
    if depth <= cfg.first_k_dense:
        raise ValueError(f"depth {depth} keeps no block after {cfg.name}'s "
                         f"{cfg.first_k_dense} prefix block(s)")
    return dataclasses.replace(cfg, block_repeat=depth)
