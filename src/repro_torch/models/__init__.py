"""Model zoo of the port: the dense decoder and Mamba2 paths of
``repro.models``."""

from .config import EncoderConfig, LayerSpec, ModelConfig
from .transformer import (decode_step, forward, init_cache, init_params,
                          prefill, ring_size)

__all__ = ["EncoderConfig", "LayerSpec", "ModelConfig", "decode_step",
           "forward", "init_cache", "init_params", "prefill", "ring_size"]
