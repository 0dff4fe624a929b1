"""Model zoo of the port: the decoder paths of ``repro.models`` (dense,
MoE, MLA, Mamba2, M-RoPE fed embeddings) in ``transformer`` and the
encoder-decoder in ``encdec``."""

from .config import EncoderConfig, LayerSpec, ModelConfig
from .transformer import (decode_step, forward, init_cache, init_params,
                          param_count, prefill, ring_size)

__all__ = ["EncoderConfig", "LayerSpec", "ModelConfig", "decode_step",
           "forward", "init_cache", "init_params", "param_count", "prefill",
           "ring_size"]
