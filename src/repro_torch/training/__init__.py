"""Training substrate of the port: the AdamW optimizer, checkpointing,
elastic re-meshing and gradient compression (``repro/training``)."""

from .checkpoint import CheckpointManager
from .compress import dequantize_int8, quantize_int8
from .elastic import reshard_state
from .optimizer import AdamWState, adamw_init, adamw_update, cosine_lr

__all__ = ["AdamWState", "CheckpointManager", "adamw_init", "adamw_update",
           "cosine_lr", "dequantize_int8", "quantize_int8", "reshard_state"]
