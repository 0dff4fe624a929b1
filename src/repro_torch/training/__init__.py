"""Training substrate of the port: the AdamW optimizer and checkpointing
(``repro/training``)."""

from .checkpoint import CheckpointManager
from .optimizer import AdamWState, adamw_init, adamw_update, cosine_lr

__all__ = ["AdamWState", "CheckpointManager", "adamw_init", "adamw_update",
           "cosine_lr"]
