"""Input-shape cells for the dry-run (``repro/launch/shapes.py``): meta
tensors standing in for every model input, with shapes and dtypes and
no storage.

Cells (applied per arch; skips per ``configs.shape_skips``):
    train_4k     seq 4096  x global_batch 256   -> train_step
    prefill_32k  seq 32768 x global_batch 32    -> prefill forward
    decode_32k   seq 32768 x global_batch 128   -> serve_step (1 new token)
    long_500k    seq 524288 x global_batch 1    -> serve_step
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCell,
                cache_dtype=None) -> dict:
    """Meta stand-ins for one (arch x shape) cell, key for key the
    reference's:

    train   -> {"tokens", "labels"} (+ "frames"/"embeds" for stub frontends)
    prefill -> {"tokens"} / {"embeds"} / {"frames", "tokens"}
    decode  -> {"tokens": (B, 1)} + "cache" (``init_cache`` on the meta
               device) sized to seq_len
    """
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    i32, dt = torch.int32, torch_dtype(cfg.dtype)

    if shape.kind == "train":
        out = {"labels": _meta((B, S), i32)}
        if cfg.encoder is not None:
            # enc-dec: source frames length == seq budget, short targets
            out["frames"] = _meta((B, S, d), dt)
            out["tokens"] = _meta((B, max(256, S // 8)), i32)
            out["labels"] = _meta((B, max(256, S // 8)), i32)
        elif cfg.embeds_input:
            out["embeds"] = _meta((B, S, d), dt)
        else:
            out["tokens"] = _meta((B, S), i32)
        return out

    if shape.kind == "prefill":
        if cfg.encoder is not None:
            return {"frames": _meta((B, S, d), dt),
                    "tokens": _meta((B, 1), i32)}
        if cfg.embeds_input:
            return {"embeds": _meta((B, S, d), dt)}
        return {"tokens": _meta((B, S), i32)}

    # decode: one new token against a cache of S
    cache = T.init_cache(cfg, B, S, device="meta", cache_dtype=cache_dtype,
                         source_len=cfg.cross_source_len
                         if cfg.cross_attn else 0)
    return {"tokens": _meta((B, 1), i32), "cache": cache}
