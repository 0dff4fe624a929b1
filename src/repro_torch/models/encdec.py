"""Encoder-decoder model (``repro/models/encdec.py``, the Seamless-M4T v2
backbone).

The speech frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_src, d_model).  The encoder is a
bidirectional transformer (self-attention + non-gated FFN, then a final
RMSNorm); the decoder is ``models.transformer`` with ``cross_attn=True``,
so every decoder layer attends to the encoder memory.

Parameters: ``init_encdec_params`` gives the decoder's ``Transformer``
with ``encoder``, an ``Encoder`` of ``layers`` (a ``ModuleList`` of
``EncoderLayer``: ``norm1``, ``attn``, ``norm2``, ``mlp``) and
``final_norm``; the reference stacks the layers on a leading axis for
``lax.scan`` (``convert.py`` carries the tree both ways).

Serving: ``encdec_prefill`` encodes once per request (the flash kernel
with ``causal=False``), projects every decoder layer's cross K/V from
the memory once (``_project_cross_kv``, one product per layer and
projection) into the cache, and runs the first decoder step on the BOS
tokens; ``encdec_decode_step`` is then one decoder step, whose
cross-attention runs the decode kernel over the whole cross cache.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import torch_dtype
from repro_torch.layers import (blockwise_attention, init_attention,
                                init_mlp, mlp_forward, rms_norm)
from repro_torch.layers.hints import split_last
from .config import EncoderConfig, ModelConfig
from . import transformer as T


class EncoderLayer(nn.Module):
    """One encoder layer: ``norm1``, ``attn`` (``wq``, ``wk``, ``wv``,
    ``wo``; H kv heads), ``norm2``, ``mlp``."""

    def __init__(self, norm1: nn.Parameter, attn: nn.ParameterDict,
                 norm2: nn.Parameter, mlp: nn.ParameterDict):
        super().__init__()
        self.norm1 = norm1
        self.attn = attn
        self.norm2 = norm2
        self.mlp = mlp


class Encoder(nn.Module):
    """``layers`` (a ``ModuleList`` of ``EncoderLayer``) and
    ``final_norm``."""

    def __init__(self, layers: nn.ModuleList, final_norm: nn.Parameter):
        super().__init__()
        self.layers = layers
        self.final_norm = final_norm


def init_encoder(gen: torch.Generator, enc: EncoderConfig,
                 dtype: torch.dtype = torch.bfloat16,
                 device=None) -> Encoder:
    """Random encoder weights with the reference's shapes and scales (not
    its values)."""
    hd = enc.d_model // enc.n_heads

    def ones():
        return nn.Parameter(torch.ones(enc.d_model, dtype=dtype,
                                       device=device))

    layers = nn.ModuleList(
        EncoderLayer(ones(), init_attention(gen, enc.d_model, enc.n_heads,
                                            enc.n_heads, hd, dtype=dtype,
                                            device=device),
                     ones(), init_mlp(gen, enc.d_model, enc.d_ff,
                                      gated=enc.gated, dtype=dtype,
                                      device=device))
        for _ in range(enc.n_layers))
    return Encoder(layers, ones())


def init_encdec_params(gen: torch.Generator, cfg: ModelConfig,
                       device=None) -> T.Transformer:
    """The decoder's parameters (``transformer.init_params``) with the
    encoder as ``encoder``."""
    if cfg.encoder is None or not cfg.cross_attn:
        raise ValueError("encdec model needs cfg.encoder and cfg.cross_attn")
    params = T.init_params(gen, cfg, device=device)
    params.encoder = init_encoder(gen, cfg.encoder,
                                  dtype=torch_dtype(cfg.dtype),
                                  device=device)
    return params


def _encoder_layer_apply(enc: EncoderConfig, lp: EncoderLayer,
                         x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp.norm1)
    B, S, _ = h.shape
    hd = enc.d_model // enc.n_heads
    q, k, v = (split_last(h @ lp.attn[w], B, S, enc.n_heads, hd)
               for w in ("wq", "wk", "wv"))
    out = blockwise_attention(q, k, v, causal=False)
    x = x + out.reshape(B, S, enc.n_heads * hd) @ lp.attn["wo"]
    return x + mlp_forward(lp.mlp, rms_norm(x, lp.norm2))


def encode(params: T.Transformer, cfg: ModelConfig, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """Bidirectional encoder over stub frame embeddings: frames (B, S_src,
    d_model) -> memory (B, S_src, d_model).  Each layer's attention is the
    flash kernel without the causal mask; under ``remat`` each layer is
    checkpointed (non-reentrant), as the reference wraps its scanned
    layer in ``jax.checkpoint``."""
    enc = cfg.encoder
    x = frames.to(torch_dtype(cfg.dtype))
    for lp in params.encoder.layers:
        if remat:
            x = checkpoint(_encoder_layer_apply, enc, lp, x,
                           use_reentrant=False)
        else:
            x = _encoder_layer_apply(enc, lp, x)
    return rms_norm(x, params.encoder.final_norm)


def encdec_forward(params: T.Transformer, cfg: ModelConfig,
                   frames: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Training forward: encode ``frames``, decode the target ``tokens``
    -> logits (B, S, vocab)."""
    memory = encode(params, cfg, frames)
    return T.forward(params, cfg, tokens, enc_memory=memory)


def _project_cross_kv(params: T.Transformer, cfg: ModelConfig,
                      memory: torch.Tensor) -> Dict[str, Dict[str,
                                                              torch.Tensor]]:
    """Every decoder layer's cross K/V from the encoder memory, computed
    once: per slot ``l<i>``, ``xk``/``xv`` (R, B, Se, Hkv, D), one
    product with each layer's ``wk`` and ``wv``."""
    hd = cfg.resolved_head_dim
    B, Se, _ = memory.shape
    out = {}
    for i in range(len(cfg.block_pattern)):
        xs = [blk[f"l{i}"].xattn for blk in params.blocks]
        out[f"l{i}"] = {
            name: torch.stack([split_last(
                memory @ xp[w], B, Se, cfg.n_kv_heads, hd) for xp in xs])
            for name, w in (("xk", "wk"), ("xv", "wv"))}
    return out


@torch.no_grad()
def encdec_prefill(params: T.Transformer, cfg: ModelConfig,
                   frames: torch.Tensor, bos_tokens: torch.Tensor,
                   max_len: int) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """Serve-side prefill: encode, build the decoder cache with the cross
    K/V, run the first step.  bos_tokens: (B, 1) decoder start tokens.
    Returns (first logits (B, vocab), cache, memory)."""
    memory = encode(params, cfg, frames)
    B = frames.shape[0]
    cache = T.init_cache(cfg, B, max_len, device=frames.device,
                         source_len=memory.shape[1])
    cross = _project_cross_kv(params, cfg, memory)
    for slot, kv in cross.items():
        cache["blocks"][slot].update(kv)
    logits, cache = T.decode_step(params, cfg, bos_tokens, cache)
    return logits, cache, memory


def encdec_decode_step(params: T.Transformer, cfg: ModelConfig,
                       tokens: torch.Tensor,
                       cache: dict) -> Tuple[torch.Tensor, dict]:
    """One decoder step (the cross K/V already in the cache)."""
    return T.decode_step(params, cfg, tokens, cache)
