"""Decoder of the port (``repro/models/transformer.py``): GQA and MLA
decoders with a dense or MoE FFN, attention-free Mamba2 stacks, Mamba2
stacks with one shared attention block (zamba2), M-RoPE decoders fed
embeddings (qwen2-vl) and the decoder of an encoder-decoder model
(seamless; ``models.encdec`` holds its encoder).

Parameters are an ``nn.Module`` tree that mirrors the reference's pytree:
``embed``, ``final_norm``, optional ``head``, and ``blocks``, a
``ModuleList`` of ``block_repeat - first_k_dense`` blocks, each a
``ModuleDict`` of layers keyed ``l0``, ``l1``, ... by block-pattern
slot: a ``DecoderLayer`` (``norm1``, ``attn``, ``norm2``, ``ffn``; with
cross-attention also ``norm_x`` and ``xattn``) for an attention slot
(``ffn`` a ``MoEParams`` in a MoE model), an ``SSMLayer`` (``norm1``,
``mixer``) for an SSM slot.  An encoder-decoder model also has
``encoder`` (``models.encdec.Encoder``).  A model with
``first_k_dense`` prefix blocks (deepseek: one) also has ``prefix``, a
``ModuleList`` of that many blocks laid out alike, whose FFN is a dense
MLP of ``d_ff_dense_first``; they run before ``blocks``.  A model with
a shared attention block (zamba2) also has ``shared``, a ``SharedBlock``
(``norm1``, ``attn``, ``norm2``, ``mlp``): ONE weight set that runs after
the layers of every block, so its gradient sums over the block_repeat
applications, as ``jax.grad`` sums it over the reference's scan.
The reference stacks block parameters on a leading R axis for
``lax.scan`` and keeps its unscanned prefix blocks as a list; here the
scan is a loop over the R block modules.

``forward`` (training) runs the whole sequence through the flash kernel
or the SSD-scan kernel, from token ids or from embeddings (``embeds``),
at ``positions`` (default ``arange``; (t, h, w) ids under M-RoPE), and
attends to an encoder's memory (``enc_memory``) through the flash kernel
without the causal mask; ``decode_step`` and the token-replay ``prefill``
(serving) run under ``torch.no_grad`` through the decode-attention
kernel or the one-step Mamba2 recurrence, cross-attention through the
decode kernel over the whole cross cache.

The cache keeps the reference's layout, per pattern slot: ``k``/``v``
(R, B, Smax, Hkv, D) for GQA; the latents ``c_kv`` (R, B, Smax, r) and
rotated RoPE keys ``k_pe`` (R, B, Smax, dr) for MLA; ``ssm`` (R, B, H,
P, N) fp32 and the conv windows ``conv_x`` (R, B, K-1, d_inner) and
``conv_bc`` (R, B, K-1, 2 N) for SSM; with cross-attention also ``xk``/``xv``
(R, B, Se, Hkv, D), the encoder memory's keys and values; plus ``len``
(B,) int32.  The
prefix blocks' caches are the list ``prefix``, the same leaves without
the R axis.  The shared block's caches are ``shared``: ``k``/``v``
(block_repeat, B, Smax, Hkv, D), one per application.  ``decode_step`` writes the new K/V rows (latents) and the
new SSM state and windows into it in place.

Sliding-window layers keep ring caches of ``min(max_len,
ring_size(window))`` slots (``init_cache``, ``gqa_decode_step``).

``CapturedStep`` is one ``decode_step`` over fixed shapes captured as a
CUDA graph, bound to one cache; ``decode_step(..., graph=...)`` replays
it (the serving engine's steps on a card).

Ported: GQA and MLA decoders with a dense or MoE FFN (mixtral;
deepseek, with its first-k-dense prefix), blocks of several attention
layers with their own windows (gemma3: five sliding-window layers and
one global layer), all-SSM stacks without an FFN (mamba2), the shared
attention block after the SSM layers of every block (zamba2: six Mamba2
layers, then the tied block, 13 times), M-RoPE and embedding inputs
(qwen2-vl), and cross-attention to an encoder's memory (seamless).
Attention without an FFN, attention and SSM layers in one block, SSM
layers with MoE, a prefix or cross-attention, a shared block beside
attention layers and several SSM groups raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import to_cache_dtype, torch_dtype
from repro_torch.kernels import decode_attention as _decode_kernel
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels import ssd_scan as _ssd_kernel
from repro_torch.layers.attention import attend_decode
from repro_torch.layers import (blockwise_attention, gqa_attention,
                                gqa_decode_step, init_attention,
                                init_mamba2, init_mla, init_mlp, init_moe,
                                mamba2_decode_step, mamba2_forward,
                                mla_attention, mla_decode_step,
                                mlp_forward, moe_forward, rms_norm)
from repro_torch.layers.hints import (data_axis_names, mesh_axis_size,
                                     shard_hint, split_last, table_rows)
from repro_torch.layers.mlp import normal_param
from repro_torch.tracing import span
from .config import LayerSpec, ModelConfig


ENCDEC_PREFILL = ("encoder-decoder models prefill via "
                  "repro_torch.models.encdec.encdec_prefill")


def ring_size(window: int, multiple: int = 16) -> int:
    """Sliding-window ring-cache size: window+1 rounded up for sharding."""
    return -(-(window + 1) // multiple) * multiple


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    missing = []
    ssm = any(s.kind == "ssm" for s in cfg.block_pattern)
    if ssm and any(s.kind == "attn" for s in cfg.block_pattern):
        missing.append("attention and SSM layers in one block")
    if cfg.attn_kind not in ("gqa", "mla"):
        missing.append(f"attn_kind={cfg.attn_kind!r}")
    if cfg.ffn_kind not in (("none",) if ssm else ("dense", "moe")):
        missing.append(f"ffn_kind={cfg.ffn_kind!r}")
    if ssm and cfg.n_ssm_groups != 1:
        missing.append(f"n_ssm_groups={cfg.n_ssm_groups}")
    if ssm and cfg.cross_attn:
        missing.append("cross-attention beside SSM layers")
    if cfg.shared_attn and not ssm:
        missing.append("a shared attention block beside attention layers")
    if ssm and cfg.first_k_dense:
        missing.append("first_k_dense prefix blocks of SSM layers")
    if cfg.rope not in ("rope", "mrope", "none"):
        missing.append(f"rope={cfg.rope!r}")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: "
                                  + ", ".join(missing))


def _ones(d: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=dtype, device=device))


class DecoderLayer(nn.Module):
    """One attention + FFN layer: ``norm1``, ``attn``, ``norm2``, ``ffn``;
    a decoder layer of an encoder-decoder model also has ``norm_x`` and
    ``xattn`` (cross-attention's ``wq``, ``wk``, ``wv``, ``wo``)."""

    def __init__(self, norm1: nn.Parameter, attn: nn.ParameterDict,
                 norm2: nn.Parameter, ffn: nn.ParameterDict,
                 norm_x: Optional[nn.Parameter] = None,
                 xattn: Optional[nn.ParameterDict] = None):
        super().__init__()
        self.norm1 = norm1
        self.attn = attn
        self.norm2 = norm2
        self.ffn = ffn
        self.norm_x = norm_x
        self.xattn = xattn


class SSMLayer(nn.Module):
    """One Mamba2 layer: ``norm1`` and the ``mixer`` (no FFN)."""

    def __init__(self, norm1: nn.Parameter, mixer: nn.ParameterDict):
        super().__init__()
        self.norm1 = norm1
        self.mixer = mixer


class SharedBlock(nn.Module):
    """zamba2's shared attention + MLP block: ``norm1``, ``attn`` (GQA,
    no bias), ``norm2``, ``mlp``; one weight set for every block."""

    def __init__(self, norm1: nn.Parameter, attn: nn.ParameterDict,
                 norm2: nn.Parameter, mlp: nn.ParameterDict):
        super().__init__()
        self.norm1 = norm1
        self.attn = attn
        self.norm2 = norm2
        self.mlp = mlp


class Transformer(nn.Module):
    """Parameter tree of a decoder (see the module docstring)."""

    def __init__(self, embed: nn.Parameter, final_norm: nn.Parameter,
                 blocks: nn.ModuleList,
                 head: Optional[nn.Parameter] = None,
                 prefix: Optional[nn.ModuleList] = None,
                 encoder: Optional[nn.Module] = None,
                 shared: Optional[SharedBlock] = None):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        self.blocks = blocks
        self.head = head
        self.prefix = prefix
        self.encoder = encoder
        self.shared = shared


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Transformer:
    """Random parameters with the reference's shapes and scales (not its
    values: ``jax.random`` draws cannot be reproduced with torch).  Draws
    happen on ``gen``'s device; the tensors land on ``device`` in
    ``cfg.dtype``.  To compute on the reference's weights, convert them
    with ``repro_torch.convert.params_from_jax``."""
    cfg.validate()
    check_supported(cfg)
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    embed = normal_param(gen, (cfg.vocab_size, d), 1.0 / math.sqrt(d), dt,
                         device)
    head = None
    if not cfg.tie_embeddings:
        head = normal_param(gen, (d, cfg.vocab_size), 1.0 / math.sqrt(d),
                            dt, device)

    def layer(spec: LayerSpec, dense_ffn: bool) -> nn.Module:
        if spec.kind == "ssm":
            return SSMLayer(_ones(d, dt, device), init_mamba2(
                gen, d, cfg.d_inner, cfg.d_state, cfg.n_ssd_heads,
                cfg.d_conv, cfg.n_ssm_groups, dtype=dt, device=device))
        if cfg.attn_kind == "mla":
            attn = init_mla(gen, d, cfg.n_heads, cfg.kv_lora_rank,
                            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                            cfg.v_head_dim, dtype=dt, device=device)
        else:
            attn = init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, cfg.qkv_bias,
                                  dtype=dt, device=device)
        if cfg.ffn_kind == "moe" and not dense_ffn:
            ffn = init_moe(gen, d, cfg.d_ff_expert, cfg.n_routed, cfg.top_k,
                           cfg.n_shared, cfg.ffn_gated, dtype=dt,
                           device=device)
        else:
            d_ff = cfg.d_ff_dense_first if dense_ffn and \
                cfg.d_ff_dense_first else cfg.d_ff
            ffn = init_mlp(gen, d, d_ff, cfg.ffn_gated, dtype=dt,
                           device=device)
        cross = {}
        if cfg.cross_attn:
            cross = dict(norm_x=_ones(d, dt, device), xattn=init_attention(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                dtype=dt, device=device))
        return DecoderLayer(_ones(d, dt, device), attn,
                            _ones(d, dt, device), ffn, **cross)

    def block_list(n: int, dense_ffn: bool = False) -> nn.ModuleList:
        return nn.ModuleList(
            nn.ModuleDict({f"l{i}": layer(spec, dense_ffn)
                           for i, spec in enumerate(cfg.block_pattern)})
            for _ in range(n))

    n_scan = cfg.block_repeat - cfg.first_k_dense
    if n_scan <= 0:
        raise ValueError("first_k_dense must be < block_repeat")
    prefix = block_list(cfg.first_k_dense, dense_ffn=True) \
        if cfg.first_k_dense else None
    blocks = block_list(n_scan)
    shared = None
    if cfg.shared_attn:
        shared = SharedBlock(
            _ones(d, dt, device),
            init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, dtype=dt, device=device),
            _ones(d, dt, device),
            init_mlp(gen, d, cfg.shared_d_ff or cfg.d_ff, cfg.ffn_gated,
                     dtype=dt, device=device))
    return Transformer(embed, _ones(d, dt, device), blocks, head, prefix,
                       shared=shared)


def param_count(params: nn.Module) -> int:
    """The number of parameter values; zamba2's one shared block counts
    once, as its one set of leaves does in the reference's pytree."""
    return sum(p.numel() for p in params.parameters())


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, cache_dtype=None, source_len: int = 0) -> dict:
    """All-zero cache: per GQA slot ``k``/``v`` (R, B, Smax, Hkv, D),
    ``Smax = max_len`` for full attention and ``min(max_len,
    ring_size(window))`` for sliding-window layers; per MLA slot ``c_kv``
    (R, B, max_len, r) and ``k_pe`` (R, B, max_len, dr); per SSM slot
    ``ssm`` (R, B, H, P, N) fp32, ``conv_x`` (R, B, K-1, d_inner) and
    ``conv_bc`` (R, B, K-1, 2 G N); with cross-attention, per attention
    slot also ``xk``/``xv`` (R, B, source_len, Hkv, D); ``len`` (B,)
    int32.  R is ``block_repeat - first_k_dense``; a model with prefix
    blocks also has ``prefix``, a list of their caches, the same leaves
    without R; a model with a shared block also has ``shared``, its
    ``k``/``v`` (block_repeat, B, max_len, Hkv, D), one per
    application."""
    check_supported(cfg)
    dt = torch_dtype(cache_dtype if cache_dtype is not None else cfg.dtype)
    R = cfg.block_repeat - cfg.first_k_dense
    hd = cfg.resolved_head_dim

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def layer_cache(spec: LayerSpec, lead=(R,)) -> dict:
        if spec.kind == "ssm":
            P = cfg.d_inner // cfg.n_ssd_heads
            gn = cfg.n_ssm_groups * cfg.d_state
            return {
                "ssm": zeros(*lead, batch, cfg.n_ssd_heads, P, cfg.d_state,
                             dtype=torch.float32),
                "conv_x": zeros(*lead, batch, cfg.d_conv - 1, cfg.d_inner),
                "conv_bc": zeros(*lead, batch, cfg.d_conv - 1, 2 * gn),
            }
        if cfg.attn_kind == "mla":
            c = {"c_kv": zeros(*lead, batch, max_len, cfg.kv_lora_rank),
                 "k_pe": zeros(*lead, batch, max_len, cfg.qk_rope_head_dim)}
        else:
            kv_len = max_len if spec.window is None \
                else min(max_len, ring_size(spec.window))
            c = {"k": zeros(*lead, batch, kv_len, cfg.n_kv_heads, hd),
                 "v": zeros(*lead, batch, kv_len, cfg.n_kv_heads, hd)}
        if cfg.cross_attn:
            c["xk"] = zeros(*lead, batch, source_len, cfg.n_kv_heads, hd)
            c["xv"] = zeros(*lead, batch, source_len, cfg.n_kv_heads, hd)
        return c

    cache = {
        "blocks": {f"l{i}": layer_cache(spec)
                   for i, spec in enumerate(cfg.block_pattern)},
        "len": torch.zeros(batch, dtype=torch.int32, device=device),
    }
    if cfg.first_k_dense:
        cache["prefix"] = [{f"l{i}": layer_cache(spec, lead=())
                            for i, spec in enumerate(cfg.block_pattern)}
                           for _ in range(cfg.first_k_dense)]
    if cfg.shared_attn:
        shape = (cfg.block_repeat, batch, max_len, cfg.n_kv_heads, hd)
        cache["shared"] = {"k": zeros(*shape), "v": zeros(*shape)}
    return cache


def _ffn_apply(cfg: ModelConfig, p: nn.ParameterDict,
               x: torch.Tensor) -> torch.Tensor:
    """A MoE FFN (it has a router), or a dense MLP: a MoE model's prefix
    blocks have MLPs."""
    if "router" in p:
        return moe_forward(p, x, cfg.top_k)
    return mlp_forward(p, x)


def _layer_apply(cfg: ModelConfig, spec: LayerSpec, p: nn.Module,
                 x: torch.Tensor, positions: torch.Tensor,
                 enc_memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    if spec.kind == "ssm":
        return x + mamba2_forward(p.mixer, rms_norm(x, p.norm1),
                                  d_inner=cfg.d_inner, d_state=cfg.d_state,
                                  n_heads=cfg.n_ssd_heads,
                                  n_groups=cfg.n_ssm_groups)
    h = rms_norm(x, p.norm1)
    # Archs whose head count does not divide the model axis (qwen2-0.5b
    # 14, qwen1.5-32b 40, qwen2-vl 28) keep their attention projections
    # replicated; the batch is resharded over the data axes and "model"
    # around attention instead, as in the reference (no-ops off a mesh,
    # and per dim where the batch does not divide).
    m_sz = mesh_axis_size("model")
    reshard = m_sz > 1 and cfg.n_heads % m_sz != 0
    if reshard:
        h = shard_hint(h, data_axis_names() + ("model",), None, None)
    if cfg.attn_kind == "mla":
        attn = mla_attention(p.attn, h, positions, n_heads=cfg.n_heads,
                             kv_lora_rank=cfg.kv_lora_rank,
                             qk_nope_head_dim=cfg.qk_nope_head_dim,
                             qk_rope_head_dim=cfg.qk_rope_head_dim,
                             v_head_dim=cfg.v_head_dim,
                             rope_theta=cfg.rope_theta)
    else:
        attn = gqa_attention(p.attn, h, positions, n_heads=cfg.n_heads,
                             n_kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.resolved_head_dim,
                             window=spec.window, rope=cfg.rope,
                             rope_theta=cfg.rope_theta)
    if reshard:
        attn = shard_hint(attn, data_axis_names() or None, None, None)
    x = x + attn
    if cfg.cross_attn and enc_memory is not None:
        x = x + _cross_attention(cfg, p.xattn, rms_norm(x, p.norm_x),
                                 enc_memory)
    return x + _ffn_apply(cfg, p.ffn, rms_norm(x, p.norm2))


def _cross_attention(cfg: ModelConfig, xp: nn.ParameterDict,
                     h: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """Attention of the decoder's ``h`` (B, S, d) over the encoder's
    ``memory`` (B, Se, d): no mask, no RoPE, no bias; the flash kernel
    with ``causal=False`` and Sq = S, Skv = Se."""
    B, S, _ = h.shape
    Se = memory.shape[1]
    hd = cfg.resolved_head_dim
    q = split_last(h @ xp["wq"], B, S, cfg.n_heads, hd)
    k = split_last(memory @ xp["wk"], B, Se, cfg.n_kv_heads, hd)
    v = split_last(memory @ xp["wv"], B, Se, cfg.n_kv_heads, hd)
    out = blockwise_attention(q, k, v, causal=False)
    return out.reshape(B, S, cfg.n_heads * hd) @ xp["wo"]


def _shared_apply(cfg: ModelConfig, shared: SharedBlock, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """The shared attention + MLP block over the whole sequence."""
    h = rms_norm(x, shared.norm1)
    x = x + gqa_attention(shared.attn, h, positions, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.resolved_head_dim, rope=cfg.rope,
                          rope_theta=cfg.rope_theta)
    return x + mlp_forward(shared.mlp, rms_norm(x, shared.norm2))


def _block_apply(cfg: ModelConfig, blk: nn.ModuleDict, x: torch.Tensor,
                 positions: torch.Tensor, nest_remat: bool = False,
                 enc_memory: Optional[torch.Tensor] = None,
                 shared: Optional[SharedBlock] = None) -> torch.Tensor:
    """The block's layers, each in a checkpoint of its own with
    ``nest_remat``, then the shared block where there is one (never
    checkpointed on its own, as in the reference)."""
    for i, spec in enumerate(cfg.block_pattern):
        if nest_remat:
            x = checkpoint(_layer_apply, cfg, spec, blk[f"l{i}"], x,
                           positions, enc_memory, use_reentrant=False)
        else:
            x = _layer_apply(cfg, spec, blk[f"l{i}"], x, positions,
                             enc_memory)
    if shared is not None:
        x = _shared_apply(cfg, shared, x, positions)
    return x


def _prefix_blocks(params: Transformer, cfg: ModelConfig) -> list:
    """``params.prefix`` as a list, which must hold ``first_k_dense``
    blocks."""
    blocks = list(params.prefix or ())
    if len(blocks) != cfg.first_k_dense:
        raise ValueError(f"{len(blocks)} prefix blocks for first_k_dense "
                         f"{cfg.first_k_dense}")
    return blocks


def _shared_block(params: Transformer,
                  cfg: ModelConfig) -> Optional[SharedBlock]:
    """``params.shared``, which a config with ``shared_attn`` needs and
    any other must not have."""
    if (params.shared is not None) != cfg.shared_attn:
        have = "have" if params.shared is not None else "lack"
        raise ValueError(f"{cfg.name}: shared_attn={cfg.shared_attn} but "
                         f"the params {have} a shared block")
    return params.shared


def _embed(params: Transformer, cfg: ModelConfig,
           tokens: Optional[torch.Tensor],
           embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The input rows: ``embeds`` cast to the model's dtype where given
    (a stub frontend's patch or frame embeddings; contiguous, as the
    kernels take them, also when they are a slice of a prompt's), else
    the embedding rows of ``tokens``."""
    if embeds is not None:
        return embeds.to(torch_dtype(cfg.dtype)).contiguous()
    return table_rows(params.embed, tokens)


def forward(params: Transformer, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            enc_memory: Optional[torch.Tensor] = None,
            remat: bool = False,
            return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab).

    ``tokens`` (B, S) ids, or ``embeds`` (B, S, d_model) from a stub
    frontend (VLM patches); ``positions`` (B, S), or (B, S, 3) (t, h, w)
    ids under M-RoPE, default ``arange(S)`` on every axis;
    ``enc_memory`` (B, Se, d_model), an encoder's output, which every
    decoder layer of a cross-attention model attends to.

    ``remat`` checkpoints each block (``torch.utils.checkpoint``,
    non-reentrant) where the reference wraps the scanned block in
    ``jax.checkpoint``: the backward pass runs the block's forward again,
    kernels included, and the numbers do not change.  A block of several
    layers (gemma3's six) also checkpoints each of its layers inside the
    block's checkpoint, as the reference's ``nest_remat`` does; a block
    of one layer does not, where the reference says that re-running the
    same region a third time only costs.  The shared block (zamba2)
    runs at the end of every block, inside the block's checkpoint.
    ``return_hidden``
    returns the final-norm hidden states (B, S, d_model) instead of
    logits.  Prefix blocks run first, never checkpointed, as in the
    reference."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        if cfg.rope == "mrope":
            positions = positions[..., None].expand(B, S, 3)
    for blk in _prefix_blocks(params, cfg):
        x = _block_apply(cfg, blk, x, positions, enc_memory=enc_memory)
    nest_remat = remat and len(cfg.block_pattern) > 1
    shared = _shared_block(params, cfg)
    for blk in params.blocks:
        if remat:
            x = checkpoint(_block_apply, cfg, blk, x, positions, nest_remat,
                           enc_memory, shared, use_reentrant=False)
        else:
            x = _block_apply(cfg, blk, x, positions, enc_memory=enc_memory,
                             shared=shared)
    x = rms_norm(x, params.final_norm)
    if return_hidden:
        return x
    head = params.embed.T if cfg.tie_embeddings else params.head
    return x @ head


def _layer_decode(cfg: ModelConfig, spec: LayerSpec, p: nn.Module,
                  x: torch.Tensor, lc: dict, r: int,
                  cache_len: torch.Tensor,
                  cross_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer of block ``r`` for one token; writes the layer's cache
    ``lc`` (block ``r``'s rows) in place.  ``cross_len`` (B,) int32: the
    cross cache's length Se in every row, where it has one."""
    h = rms_norm(x, p.norm1)
    if spec.kind == "ssm":
        with span("model.attention"):
            y, state, conv = mamba2_decode_step(
                p.mixer, h, lc["ssm"][r],
                {"x": lc["conv_x"][r], "bc": lc["conv_bc"][r]},
                d_inner=cfg.d_inner, d_state=cfg.d_state,
                n_heads=cfg.n_ssd_heads, n_groups=cfg.n_ssm_groups)
            lc["ssm"][r].copy_(state)
            lc["conv_x"][r].copy_(to_cache_dtype(conv["x"],
                                                 lc["conv_x"].dtype))
            lc["conv_bc"][r].copy_(to_cache_dtype(conv["bc"],
                                                  lc["conv_bc"].dtype))
        return x + y
    with span("model.attention"):
        if cfg.attn_kind == "mla":
            y, _, _ = mla_decode_step(
                p.attn, h, lc["c_kv"][r], lc["k_pe"][r], cache_len,
                n_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank,
                qk_nope_head_dim=cfg.qk_nope_head_dim,
                qk_rope_head_dim=cfg.qk_rope_head_dim,
                v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta)
        else:
            y, _, _ = gqa_decode_step(
                p.attn, h, lc["k"][r], lc["v"][r], cache_len,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, window=spec.window,
                rope=cfg.rope, rope_theta=cfg.rope_theta)
    x = x + y
    if cross_len is not None:
        x = x + _cross_decode(cfg, p.xattn, rms_norm(x, p.norm_x),
                              lc["xk"][r], lc["xv"][r], cross_len)
    return x + _ffn_apply(cfg, p.ffn, rms_norm(x, p.norm2))


def _cross_decode(cfg: ModelConfig, xp: nn.ParameterDict, h: torch.Tensor,
                  xk: torch.Tensor, xv: torch.Tensor,
                  cross_len: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention over the whole cross cache ``xk``/``xv``
    (B, Se, Hkv, D) through ``kernels.decode_attention`` with every row's
    length Se (group ``Hq // Hkv``).  The reference writes it as an einsum
    softmax over the cache, the function the kernel computes."""
    B = h.shape[0]
    hd = cfg.resolved_head_dim
    q = split_last(h @ xp["wq"], B, cfg.n_heads, hd)
    out = attend_decode(q, xk, xv, cross_len)
    return out.reshape(B, 1, cfg.n_heads * hd) @ xp["wo"]


def _shared_decode(cfg: ModelConfig, shared: SharedBlock, x: torch.Tensor,
                   caches: dict, r: int,
                   cache_len: torch.Tensor) -> torch.Tensor:
    """The shared block for one token after block ``r``'s layers, on
    application ``r``'s K/V cache (written in place)."""
    y, _, _ = gqa_decode_step(
        shared.attn, rms_norm(x, shared.norm1), caches["k"][r],
        caches["v"][r], cache_len, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        rope=cfg.rope, rope_theta=cfg.rope_theta)
    x = x + y
    return x + mlp_forward(shared.mlp, rms_norm(x, shared.norm2))


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig,
                tokens: torch.Tensor, cache: dict,
                embeds: Optional[torch.Tensor] = None,
                graph: Optional["CapturedStep"] = None
                ) -> Tuple[torch.Tensor, dict]:
    """One serving step: (B, 1) token ids (or ``embeds`` (B, 1, d_model))
    + cache -> logits (B, vocab) and the cache with ``len`` advanced by
    one.

    The K/V (latent, or SSM state and conv window) tensors of ``cache``
    are updated in place and shared by the returned cache; only ``len``
    is a new tensor.  Prefix blocks run first, on the ``prefix`` caches;
    the shared block (zamba2) runs after each block's layers, on its
    ``shared`` cache of that application.  A cross-attention model attends to the cache's ``xk``/``xv`` (filled
    by ``models.encdec.encdec_prefill``); over a cross cache of no
    source tokens it adds nothing, as the reference's empty softmax
    does.  While a ``torch.profiler`` profile records, the step is a
    ``model.decode_step`` span (``repro_torch.tracing``) around a
    ``model.attention`` span for each layer's mixer and ``model.head``.

    With ``graph`` (a ``CapturedStep`` of these params and this cache),
    the step is that graph's replay: the same kernels, launched by one
    graph launch, and the returned logits are the graph's static output,
    which its next replay overwrites.  No span opens inside a replay.
    """
    with span("model.decode_step"):
        if graph is None:
            logits = _decode_step(params, cfg, tokens, cache, embeds)
        elif embeds is not None:
            raise ValueError("decode_step: a captured step takes token ids, "
                             "not embeds")
        else:
            logits = graph.replay(params, tokens, cache)
        return logits, dict(cache, len=cache["len"] + 1)


# the kernel wrappers whose launch counters a replayed step advances
_COUNTED = (_rmsnorm_kernel, _decode_kernel, _flash_kernel, _ssd_kernel)


def _launch_counts() -> list:
    """(launches, variant_launches) of each wrapper of ``_COUNTED``."""
    return [(m.launches, dict(getattr(m, "variant_launches", {})))
            for m in _COUNTED]


def _set_launch_counts(counts: list) -> None:
    for m, (n, variants) in zip(_COUNTED, counts):
        m.launches = n
        if hasattr(m, "variant_launches"):
            m.variant_launches.clear()
            m.variant_launches.update(variants)


def _cache_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for t in tree.values() if isinstance(tree, dict) else tree:
            yield from _cache_leaves(t)


class CapturedStep:
    """One ``decode_step`` over fixed shapes, captured as a CUDA graph,
    that ``decode_step(..., graph=...)`` replays.

    It is bound to one parameter tree and one cache (the addresses of
    their tensors) and to the shape of ``tokens`` (B, 1): it holds static
    ``tokens`` and ``len`` (B,), into which a replay copies its inputs,
    and the static ``logits`` (B, vocab) that a replay writes.

    Capturing first runs one eager step on the capture stream: it loads
    the kernel library and sets up what each kernel needs on that stream
    (cuBLAS's handle and workspace, the decode wrapper's ticket buffer),
    so that the graph holds the step's kernels alone.  That step writes
    the cache's rows at ``cache["len"]`` and advances SSM state, which a
    second step would not undo: the cache must hold no request, and is
    zeroed in place afterwards.  The kernel wrappers' counters
    (``launches``, ``variant_launches``) are left as they were before
    that step; each replay adds the launches the captured step counted,
    as an eager step's Python would.
    """

    def __init__(self, params: Transformer, cfg: ModelConfig, cache: dict,
                 tokens: torch.Tensor):
        self.params = params
        self._bound = {k: v for k, v in cache.items() if k != "len"}
        self.tokens = tokens.clone()
        self.len = cache["len"].clone()
        static = dict(self._bound, len=self.len)
        device = tokens.device
        before = _launch_counts()
        stream = torch.cuda.Stream(device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(stream):
            _decode_step(params, cfg, self.tokens, static, None)
        torch.cuda.current_stream(device).wait_stream(stream)
        warm = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph, stream=stream):
            self.logits = _decode_step(params, cfg, self.tokens, static, None)
        after = _launch_counts()
        self._launched = [
            (n1 - n0, {k: c - v0.get(k, 0) for k, c in v1.items()
                       if c != v0.get(k, 0)})
            for (n0, v0), (n1, v1) in zip(warm, after)]
        _set_launch_counts(before)
        for t in _cache_leaves(self._bound):
            t.zero_()

    def replay(self, params: Transformer, tokens: torch.Tensor,
               cache: dict) -> torch.Tensor:
        """Copy ``tokens`` and ``cache["len"]`` into the static inputs,
        replay the graph and return the static logits."""
        if params is not self.params or tokens.shape != self.tokens.shape \
                or any(cache.get(k) is not v for k, v in self._bound.items()):
            raise ValueError("decode_step: the captured step is bound to "
                             "other params, another cache or token shape "
                             f"{tuple(self.tokens.shape)}")
        self.tokens.copy_(tokens)
        self.len.copy_(cache["len"])
        self.graph.replay()
        for m, (n, variants) in zip(_COUNTED, self._launched):
            m.launches += n
            for k, c in variants.items():
                m.variant_launches[k] = m.variant_launches.get(k, 0) + c
        return self.logits


def _decode_step(params: Transformer, cfg: ModelConfig,
                 tokens: torch.Tensor, cache: dict,
                 embeds: Optional[torch.Tensor]) -> torch.Tensor:
    check_supported(cfg)
    x = _embed(params, cfg, tokens, embeds)
    cache_len = cache["len"]
    cross_len = None
    if cfg.cross_attn:
        Se = cache["blocks"]["l0"]["xk"].shape[2]
        if Se:
            cross_len = torch.full((x.shape[0],), Se, dtype=torch.int32,
                                   device=x.device)
    prefix_caches = cache.get("prefix", [])
    if len(prefix_caches) != cfg.first_k_dense:
        raise ValueError(f"decode_step: {len(prefix_caches)} prefix block "
                         f"caches for first_k_dense {cfg.first_k_dense}")
    for blk, pc in zip(_prefix_blocks(params, cfg), prefix_caches):
        for i, spec in enumerate(cfg.block_pattern):
            # a leading axis of one, so that the prefix caches read like
            # block 0 of the scanned ones (views: writes reach ``pc``)
            lc = {name: t[None] for name, t in pc[f"l{i}"].items()}
            x = _layer_decode(cfg, spec, blk[f"l{i}"], x, lc, 0, cache_len,
                              cross_len)
    shared = _shared_block(params, cfg)
    for r, blk in enumerate(params.blocks):
        for i, spec in enumerate(cfg.block_pattern):
            x = _layer_decode(cfg, spec, blk[f"l{i}"], x,
                              cache["blocks"][f"l{i}"], r, cache_len,
                              cross_len)
        if shared is not None:
            x = _shared_decode(cfg, shared, x, cache["shared"], r,
                               cache_len)
    with span("model.head"):
        x = rms_norm(x, params.final_norm)
        head = params.embed.T if cfg.tie_embeddings else params.head
        return (x @ head)[:, 0, :]


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, embeds: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Build the cache by replaying the prompt through ``decode_step``,
    one token at a time, as the reference does.

    tokens: (B, S) right-padded; embeds: (B, S, d_model), which then
    stand in for the tokens' rows; lengths: (B,) true lengths (default
    S).  Returns (last-token logits (B, vocab), populated cache).  An
    encoder-decoder model raises ``ValueError``: it prefills through
    ``models.encdec.encdec_prefill``, as in the reference.
    """
    if cfg.cross_attn:
        raise ValueError(ENCDEC_PREFILL)
    B, S = tokens.shape[:2]
    device = tokens.device
    cache = init_cache(cfg, B, max_len, device=device)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=device)
    all_logits = []
    for t in range(S):
        emb = None if embeds is None else embeds[:, t:t + 1]
        logits, cache = decode_step(params, cfg, tokens[:, t:t + 1], cache,
                                    embeds=emb)
        all_logits.append(logits)
    # len advanced S times; clamp to the true lengths
    cache["len"] = lengths.to(device=device, dtype=torch.int32)
    stacked = torch.stack(all_logits)                      # (S, B, vocab)
    last = stacked[lengths.long() - 1, torch.arange(B, device=device)]
    return last, cache
