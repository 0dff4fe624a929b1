"""The Transformer IR (``repro.core.ir``) of a port config.

``model_ir`` is a copy of ``ModelConfig.to_ir`` in
``repro/models/config.py`` for the families the port has configs for:
GQA decoders with a dense FFN (attention + MLP cells) or a MoE FFN
(attention + MoE cells), MLA decoders (MLA + MoE cells; like the
reference, the block repeats ``block_repeat`` times and the dense
prefix block is not modelled), Mamba2 (SSM cells), M-RoPE decoders
(qwen2-vl: attention cells with ``rope="mrope"``), encoder-decoders
(seamless: a cross-attention cell after each decoder attention cell,
and an encoder block of attention + MLP cells), and a shared attention
block (zamba2: ``shared_attn`` and ``shared_mlp`` cells after each
block's own).  The reference's method cannot be called here:
``repro.models`` loads JAX.
"""

from __future__ import annotations

from repro.core import ir as IR

from repro_torch.models.config import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    """Raise for a config outside the GQA or MLA (dense or MoE FFN), SSM
    (with or without a shared attention block) and encoder-decoder
    families."""
    unsupported = []
    if cfg.attn_kind not in ("gqa", "mla"):
        unsupported.append(f"attn_kind={cfg.attn_kind!r}")
    if cfg.ffn_kind not in ("dense", "moe", "none"):
        unsupported.append(f"ffn_kind={cfg.ffn_kind!r}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: no IR for {', '.join(unsupported)}; the port has "
            f"configs for dense GQA decoders, MoE GQA and MLA decoders, "
            f"Mamba2 (with zamba2's shared block) and encoder-decoders "
            f"only")


def model_ir(cfg: ModelConfig) -> IR.ModelIR:
    """The IR ``repro.configs`` ``get_config(name).to_ir()`` gives for the
    same architecture."""
    _check_family(cfg)
    cells = []
    for i, spec in enumerate(cfg.block_pattern):
        if spec.kind == "ssm":
            cells.append(IR.SSMCell(
                name=f"ssm{i}", d_model=cfg.d_model,
                d_inner=cfg.d_inner, d_state=cfg.d_state,
                n_ssd_heads=cfg.n_ssd_heads, d_conv=cfg.d_conv,
                n_groups=cfg.n_ssm_groups))
            continue
        if cfg.attn_kind == "mla":
            cells.append(IR.MLACell(
                name=f"mla{i}", d_model=cfg.d_model,
                n_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank,
                qk_nope_head_dim=cfg.qk_nope_head_dim,
                qk_rope_head_dim=cfg.qk_rope_head_dim,
                v_head_dim=cfg.v_head_dim))
        else:
            cells.append(IR.AttentionCell(
                name=f"attn{i}", d_model=cfg.d_model,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim,
                qkv_bias=cfg.qkv_bias, window=spec.window, rope=cfg.rope))
        if cfg.cross_attn:
            cells.append(IR.CrossAttentionCell(
                name=f"xattn{i}", d_model=cfg.d_model,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim,
                source_len=cfg.cross_source_len))
        if cfg.ffn_kind == "moe":
            cells.append(IR.MoECell(
                name=f"moe{i}", d_model=cfg.d_model,
                d_ff_expert=cfg.d_ff_expert, n_routed=cfg.n_routed,
                top_k=cfg.top_k, n_shared=cfg.n_shared,
                gated=cfg.ffn_gated))
        elif cfg.ffn_kind == "dense":
            cells.append(IR.MLPCell(
                name=f"mlp{i}", d_model=cfg.d_model, d_ff=cfg.d_ff,
                gated=cfg.ffn_gated))
    if cfg.shared_attn:
        cells.append(IR.AttentionCell(
            name="shared_attn", d_model=cfg.d_model,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim))
        cells.append(IR.MLPCell(
            name="shared_mlp", d_model=cfg.d_model,
            d_ff=cfg.shared_d_ff or cfg.d_ff, gated=cfg.ffn_gated))
    block = IR.Block(cells=tuple(cells), repeat=cfg.block_repeat)
    enc = None
    if cfg.encoder is not None:
        e = cfg.encoder
        enc = IR.Block(cells=(
            IR.AttentionCell(name="enc_attn", d_model=e.d_model,
                             n_heads=e.n_heads, n_kv_heads=e.n_heads,
                             head_dim=e.d_model // e.n_heads),
            IR.MLPCell(name="enc_mlp", d_model=e.d_model, d_ff=e.d_ff,
                       gated=e.gated),
        ), repeat=e.n_layers)
    return IR.ModelIR(name=cfg.name, d_model=cfg.d_model,
                      vocab_size=cfg.vocab_size, block=block,
                      tie_embeddings=cfg.tie_embeddings, encoder=enc)
