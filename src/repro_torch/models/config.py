"""Model configuration schema (a copy of ``repro/models/config.py``).

One ``ModelConfig`` describes every assigned architecture.  The port keeps
its own copy so that it imports nothing of the JAX package.  ``to_ir``
converts it to the port's copy of the simulator's Transformer IR
(``repro_torch.core.ir``), as the reference's does, for the families the
port has configs for; another family raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer slot inside the repeating block."""
    kind: str = "attn"                 # "attn" | "ssm"
    window: Optional[int] = None       # sliding-window size for attn


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder-decoder models (frontend is stubbed:
    inputs arrive as precomputed frame/patch embeddings)."""
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    gated: bool = False                # Seamless uses plain FFN


def _check_family(cfg: "ModelConfig") -> None:
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


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab_size: int
    # block structure: pattern of layers repeated `block_repeat` times
    block_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    block_repeat: int = 1
    # attention
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: Optional[int] = None     # default d_model // n_heads
    qkv_bias: bool = False
    rope: str = "rope"                 # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    attn_kind: str = "gqa"             # "gqa" | "mla"
    # MLA dims (DeepSeek-V2)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # FFN
    d_ff: int = 0
    ffn_gated: bool = True
    ffn_kind: str = "dense"            # "dense" | "moe" | "none"
    # MoE
    n_routed: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0             # DeepSeek: first k layers use dense FFN
    d_ff_dense_first: int = 0
    # SSM (Mamba2)
    d_inner: int = 0
    d_state: int = 0
    n_ssd_heads: int = 0
    d_conv: int = 4
    n_ssm_groups: int = 1
    # Zamba2-style shared attention block (one weight set reused per repeat)
    shared_attn: bool = False
    shared_d_ff: int = 0
    # embeddings / head
    tie_embeddings: bool = False
    # encoder-decoder
    encoder: Optional[EncoderConfig] = None
    cross_attn: bool = False           # decoder layers attend to enc memory
    cross_source_len: int = 1024       # nominal encoder length for the IR
    # modality frontend stub: model consumes embeddings, not token ids
    embeds_input: bool = False
    dtype: str = "bfloat16"

    # -- derived -------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        n = len(self.block_pattern) * self.block_repeat
        if self.shared_attn:
            n += self.block_repeat          # one shared block per repeat
        return n

    @property
    def windows(self) -> tuple:
        return tuple(sorted({s.window for s in self.block_pattern
                             if s.kind == "attn"},
                            key=lambda w: (w is None, w)))

    def validate(self) -> None:
        hd = self.resolved_head_dim
        if self.attn_kind == "gqa" and any(s.kind == "attn"
                                           for s in self.block_pattern):
            if self.n_heads % self.n_kv_heads:
                raise ValueError("n_heads must divide by n_kv_heads")
        if self.ffn_kind == "moe" and (not self.n_routed or not self.top_k):
            raise ValueError("moe config incomplete")
        if any(s.kind == "ssm" for s in self.block_pattern):
            if not (self.d_inner and self.d_state and self.n_ssd_heads):
                raise ValueError("ssm config incomplete")
            if self.d_inner % self.n_ssd_heads:
                raise ValueError("d_inner must divide n_ssd_heads")
        del hd

    # -- Transformer IR conversion (core/ir.py) ------------------------------

    def to_ir(self):
        """Convert to the APEX Transformer IR (the paper's §3.2.1).
        The dense first layers of ``first_k_dense`` are not modelled: the
        block repeats ``block_repeat`` times, as in the reference."""
        from repro_torch.core import ir as IR
        _check_family(self)
        cells = []
        for i, spec in enumerate(self.block_pattern):
            if spec.kind == "ssm":
                cells.append(IR.SSMCell(
                    name=f"ssm{i}", d_model=self.d_model,
                    d_inner=self.d_inner, d_state=self.d_state,
                    n_ssd_heads=self.n_ssd_heads, d_conv=self.d_conv,
                    n_groups=self.n_ssm_groups))
                continue
            if self.attn_kind == "mla":
                cells.append(IR.MLACell(
                    name=f"mla{i}", d_model=self.d_model,
                    n_heads=self.n_heads, kv_lora_rank=self.kv_lora_rank,
                    qk_nope_head_dim=self.qk_nope_head_dim,
                    qk_rope_head_dim=self.qk_rope_head_dim,
                    v_head_dim=self.v_head_dim))
            else:
                cells.append(IR.AttentionCell(
                    name=f"attn{i}", d_model=self.d_model,
                    n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                    head_dim=self.resolved_head_dim,
                    qkv_bias=self.qkv_bias, window=spec.window,
                    rope=self.rope))
            if self.cross_attn:
                cells.append(IR.CrossAttentionCell(
                    name=f"xattn{i}", d_model=self.d_model,
                    n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                    head_dim=self.resolved_head_dim,
                    source_len=self.cross_source_len))
            if self.ffn_kind == "moe":
                cells.append(IR.MoECell(
                    name=f"moe{i}", d_model=self.d_model,
                    d_ff_expert=self.d_ff_expert, n_routed=self.n_routed,
                    top_k=self.top_k, n_shared=self.n_shared,
                    gated=self.ffn_gated))
            elif self.ffn_kind == "dense":
                cells.append(IR.MLPCell(
                    name=f"mlp{i}", d_model=self.d_model, d_ff=self.d_ff,
                    gated=self.ffn_gated))
        if self.shared_attn:
            cells.append(IR.AttentionCell(
                name="shared_attn", d_model=self.d_model,
                n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                head_dim=self.resolved_head_dim))
            cells.append(IR.MLPCell(
                name="shared_mlp", d_model=self.d_model,
                d_ff=self.shared_d_ff or self.d_ff, gated=self.ffn_gated))
        block = IR.Block(cells=tuple(cells), repeat=self.block_repeat)
        enc = None
        if self.encoder is not None:
            e = self.encoder
            enc = IR.Block(cells=(
                IR.AttentionCell(name="enc_attn", d_model=e.d_model,
                                 n_heads=e.n_heads, n_kv_heads=e.n_heads,
                                 head_dim=e.d_model // e.n_heads),
                IR.MLPCell(name="enc_mlp", d_model=e.d_model, d_ff=e.d_ff,
                           gated=e.gated),
            ), repeat=e.n_layers)
        return IR.ModelIR(name=self.name, d_model=self.d_model,
                          vocab_size=self.vocab_size, block=block,
                          tie_embeddings=self.tie_embeddings, encoder=enc)
