"""Model configuration schema (a copy of ``repro/models/config.py``).

One ``ModelConfig`` describes every assigned architecture.  The port keeps
its own copy so that it imports nothing of the JAX package; the converter
to the simulator's Transformer IR (``to_ir``) belongs to the simulator and
is left out.
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
