"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt scaled; unverified tier]

Block = 5 local (sliding-window 1024) + 1 global layer, repeated 8x (the
smallest non-repetitive cell chain — the Transformer-IR block).  long_500k
RUNS for this arch: 5/6 of layers have window-bounded KV (ring caches), so
decode memory is sub-quadratic-dominated; the global layers' KV is
mesh-sharded (see DESIGN.md §long_500k).

A copy of ``repro/configs/gemma3_12b.py``, field for field.  As there,
the model is a GQA decoder with RMSNorm before attention and FFN, one
``rope_theta`` for every layer, a SiLU-gated MLP and tied embeddings;
the Hugging Face model's other features (QK-norm, the norms after
attention and FFN, the embedding scale, the logit soft-cap, a second
RoPE base for the local layers) are in neither package.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=1024)
_GLOBAL = LayerSpec(kind="attn", window=None)

FULL = ModelConfig(
    name="gemma3-12b",
    d_model=3840,
    vocab_size=262144,
    block_pattern=(_LOCAL,) * 5 + (_GLOBAL,),
    block_repeat=8,                       # 48 layers
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    ffn_gated=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma3-reduced",
    d_model=96,
    vocab_size=512,
    block_pattern=(LayerSpec("attn", window=16),) * 2
    + (LayerSpec("attn", None),),
    block_repeat=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=24,
    d_ff=256,
    tie_embeddings=True,
)
