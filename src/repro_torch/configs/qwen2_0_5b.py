"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias, tied embeddings.  [arXiv:2407.10671; hf]

Pure full attention -> long_500k SKIPPED.  Note the awkward head count
(14 heads, kv=2): TP degrees are restricted to divisors of 14 for the
attention cell — the planner handles this via cell-level DP (DESIGN.md
§Arch-applicability).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b",
    d_model=896,
    vocab_size=151936,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=24,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    qkv_bias=True,
    d_ff=4864,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen2-0.5b-reduced",
    d_model=56,
    vocab_size=512,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=2,
    n_heads=7,
    n_kv_heads=1,
    head_dim=8,
    qkv_bias=True,
    d_ff=128,
    tie_embeddings=True,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md rule)"}
