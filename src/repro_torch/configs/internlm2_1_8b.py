"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.  [arXiv:2403.17297; hf]

Pure full attention -> long_500k is SKIPPED (quadratic-regime artifact;
see DESIGN.md §long_500k).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b",
    d_model=2048,
    vocab_size=92544,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=24,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
)

REDUCED = ModelConfig(
    name="internlm2-reduced",
    d_model=64,
    vocab_size=512,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md rule)"}
