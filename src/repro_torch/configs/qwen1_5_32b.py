"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40 => MHA)
d_ff=27392 vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-32B; hf tier]

Pure full attention -> long_500k SKIPPED.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="qwen1.5-32b",
    d_model=5120,
    vocab_size=152064,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=64,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    qkv_bias=True,
    d_ff=27392,
)

REDUCED = ModelConfig(
    name="qwen1.5-32b-reduced",
    d_model=80,
    vocab_size=512,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=2,
    n_heads=5,
    n_kv_heads=5,
    head_dim=16,
    qkv_bias=True,
    d_ff=256,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md rule)"}
