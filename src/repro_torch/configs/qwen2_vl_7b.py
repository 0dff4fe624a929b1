"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Transformer BACKBONE only: the vision frontend is a stub — the model
takes precomputed patch embeddings (B, S, d_model) plus (t, h, w) M-RoPE
position ids.  Pure full attention -> long_500k SKIPPED.

A copy of ``repro/configs/qwen2_vl_7b.py``, field for field.  As there,
``rope_theta`` stays at the schema's 10000 (the Hugging Face model's is
1e6) and the vision frontend is a stub; the port follows the reference
in both.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-7b",
    d_model=3584,
    vocab_size=152064,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=28,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    qkv_bias=True,
    d_ff=18944,
    rope="mrope",
    embeds_input=True,
)

REDUCED = ModelConfig(
    name="qwen2-vl-reduced",
    d_model=56,
    vocab_size=512,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=2,
    n_heads=7,
    n_kv_heads=1,
    head_dim=8,
    qkv_bias=True,
    d_ff=128,
    rope="mrope",
    embeds_input=True,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md rule)"}
