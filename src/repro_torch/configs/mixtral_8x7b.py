"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff(expert)=14336,
8 experts top-2, sliding-window attention (4096), vocab=32000.
[arXiv:2401.04088; hf]

SWA bounds every layer's KV to the window -> long_500k RUNS (ring caches).
This arch is the paper's own EP-vs-TP study vehicle (Fig. 6).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    d_model=4096,
    vocab_size=32000,
    block_pattern=(LayerSpec("attn", window=4096),),
    block_repeat=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    ffn_kind="moe",
    n_routed=8,
    top_k=2,
    d_ff_expert=14336,
    d_ff=14336,
)

REDUCED = ModelConfig(
    name="mixtral-reduced",
    d_model=64,
    vocab_size=512,
    block_pattern=(LayerSpec("attn", window=16),),
    block_repeat=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    ffn_kind="moe",
    n_routed=4,
    top_k=2,
    d_ff_expert=96,
    d_ff=96,
)
