"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H, MLA (kv_lora=512),
MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408, vocab=102400.
First layer uses a dense FFN (d_ff=10944), per the released config.
[arXiv:2405.04434; hf]

MLA's latent KV cache is NOT head-sharded: the TP template shards query
heads / up-projections and replicates the 512-rank latent (DESIGN.md
§Arch-applicability).  MLA is still full attention over the sequence ->
long_500k SKIPPED.

A copy of ``repro/configs/deepseek_v2_lite_16b.py``, field for field.  As
there, the model departs from the published DeepSeek-V2-Lite in three
places: the top-6 gates are renormalised (the published config has
``norm_topk_prob: false``), RoPE has no YaRN scaling, and the latent has
no ``kv_a_layernorm``.  Neither package has them.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    d_model=2048,
    vocab_size=102400,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=27,
    n_heads=16,
    attn_kind="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    ffn_kind="moe",
    n_routed=64,
    top_k=6,
    n_shared=2,
    d_ff_expert=1408,
    first_k_dense=1,
    d_ff_dense_first=10944,
    d_ff=1408,
)

REDUCED = ModelConfig(
    name="deepseek-v2-lite-reduced",
    d_model=64,
    vocab_size=512,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=3,
    n_heads=4,
    attn_kind="mla",
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    ffn_kind="moe",
    n_routed=8,
    top_k=2,
    n_shared=1,
    d_ff_expert=48,
    first_k_dense=1,
    d_ff_dense_first=96,
    d_ff=48,
)

SKIP_SHAPES = {"long_500k":
               "MLA latent cache is compressed but attention is still full "
               "(DESIGN.md rule)"}
