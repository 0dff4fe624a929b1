"""seamless-m4t-large-v2 [audio] — enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  [arXiv:2308.11596; hf]

Transformer BACKBONE only: the speech frontend is a stub — the encoder
takes precomputed frame embeddings.  Decoder layers are self-attn +
cross-attn + FFN (plain, non-gated).  Full attention + enc-dec audio
operating regime -> long_500k SKIPPED.

A copy of ``repro/configs/seamless_m4t_large_v2.py``, field for field;
the speech frontend is a stub there and here.
"""

from repro_torch.models.config import EncoderConfig, LayerSpec, ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    d_model=1024,
    vocab_size=256206,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=24,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    ffn_gated=False,
    cross_attn=True,
    cross_source_len=1024,
    encoder=EncoderConfig(n_layers=24, d_model=1024, n_heads=16, d_ff=8192),
    embeds_input=False,
)

REDUCED = ModelConfig(
    name="seamless-reduced",
    d_model=64,
    vocab_size=512,
    block_pattern=(LayerSpec("attn"),),
    block_repeat=2,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    ffn_gated=False,
    cross_attn=True,
    cross_source_len=32,
    encoder=EncoderConfig(n_layers=2, d_model=64, n_heads=4, d_ff=128),
)

SKIP_SHAPES = {
    "long_500k": "enc-dec audio model, full attention; 500k-token target "
                 "decode is outside its operating regime (DESIGN.md rule)",
}
