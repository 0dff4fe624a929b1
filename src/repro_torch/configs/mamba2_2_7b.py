"""mamba2-2.7b [ssm] — 64L d_model=2560 attention-free, d_inner=5120,
ssm_state=128, 80 SSD heads (head_dim 64), vocab=50280.
[arXiv:2405.21060; unverified tier]

Attention-free: the APEX attention templates are inert; TP shards the SSD
inner dimension/heads, the KV memory model is replaced by the O(1) SSM
state model.  long_500k RUNS (the flagship case for SSM serving).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b",
    d_model=2560,
    vocab_size=50280,
    block_pattern=(LayerSpec("ssm"),),
    block_repeat=64,
    d_inner=5120,
    d_state=128,
    n_ssd_heads=80,
    d_conv=4,
    ffn_kind="none",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-reduced",
    d_model=64,
    vocab_size=512,
    block_pattern=(LayerSpec("ssm"),),
    block_repeat=3,
    d_inner=128,
    d_state=16,
    n_ssd_heads=4,
    d_conv=4,
    ffn_kind="none",
    tie_embeddings=True,
)
