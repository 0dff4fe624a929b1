"""zamba2-7b [hybrid] — 81L d_model=3584, Mamba2 backbone (ssm_state=64)
with a SHARED GQA attention block (32H kv=32, d_ff=14336) applied once per
repeat.  [arXiv:2411.15242; unverified tier]

We model the 81 layers as 6 Mamba2 layers x 13 repeats (78) + 13
applications of ONE shared attention+MLP block (weights tied across
repeats — the Zamba2 signature).  Cell-level DP is disabled for the shared
block: replicating it would break the weight tying (DESIGN.md
§Arch-applicability).  Hybrid -> long_500k RUNS.

A copy of ``repro/configs/zamba2_7b.py``, field for field.  The reference
departs from the published Zamba2-7B (its public ``config.json``), and
the port follows the reference:

==========================  ==============================  ==================
field                       published config                reference
==========================  ==============================  ==================
Mamba heads                 ``n_mamba_heads`` 112 of        64 heads of 112
                            ``mamba_headdim`` 64
SSM groups                  ``mamba_ngroups`` 2             1
shared blocks               ``num_mem_blocks`` 2,           one
                            alternating
shared block input          concatenated to                 the hidden state
                            ``attention_hidden_size``       alone, head dim 112
                            7168, head dim 224
adapters                    shared-MLP adapters             none
                            (``adapter_rank`` 128)
layer layout                68 mamba + 13 hybrid layers     78 SSM layers + 13
                            at ``hybrid_layer_ids`` 6,      applications, each
                            11, 17, ...                     after a sixth
``chunk_size``              256                             the scan's 128
``rms_norm_eps``            1e-5                            1e-6
==========================  ==============================  ==================

So the SSD head dim P = 7168 / 64 = 112 is the reference's own choice;
``kernels.ssd_scan`` runs it as two panels of 64 (the last zero-padded).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="zamba2-7b",
    d_model=3584,
    vocab_size=32000,
    block_pattern=(LayerSpec("ssm"),) * 6,
    block_repeat=13,
    d_inner=7168,
    d_state=64,
    n_ssd_heads=64,            # head_dim 112
    d_conv=4,
    ffn_kind="none",
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    shared_attn=True,
    shared_d_ff=14336,
    d_ff=14336,
)

REDUCED = ModelConfig(
    name="zamba2-reduced",
    d_model=64,
    vocab_size=512,
    block_pattern=(LayerSpec("ssm"),) * 2,
    block_repeat=2,
    d_inner=128,
    d_state=16,
    n_ssd_heads=4,
    d_conv=4,
    ffn_kind="none",
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    shared_attn=True,
    shared_d_ff=128,
    d_ff=128,
)
