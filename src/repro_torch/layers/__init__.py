"""Layers of the port, in PyTorch: the dense decoder path, MLA, the MoE
FFN and the Mamba2 mixer of ``repro.layers``.

Parameters are ``nn.ParameterDict``s (or bare ``nn.Parameter``s for norm
weights) keyed as in the JAX pytrees, with weights in the JAX layout
``x @ W``, ``W (d_in, d_out)``.  ``rms_norm``, the attention of
``gqa_attention``/``mla_attention`` and that of
``gqa_decode_step``/``mla_decode_step``, and the SSD scan of
``mamba2_forward`` go through the hand-written kernels in
``repro_torch.kernels`` on CUDA tensors.
"""

from .attention import (blockwise_attention, gqa_attention,
                        gqa_decode_step, init_attention, init_mla,
                        mla_attention, mla_decode_step)
from .mlp import init_mlp, mlp_forward
from .moe import MoEParams, init_moe, moe_forward
from .norms import layer_norm, rms_norm
from .rope import apply_mrope, apply_rope, rope_angles
from .ssm import init_mamba2, mamba2_decode_step, mamba2_forward

__all__ = ["MoEParams", "apply_mrope", "apply_rope", "blockwise_attention",
           "gqa_attention", "gqa_decode_step", "init_attention",
           "init_mamba2", "init_mla", "init_mlp", "init_moe",
           "layer_norm", "mamba2_decode_step", "mamba2_forward", "mla_attention",
           "mla_decode_step", "mlp_forward", "moe_forward", "rms_norm",
           "rope_angles"]
