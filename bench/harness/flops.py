"""The yardstick's arithmetic: the chip's peaks and the operations and
bytes that the work needs, computed from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity):
989 TFLOP/s in bf16, 67 TFLOP/s in fp32 outside the tensor cores,
3.35 TB/s of HBM.  A card named otherwise has no peaks here, and a
reader of a share of a peak then reads nothing.

FLOPs count 2 per multiply-add of the products the model needs, not the
ones the program happens to run: a MoE token counts its top-k experts
(the program's dense dispatch runs all of them), and causal attention
counts the (query, key) pairs at or below the diagonal.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

PEAKS = {
    "H100": {"bf16_flops": 989e12, "fp32_flops": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Optional[dict]:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def flops_peak(peaks: dict, dtype: str) -> float:
    """The peak FLOP/s of products in ``dtype`` (the configuration's)."""
    return peaks["fp32_flops" if dtype == "float32" else "bf16_flops"]


def _dims(conf: dict) -> Tuple[int, int, int, int, int, int]:
    H = conf["num_attention_heads"]
    return (conf["hidden_size"], H, conf["num_key_value_heads"],
            conf.get("head_dim") or conf["hidden_size"] // H,
            conf["intermediate_size"], conf["num_hidden_layers"])


def layer_matmul_params(conf: dict, active: bool = True) -> int:
    """Weights one token multiplies by in a layer: the attention
    projections, and the MLP, or the router and the top-k experts
    (every expert with ``active`` false)."""
    d, H, Hkv, D, f, _ = _dims(conf)
    attn = d * H * D * 2 + d * Hkv * D * 2
    E = conf.get("num_local_experts", 0)
    if not E:
        return attn + 3 * d * f
    k = conf["num_experts_per_tok"] if active else E
    return attn + d * E + k * 3 * d * f


def matmul_params(conf: dict, active: bool = True) -> int:
    """Weights one token multiplies by through the whole model, the LM
    head included (the embedding is a lookup)."""
    return (conf["num_hidden_layers"] * layer_matmul_params(conf, active)
            + conf["hidden_size"] * conf["vocab_size"])


def attention_pair_flops(conf: dict) -> int:
    """FLOPs of one (query, key) pair through every layer: q.k and p v."""
    _, H, _, D, _, L = _dims(conf)
    return 4 * H * D * L


def token_flops(conf: dict, context: int) -> float:
    """Forward FLOPs of one token that attends to ``context`` positions
    (itself included)."""
    w = conf.get("sliding_window")
    ctx = min(context, w) if w else context
    return 2.0 * matmul_params(conf) + attention_pair_flops(conf) * ctx


def sequence_flops(conf: dict, positions: int) -> float:
    """Forward FLOPs of the first ``positions`` tokens of a sequence, each
    run once through the model."""
    return sum(token_flops(conf, p + 1) for p in range(positions))


def serve_flops(conf: dict, lengths: Iterable[Tuple[int, int]]) -> float:
    """Forward FLOPs of serving requests of (prompt, output) lengths:
    every prompt token and every output token but the last goes through
    the model once."""
    return sum(sequence_flops(conf, p + g - 1) for p, g in lengths)


def decode_attention_bytes(batch: int, q_heads: int, kv_heads: int,
                           dim: int, lengths: Iterable[int],
                           itemsize: int) -> float:
    """Bytes one decode-attention call must move: the K and V rows of
    every sequence at its length, read once, q read and the output
    written."""
    kv = 2 * sum(lengths) * kv_heads * dim * itemsize
    return kv + 2 * batch * q_heads * dim * itemsize
