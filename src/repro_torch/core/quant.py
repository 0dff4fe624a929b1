"""Quantization formats (paper §2.5, §4.1).

A format specifies byte widths for the three quantizable components —
weights, activations, KV cache — plus which compute dtype the MXU/tensor
cores run at (W8A8 runs fp8 matmuls; weight-only formats dequantize to the
activation dtype, so compute stays fp16/bf16).

The simulator uses formats to scale (1) weight memory, (2) KV-cache memory,
(3) GEMM compute rate, (4) bytes moved.  Registering a new format is one
dict entry (extensibility, paper Table 5).

The port's copy of ``repro/core/quant.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantFormat:
    name: str
    weight_bytes: float       # bytes per weight scalar
    act_bytes: float          # bytes per activation scalar
    kv_bytes: float           # bytes per KV-cache scalar
    compute_dtype: str        # dtype whose peak-FLOPs entry GEMMs run at

    @property
    def weight_dtype_bits(self) -> int:
        return int(self.weight_bytes * 8)


# The paper's evaluated formats: FP16 default, FP8 KV cache, W8A8 (weights +
# activations in FP8); we add bf16 (TPU-native) and AWQ-style INT4 weights
# (paper §2.5 cites AWQ as a weight-only method).
FORMATS = {
    "fp16": QuantFormat("fp16", 2.0, 2.0, 2.0, "fp16"),
    "bf16": QuantFormat("bf16", 2.0, 2.0, 2.0, "bf16"),
    "kv8": QuantFormat("kv8", 2.0, 2.0, 1.0, "fp16"),          # FP8 KV cache
    "w8a8": QuantFormat("w8a8", 1.0, 1.0, 1.0, "fp8"),          # FP8 W+A (+KV)
    "w4a16": QuantFormat("w4a16", 0.5, 2.0, 2.0, "fp16"),       # AWQ-style
}


def get_format(name: str) -> QuantFormat:
    if name not in FORMATS:
        raise KeyError(f"unknown quant format {name!r}; known: {sorted(FORMATS)}")
    return FORMATS[name]


def register_format(fmt: QuantFormat) -> None:
    """Extensibility hook — new quantization method in one call."""
    FORMATS[fmt.name] = fmt
