"""Disaggregated prefill/decode serving subsystem.

Splits one cluster into a prefill pool and a decode pool, each with its own
parallel scheme, couples them through a KV-transfer cost model, and plugs
into the APEX plan search (``ApexSearch.search(..., disaggregated=True)``)
so colocated and disaggregated plans are ranked under one objective.

The port's copy of ``repro/disagg/__init__.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from .kv_transfer import KVTransferModel, TransferEstimate
from .pools import (DisaggPlan, DisaggScheme, cross_pool_span,
                    generate_disagg_schemes, is_mixed_label,
                    map_disagg_scheme, pool_splits)
from .simulate import DisaggSimulator

__all__ = [
    "DisaggPlan", "DisaggScheme", "DisaggSimulator", "KVTransferModel",
    "TransferEstimate", "cross_pool_span", "generate_disagg_schemes",
    "is_mixed_label", "map_disagg_scheme", "pool_splits",
]
