"""KV-cache handoff cost model for disaggregated serving.

When a prompt finishes prefill, its KV cache must move from the prefill
pool to the decode pool.  Payload size comes straight from the model IR:

    bytes = layers x 2(K,V) x kv_heads x head_dim x kv_bytes(quant) x ctx

(``ModelIR.kv_bytes_per_token`` already folds the per-cell structure —
GQA kv_heads, MLA latent width, sliding-window cells — so MLA ships its
compressed latent, exactly what real disagg stacks do.  Recurrent state
of SSM/hybrid cells rides along via ``state_bytes_per_seq``.)

Timing is routed through the existing ``CollectiveModel`` as p2p traffic
at the network level spanning the two pools (``pools.cross_pool_span`` —
the same level-selection rule the Device Mapper uses), so there are no
hard-coded bandwidths anywhere in this model.  Two modes:

  * ``blocking``  — decode admission waits for the full cache: the whole
    serialization time is exposed.
  * ``layerwise`` — layer i's KV streams while layer i+1 prefills (the
    overlap every production disagg system implements); only the *last*
    layer's chunk is still on the wire when prefill completes, so the
    exposed delay is one layer's transfer.  Wire time and energy are still
    charged in full.

Transfers fan out over the parallel links between the pools: one request's
cache is sharded across the source TP group and lands sharded on the
destination TP group, so ``lanes = min(prefill tp, decode tp)`` moves
concurrently.

The port's copy of ``repro/disagg/kv_transfer.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..core.cluster import NetworkLevel
from ..core.ir import ModelIR
from ..core.profiles import CollectiveModel
from ..core.quant import get_format


@dataclasses.dataclass(frozen=True)
class TransferEstimate:
    """One request's KV handoff cost."""

    nbytes: float             # total payload (all layers, all heads)
    delay_s: float            # admission delay visible to the decode pool
    wire_s: float             # full serialization time (one lane's share)
    energy_j: float

    @property
    def effective_gbps(self) -> float:
        return (self.nbytes / self.wire_s / 1e9) if self.wire_s > 0 else 0.0

    @property
    def stream_lead_s(self) -> float:
        """How long before prefill completion the stream already occupied
        the wire (layerwise mode overlaps all but the exposed tail with
        the prefill itself; blocking mode has no lead)."""
        return max(0.0, self.wire_s - self.delay_s)


class KVTransferModel:
    """Per-request KV handoff: bytes from the IR, time from the cluster.

    Two costing modes for the wire itself:

      * shared-cluster (``link=None``) — both pools live in ONE physical
        cluster; the link is looked up in ``coll``'s cluster at the
        transfer ``span`` (pools.cross_pool_span), exactly the shared-cluster path.
      * explicit link — heterogeneous pools are separate clusters joined by
        a ``NetworkLevel`` (core.cluster.cross_pool_link: min of the two
        pools' injection bandwidths); time follows the same p2p formula
        (bytes/bw + launch + latency) and energy charges one endpoint
        device per side through ``endpoint_powers`` (the prefill and
        decode pools' own PowerModels).
    """

    def __init__(self, coll: CollectiveModel, mode: str = "layerwise",
                 link: Optional[NetworkLevel] = None,
                 endpoint_powers: Optional[Sequence] = None):
        if mode not in ("layerwise", "blocking"):
            raise ValueError(f"unknown transfer mode {mode!r}")
        self.coll = coll
        self.mode = mode
        self.link = link
        self.endpoint_powers = tuple(endpoint_powers) if endpoint_powers \
            else (coll.power, coll.power)

    def _link_query(self, nbytes: float) -> tuple:
        """(time_s, energy_j) to move ``nbytes`` over the explicit link."""
        lvl = self.link
        t = nbytes / lvl.bw_per_device + lvl.launch_s + lvl.latency_s
        e = sum(p.energy(t, utilization=0.15) for p in self.endpoint_powers)
        return t, e

    def kv_bytes(self, model: ModelIR, ctx_len: int, quant: str) -> float:
        """Payload bytes for one request's cache at ``ctx_len`` tokens."""
        q = get_format(quant)
        per_tok = model.kv_bytes_per_token(q)
        state = model.state_bytes_per_seq(q)   # SSM/hybrid recurrent state
        return per_tok * ctx_len + state

    def estimate(self, model: ModelIR, ctx_len: int, quant: str,
                 span: int, lanes: int = 1) -> TransferEstimate:
        """Cost one request's handoff over the cross-pool link.

        ``span`` is the device span of the link (pools.cross_pool_span);
        ``lanes`` is how many links move shards concurrently.
        """
        nbytes = self.kv_bytes(model, ctx_len, quant)
        if nbytes <= 0:       # attention-free model: nothing to ship
            return TransferEstimate(0.0, 0.0, 0.0, 0.0)
        lanes = max(1, lanes)
        query = self._link_query if self.link is not None else \
            (lambda b: self.coll.query("p2p", b, span))
        wire, energy = query(nbytes / lanes)
        if self.mode == "blocking":
            delay = wire
        else:
            layers = max(1, model.block.repeat)
            delay, _ = query(nbytes / (lanes * layers))
        return TransferEstimate(nbytes=nbytes, delay_s=delay, wire_s=wire,
                                energy_j=energy)
