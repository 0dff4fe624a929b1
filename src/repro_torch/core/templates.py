"""Parallel Templates (paper §3.2.2, Fig. 5).

A template specifies, per IR cell *type*, how the cell's tasks are
distributed across devices and which collectives synchronize adjacent
cells.  Templates are parameterized over the device count (Fig. 5(c)) and
the cell-level data-parallel degree (Fig. 5(b)), so one template covers all
models expressing that cell type — the reason APEX extends to new LLMs with
zero template work (Table 5).

A ``CellScheme`` is a template *instance*: (cell, dp, shard, method).  With
``dp`` replicas of the cell, each replica parallelized ``shard``-ways via
``method`` ("tp" head/column sharding, "ep" expert distribution), the cell
occupies ``dp * shard`` logical devices.  The scheme knows its per-device
weight/KV memory and how to scale the cell's OpCalls and emit collectives
for a given per-replica workload — everything the Serving Simulator needs.

Resharding between adjacent cells with different partitionings (Fig. 5(b))
is computed by ``reshard_collectives``: All-to-All + AllGather, matching the
paper's example.

The port's copy of ``repro/core/templates.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

from .ir import (AttentionCell, Cell, CrossAttentionCell, MLACell, MLPCell,
                 MoECell, OpCall, SSMCell, Workload)
from .quant import QuantFormat


def expected_activated(visible: int, total: int, assignments: float) -> float:
    """Expected number of distinct activated experts among ``visible``
    experts hosted locally, with ``assignments`` token-to-expert assignments
    spread uniformly over ``total`` experts.  Drives the weight-read traffic
    of MoE cells: only activated experts' matrices are touched."""
    if assignments <= 0 or visible <= 0:
        return 0.0
    p_hit = 1.0 - (1.0 - 1.0 / total) ** assignments
    return visible * p_hit


def moe_expert_gemms(c, assignments: float, visible: int, g: int,
                     q: QuantFormat, all_activated: bool = False) -> list:
    """Per-device expert GEMMs: ``assignments`` token-assignments spread over
    the expected activated subset of ``visible`` local experts, each expert's
    matrices sliced ``g``-ways (g=1 for EP, TP degree for TP)."""
    if assignments <= 0:
        return []
    if all_activated:
        e_act = float(visible)
    else:
        e_act = max(1.0, expected_activated(visible, c.n_routed, assignments))
    m = assignments / e_act
    up_n = (2 if c.gated else 1) * c.d_ff_expert // g
    down_k = c.d_ff_expert // g
    up = Cell._gemm(m, up_n, c.d_model, q)
    down = Cell._gemm(m, c.d_model, down_k, q)
    # e_act experts each run (m x up_n x d) + (m x d x down_k): the
    # simulator charges the per-GEMM profiled time ``count`` times.
    return [dataclasses.replace(up, flops=up.flops * e_act,
                                bytes=up.bytes * e_act, count=e_act),
            dataclasses.replace(down, flops=down.flops * e_act,
                                bytes=down.bytes * e_act, count=e_act)]


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One collective emitted by a scheme for one iteration."""

    kind: str          # all_reduce | all_gather | reduce_scatter | all_to_all | p2p
    nbytes: float      # logical payload bytes
    group_size: int    # communicating devices

    def scaled(self, f: float) -> "CollectiveCall":
        return dataclasses.replace(self, nbytes=self.nbytes * f)


@dataclasses.dataclass(frozen=True)
class CellScheme:
    """A parallel-template instance for one cell."""

    cell: Cell
    dp: int
    shard: int
    method: str               # "tp" | "ep" | "none"
    ep_imbalance: float = 1.15  # hot-expert skew multiplier (paper §2.4 notes
                                # EP workload imbalance; calibrate per trace)

    @property
    def devices(self) -> int:
        return self.dp * self.shard

    # -- memory ---------------------------------------------------------------

    def weight_bytes_per_device(self, q: QuantFormat) -> float:
        c = self.cell
        g = self.shard
        if isinstance(c, (AttentionCell, CrossAttentionCell)):
            kv_shard = min(g, c.n_kv_heads)
            per = (2 * c.d_model * c.q_dim) / g \
                + (2 * c.d_model * c.kv_dim) / kv_shard
            if getattr(c, "qkv_bias", False):
                per += c.q_dim / g + 2 * c.kv_dim / kv_shard
            return per * q.weight_bytes
        if isinstance(c, MLACell):
            sharded = (c.d_model * c.n_heads * c.qk_head_dim
                       + c.kv_lora_rank * c.n_heads * (c.qk_nope_head_dim
                                                       + c.v_head_dim)
                       + c.n_heads * c.v_head_dim * c.d_model) / g
            repl = c.d_model * (c.kv_lora_rank + c.qk_rope_head_dim)
            return (sharded + repl) * q.weight_bytes
        if isinstance(c, MoECell):
            if self.method == "ep":
                local_experts = c.n_routed / g
                per = (local_experts + c.n_shared) * c.expert_params() \
                    + c.d_model * c.n_routed        # router replicated
            else:  # tp: every expert sharded g ways
                per = (c.n_routed + c.n_shared) * c.expert_params() / g \
                    + c.d_model * c.n_routed
            return per * q.weight_bytes
        # MLP / SSM: fully column/row sharded
        return self.cell.weight_params() / g * q.weight_bytes

    def kv_bytes_per_token_per_device(self, q: QuantFormat) -> float:
        """KV-cache bytes per BATCH token landing on one device.

        cell-DP splits the batch across replicas (factor dp); TP shards KV
        heads (factor min(shard, kv_heads)); the MLA latent is replicated
        across the TP group (factor 1)."""
        c = self.cell
        if isinstance(c, (AttentionCell,)):
            kv_shard = min(self.shard, c.n_kv_heads)
            return c.kv_bytes_per_token(q) / (self.dp * kv_shard)
        if isinstance(c, MLACell):
            return c.kv_bytes_per_token(q) / self.dp
        return 0.0

    def state_bytes_per_seq_per_device(self, q: QuantFormat) -> float:
        c = self.cell
        s = c.state_bytes_per_seq(q)
        if s == 0.0:
            return 0.0
        if isinstance(c, SSMCell):
            return s / (self.dp * self.shard)
        if isinstance(c, CrossAttentionCell):
            kv_shard = min(self.shard, c.n_kv_heads)
            return s / (self.dp * kv_shard)
        return s / self.dp

    # -- compute + communication ------------------------------------------------

    def compute_ops(self, w: Workload, q: QuantFormat) -> List[OpCall]:
        """Per-DEVICE OpCalls for this iteration's workload.

        ``w`` is the full (replica-group) workload; cell-DP divides tokens
        across replicas, the shard dimension divides each op's dims.  Ops
        are constructed with the *actual post-sharding shapes* so the
        profile lookup reflects the per-device operation (a TP-sharded GEMM
        is a thinner GEMM, not a scaled copy of the full one) — this is
        exactly what the paper's operation-level profiling provides."""
        per_replica = w.divided(self.dp)
        if per_replica.total_tokens == 0 and per_replica.encoder_tokens == 0:
            return []
        g = self.shard
        if g == 1:
            return self.cell.compute(per_replica, q)
        c = self.cell
        if isinstance(c, AttentionCell):
            return self._attn_ops(c, per_replica, q, g)
        if isinstance(c, MLACell):
            return self._mla_ops(c, per_replica, q, g)
        if isinstance(c, CrossAttentionCell):
            return self._cross_ops(c, per_replica, q, g)
        if isinstance(c, MLPCell):
            return self._mlp_ops(c, per_replica, q, g)
        if isinstance(c, MoECell):
            return self._moe_ops(c, per_replica, q, g)
        if isinstance(c, SSMCell):
            return self._ssm_ops(c, per_replica, q, g)
        return [op.scaled(1.0 / g) for op in c.compute(per_replica, q)]

    # -- per-cell-type sharded op construction (the template bodies) -----------

    @staticmethod
    def _attn_ops(c: AttentionCell, w: Workload, q: QuantFormat,
                  g: int) -> List[OpCall]:
        t = w.total_tokens
        kvg = min(g, c.n_kv_heads)
        ops = [Cell._gemm(t, c.q_dim // g + 2 * c.kv_dim // kvg, c.d_model, q),
               Cell._gemm(t, c.d_model, c.q_dim // g, q)]
        qk = w.prefill_qk(c.window)
        heads = c.n_heads // g
        if qk > 0:
            flops = 4.0 * qk * heads * c.head_dim
            mem = 2 * w.prefill_tokens * (c.q_dim // g) * q.act_bytes \
                + 2 * w.prefill_tokens * (c.kv_dim // kvg) * q.kv_bytes
            ops.append(OpCall("attn_prefill",
                              axes=(heads, c.head_dim, q.compute_dtype),
                              x=float(qk), flops=flops, bytes=mem))
        if w.decode_tokens > 0:
            kv_tok = w.decode_kv(c.window)
            kv_heads = max(1, c.n_kv_heads // kvg)
            flops = 4.0 * kv_tok * heads * c.head_dim
            mem = kv_tok * 2 * kv_heads * c.head_dim * q.kv_bytes
            ops.append(OpCall("attn_decode",
                              axes=(kv_heads, c.head_dim, q.compute_dtype),
                              x=float(kv_tok), flops=flops, bytes=mem))
        return ops

    @staticmethod
    def _mla_ops(c: MLACell, w: Workload, q: QuantFormat,
                 g: int) -> List[OpCall]:
        t = w.total_tokens
        h = c.n_heads // g
        ops = [
            Cell._gemm(t, h * c.qk_head_dim, c.d_model, q),           # W_q
            Cell._gemm(t, c.kv_lora_rank + c.qk_rope_head_dim,
                       c.d_model, q),                                 # W_dkv
            Cell._gemm(t, h * (c.qk_nope_head_dim + c.v_head_dim),
                       c.kv_lora_rank, q),                            # W_ukv
            Cell._gemm(t, c.d_model, h * c.v_head_dim, q),            # W_o
        ]
        qk = w.prefill_qk(None)
        if qk > 0:
            flops = 2.0 * qk * h * (c.qk_head_dim + c.v_head_dim)
            mem = 2 * w.prefill_tokens * h * c.qk_head_dim * q.act_bytes
            ops.append(OpCall("attn_prefill",
                              axes=(h, c.qk_head_dim, q.compute_dtype),
                              x=float(qk), flops=flops, bytes=mem))
        if w.decode_tokens > 0:
            kv_tok = w.decode_kv(None)
            # latent cache is replicated: every device reads the full latent
            flops = 2.0 * kv_tok * h * (c.kv_lora_rank + c.qk_rope_head_dim
                                        + c.v_head_dim)
            mem = kv_tok * c.kv_bytes_per_token(q)
            ops.append(OpCall("attn_decode",
                              axes=(h, c.kv_lora_rank, q.compute_dtype),
                              x=float(kv_tok), flops=flops, bytes=mem))
        return ops

    @staticmethod
    def _cross_ops(c: CrossAttentionCell, w: Workload, q: QuantFormat,
                   g: int) -> List[OpCall]:
        t = w.total_tokens
        kvg = min(g, c.n_kv_heads)
        h = c.n_heads // g
        ops = [Cell._gemm(t, c.q_dim // g, c.d_model, q),
               Cell._gemm(t, c.d_model, c.q_dim // g, q)]
        if w.encoder_tokens > 0:
            ops.append(Cell._gemm(w.encoder_tokens, 2 * c.kv_dim // kvg,
                                  c.d_model, q))
        if w.cross_prefill_qk > 0:
            flops = 4.0 * w.cross_prefill_qk * h * c.head_dim
            mem = 2 * w.prefill_tokens * (c.q_dim // g) * q.act_bytes
            ops.append(OpCall("attn_prefill",
                              axes=(h, c.head_dim, q.compute_dtype),
                              x=float(w.cross_prefill_qk), flops=flops,
                              bytes=mem))
        if w.cross_decode_kv > 0:
            kv_heads = max(1, c.n_kv_heads // kvg)
            flops = 4.0 * w.cross_decode_kv * h * c.head_dim
            mem = w.cross_decode_kv * 2 * kv_heads * c.head_dim * q.kv_bytes
            ops.append(OpCall("attn_decode",
                              axes=(kv_heads, c.head_dim, q.compute_dtype),
                              x=float(w.cross_decode_kv), flops=flops,
                              bytes=mem))
        return ops

    @staticmethod
    def _mlp_ops(c: MLPCell, w: Workload, q: QuantFormat,
                 g: int) -> List[OpCall]:
        t = w.total_tokens
        up_n = (2 if c.gated else 1) * c.d_ff // g
        return [Cell._gemm(t, up_n, c.d_model, q),
                Cell._gemm(t, c.d_model, c.d_ff // g, q)]

    def _moe_ops(self, c: MoECell, w: Workload, q: QuantFormat,
                 g: int) -> List[OpCall]:
        t = w.total_tokens
        ops = [Cell._gemm(t, c.n_routed, c.d_model, q)]   # router (replicated)
        if self.method == "ep":
            # This device hosts n_routed/g experts, each with FULL matrices;
            # it receives ~ t*top_k/g token-assignments (hot-expert skew
            # inflates the straggler's share — paper §2.4).
            visible = c.n_routed // g
            assigns = t * c.top_k / g * self.ep_imbalance
            ops += moe_expert_gemms(c, assigns, visible, 1, q)
            if c.n_shared:
                ops += moe_expert_gemms(c, float(t * c.n_shared), c.n_shared,
                                        1, q, all_activated=True)
        else:
            # TP: this device holds a 1/g slice of EVERY expert; activated
            # experts each incur a sliced-weight read.
            assigns = t * c.top_k
            ops += moe_expert_gemms(c, assigns, c.n_routed, g, q)
            if c.n_shared:
                ops += moe_expert_gemms(c, float(t * c.n_shared), c.n_shared,
                                        g, q, all_activated=True)
        return ops

    @staticmethod
    def _ssm_ops(c: SSMCell, w: Workload, q: QuantFormat,
                 g: int) -> List[OpCall]:
        t = w.total_tokens
        in_n = (2 * c.d_inner + 2 * c.n_groups * c.d_state + c.n_ssd_heads)
        d_in = c.d_inner // g
        ops = [Cell._gemm(t, in_n // g, c.d_model, q),
               Cell._gemm(t, c.d_model, d_in, q)]
        flops = 6.0 * t * d_in * c.d_state
        mem = t * d_in * q.act_bytes * 2
        if w.decode_tokens > 0:
            mem += w.batch_sequences * c.state_bytes_per_seq(q) / g
        ops.append(OpCall("ssd_scan",
                          axes=(d_in, c.d_state, q.compute_dtype),
                          x=float(t), flops=flops, bytes=mem))
        return ops

    def collectives(self, w: Workload, q: QuantFormat) -> List[CollectiveCall]:
        """Intra-cell collectives for one iteration (per replica)."""
        per_replica = w.divided(self.dp)
        t = per_replica.total_tokens
        if t == 0 or self.shard == 1:
            return []
        c = self.cell
        act = t * c.activation_bytes_per_token(q)
        if isinstance(c, MoECell) and self.method == "ep":
            # Dispatch + combine all-to-all.  Each device starts with t/g of
            # the tokens and sends each token's activation to its top-k
            # experts' devices: per-device payload = (t/g) * d * top_k bytes
            # — the lower-traffic pattern that makes APEX predict EP over TP
            # (paper Fig. 6 discussion).
            payload = act * c.top_k / self.shard
            return [CollectiveCall("all_to_all", payload, self.shard),
                    CollectiveCall("all_to_all", payload, self.shard)]
        # Megatron-style TP: one all-reduce on the full cell output.
        return [CollectiveCall("all_reduce", act, self.shard)]

    # -- validity -----------------------------------------------------------------

    def valid(self) -> bool:
        c, g = self.cell, self.shard
        if isinstance(c, (AttentionCell, CrossAttentionCell, MLACell)):
            return g <= c.num_tasks and c.num_tasks % g == 0
        if isinstance(c, MoECell):
            if self.method == "ep":
                return g <= c.n_routed and c.n_routed % g == 0
            return c.d_ff_expert % g == 0 and g <= c.d_ff_expert
        if isinstance(c, MLPCell):
            return c.d_ff % g == 0 and g <= c.d_ff
        if isinstance(c, SSMCell):
            return g <= c.n_ssd_heads and c.n_ssd_heads % g == 0
        return g == 1


# ---------------------------------------------------------------------------
# Template registry: cell kind -> scheme options for (cell, s devices)
# ---------------------------------------------------------------------------

def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def schemes_for_cell(cell: Cell, s: int, cell_dp: int) -> List[CellScheme]:
    """All template instances putting ``cell`` on ``s`` devices with
    ``cell_dp`` replicas (Algorithm 1 inner loop body)."""
    if s % cell_dp != 0:
        return []
    shard = s // cell_dp
    out: List[CellScheme] = []
    methods = ["tp"]
    if isinstance(cell, MoECell):
        methods = ["tp", "ep"] if shard > 1 else ["tp"]
    for m in methods:
        scheme = CellScheme(cell=cell, dp=cell_dp, shard=shard,
                            method=m if shard > 1 else "none")
        if scheme.valid():
            out.append(scheme)
    return out


def reshard_collectives(a: CellScheme, b: CellScheme, w: Workload,
                        q: QuantFormat, stage_devices: int
                        ) -> List[CollectiveCall]:
    """Collectives to move activations from cell A's layout to cell B's
    (paper Fig. 5(b): differing cell-DP degrees need All-to-All +
    AllGather; identical layouts need nothing beyond A's own sync)."""
    if a.dp == b.dp:
        return []
    t = w.total_tokens
    act_per_tok = a.cell.activation_bytes_per_token(q)
    payload = t * act_per_tok
    calls = [CollectiveCall("all_to_all", payload, stage_devices)]
    if b.dp < a.dp:
        # fewer replicas downstream -> each gathers a larger token slice
        calls.append(CollectiveCall("all_gather", payload / b.dp,
                                    stage_devices))
    else:
        calls.append(CollectiveCall("all_gather", payload / a.dp,
                                    stage_devices))
    return calls
