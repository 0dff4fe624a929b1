"""Transformer IR — APEX's canonical model representation (paper §3.2.1).

An LLM is represented as identical *blocks*; a block is a chain of *cells*
(attention, MLP, MoE, SSM, ...); a cell contains parallel *tasks* (heads,
experts).  The IR deliberately abstracts away tokenization / position
embeddings ("less relevant for model parallelization") and exposes exactly
what the Parallel Templates and the Serving Simulator need:

  * per-cell weight bytes (quantization-aware),
  * per-cell KV-cache / recurrent-state bytes,
  * per-cell compute decomposed into profile-able operations (GEMM,
    attention prefill/decode, SSD scan), mirroring the paper's
    operation-level profiling (§3.5),
  * the number of shardable tasks per cell.

Blocks let the simulator evaluate ONE block and extrapolate to the full
model (paper Fig. 8's trillion-scale scalability).

The port's copy of ``repro/core/ir.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from .quant import QuantFormat


# ---------------------------------------------------------------------------
# Operation calls — the unit the profiling store is queried with
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpCall:
    """One profile-able operation instance.

    ``op``    : profile family ("gemm", "attn_prefill", "attn_decode",
                "ssd_scan", ...)
    ``axes``  : the profile grid's fixed configuration axes (e.g. n,k of a
                GEMM; heads/head_dim of attention) — the paper profiles
                "across various context lengths, attention heads, hidden
                dimensions".
    ``x``     : the interpolation variable (e.g. GEMM m-dim = token count).
    ``flops`` / ``bytes``: ground-truth work estimates for the WHOLE call
                (all ``count`` repetitions); used by analytic profile
                backends and by MFU/MBU metric computation.
    ``count`` : how many times this exact operation runs back-to-back
                (e.g. one GEMM per activated MoE expert); the simulator
                multiplies the per-op profiled time by ``count``.
    """

    op: str
    axes: tuple
    x: float
    flops: float
    bytes: float
    count: float = 1.0

    def scaled(self, factor: float) -> "OpCall":
        return dataclasses.replace(
            self, flops=self.flops * factor, bytes=self.bytes * factor
        )


def _window_area(q_len: int, kv_end: int, window: Optional[int]) -> float:
    """Sum over the chunk's query positions of their attended KV length.

    Queries are positions kv_end-q_len .. kv_end-1 (0-based); query at
    position p attends min(p+1, window) keys.  Closed form of
    sum_{p=a..b} min(p, W) with a=kv_end-q_len+1, b=kv_end.
    """
    a, b = kv_end - q_len + 1, kv_end
    if a > b:
        return 0.0
    if window is None or b <= window:
        return (a + b) * (b - a + 1) / 2.0
    w = window
    if a > w:
        return float(w) * (b - a + 1)
    # split: a..w triangular, w+1..b flat
    tri = (a + w) * (w - a + 1) / 2.0
    flat = float(w) * (b - w)
    return tri + flat


@dataclasses.dataclass(frozen=True)
class Workload:
    """What one serving iteration asks of one cell chain (per replica).

    The Batching Module aggregates the active batch into window-resolved
    attention work so each cell reads its own sliding-window variant
    exactly.  ``windows`` maps window size -> (prefill_qk, decode_kv):
      * prefill_qk : sum over prefill chunks of the window-clamped
                     attention area (see ``_window_area``).
      * decode_kv  : sum over decode requests of min(kv_len, window).
    The key ``None`` holds the unwindowed (full-attention) aggregates.

    Encoder-decoder extras: ``encoder_tokens`` = source tokens entering the
    encoder this iteration; ``cross_prefill_qk`` / ``cross_decode_kv`` =
    query-x-source attention work against the (fixed-length) encoder memory.
    """

    prefill_tokens: int = 0
    decode_tokens: int = 0
    batch_sequences: int = 0
    windows: dict = dataclasses.field(default_factory=dict)
    encoder_tokens: int = 0
    cross_prefill_qk: float = 0.0
    cross_decode_kv: float = 0.0

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    def prefill_qk(self, window: Optional[int]) -> float:
        entry = self.windows.get(window)
        if entry is None:
            entry = self.windows.get(None, (0.0, 0.0))
        return entry[0]

    def decode_kv(self, window: Optional[int]) -> float:
        entry = self.windows.get(window)
        if entry is None:
            entry = self.windows.get(None, (0.0, 0.0))
        return entry[1]

    def is_empty(self) -> bool:
        return self.total_tokens == 0 and self.encoder_tokens == 0

    def signature(self) -> tuple:
        """Hashable identity for step-cost memoization: two workloads with
        equal signatures cost identically under any deterministic model."""
        return (self.prefill_tokens, self.decode_tokens,
                self.batch_sequences, self.encoder_tokens,
                self.cross_prefill_qk, self.cross_decode_kv,
                tuple(sorted(self.windows.items(),
                             key=lambda kv: (kv[0] is None, kv[0] or 0))))

    @staticmethod
    def from_batch(prefill_chunks: Sequence, decode_kv_lens: Sequence,
                   model_windows: Sequence, batch_sequences: int = 0,
                   encoder_tokens: int = 0,
                   prefill_source: Sequence = (),
                   decode_source: Sequence = ()) -> "Workload":
        """Build a Workload from raw batch state.

        ``prefill_chunks``: iterable of (q_len, kv_end) pairs.
        ``decode_kv_lens``: iterable of current KV lengths.
        ``model_windows`` : the distinct window sizes the model's cells use
                            (None for full attention).
        ``prefill_source``/``decode_source``: per-request encoder-memory
        lengths for cross-attention models.
        """
        pre_tok = sum(q for q, _ in prefill_chunks)
        windows = {}
        for wnd in set(list(model_windows) + [None]):
            qk = sum(_window_area(q, kv, wnd) for q, kv in prefill_chunks)
            if wnd is None:
                dkv = float(sum(decode_kv_lens))
            else:
                dkv = float(sum(min(k, wnd) for k in decode_kv_lens))
            windows[wnd] = (qk, dkv)
        cross_pre = sum(q * s for (q, _), s in zip(prefill_chunks,
                                                   prefill_source))
        cross_dec = float(sum(decode_source))
        return Workload(prefill_tokens=int(pre_tok),
                        decode_tokens=len(decode_kv_lens),
                        batch_sequences=batch_sequences,
                        windows=windows,
                        encoder_tokens=int(encoder_tokens),
                        cross_prefill_qk=float(cross_pre),
                        cross_decode_kv=cross_dec)

    def divided(self, dp: int) -> "Workload":
        """Per-replica slice under cell-level DP (even token split)."""
        if dp == 1:
            return self
        windows = {k: (qk / dp, dkv / dp)
                   for k, (qk, dkv) in self.windows.items()}
        return Workload(
            prefill_tokens=-(-self.prefill_tokens // dp),
            decode_tokens=-(-self.decode_tokens // dp),
            batch_sequences=-(-self.batch_sequences // dp),
            windows=windows,
            encoder_tokens=-(-self.encoder_tokens // dp),
            cross_prefill_qk=self.cross_prefill_qk / dp,
            cross_decode_kv=self.cross_decode_kv / dp,
        )


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

class Cell:
    """Base class for IR cells.

    A cell exposes:
      name, kind, num_tasks (shardable units), weight_params (scalar count),
      kv_bytes_per_token(q), state_bytes_per_seq(q),
      compute(workload, q)  -> list[OpCall]
      activation_bytes_per_token(q) -> resharding payload between cells

    Subclasses are frozen dataclasses declaring ``name`` and ``kind`` fields
    (deliberately not declared here — a base-class default would leak into
    subclass dataclass field ordering).
    """

    @property
    def num_tasks(self) -> int:
        raise NotImplementedError

    def weight_params(self) -> float:
        raise NotImplementedError

    def weight_bytes(self, q: QuantFormat) -> float:
        return self.weight_params() * q.weight_bytes

    def kv_bytes_per_token(self, q: QuantFormat) -> float:
        return 0.0

    def state_bytes_per_seq(self, q: QuantFormat) -> float:
        return 0.0

    def activation_bytes_per_token(self, q: QuantFormat) -> float:
        raise NotImplementedError

    def compute(self, w: Workload, q: QuantFormat) -> List[OpCall]:
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------

    @staticmethod
    def _gemm(m: float, n: int, k: int, q: QuantFormat,
              weight_shards: int = 1) -> OpCall:
        """A (m x k) @ (k x n) GEMM; ``weight_shards`` divides n (or k) when a
        template has already split the weight — callers pass post-sharding
        dims, this helper is for unsharded cell math."""
        flops = 2.0 * m * n * k
        mem = (m * k + m * n) * q.act_bytes + n * k * q.weight_bytes
        return OpCall("gemm", axes=(n, k, q.compute_dtype), x=float(m),
                      flops=flops, bytes=mem)


@dataclasses.dataclass(frozen=True)
class AttentionCell(Cell):
    """MHA / GQA / sliding-window attention (optionally with QKV bias).

    Task = query head (the paper's Fig. 5 distributes heads across devices).
    """

    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: Optional[int] = None        # sliding-window size (Mixtral, Gemma3)
    rope: str = "rope"                  # "rope" | "mrope" | "none"
    kind: str = "attn"

    @property
    def num_tasks(self) -> int:
        return self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def weight_params(self) -> float:
        p = self.d_model * self.q_dim          # W_q
        p += 2 * self.d_model * self.kv_dim    # W_k, W_v
        p += self.q_dim * self.d_model         # W_o
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        return float(p)

    def kv_bytes_per_token(self, q: QuantFormat) -> float:
        return 2.0 * self.kv_dim * q.kv_bytes

    def activation_bytes_per_token(self, q: QuantFormat) -> float:
        return self.d_model * q.act_bytes

    def compute(self, w: Workload, q: QuantFormat) -> List[OpCall]:
        ops: List[OpCall] = []
        t = w.total_tokens
        if t == 0:
            return ops
        # Projections: fused QKV GEMM + output GEMM over all tokens.
        ops.append(self._gemm(t, self.q_dim + 2 * self.kv_dim, self.d_model, q))
        ops.append(self._gemm(t, self.d_model, self.q_dim, q))
        # Prefill attention: score+value matmuls, 4 * qk * heads * head_dim
        # FLOPs total (2 matmuls x 2 flops each), window-exact.
        qk = w.prefill_qk(self.window)
        if qk > 0:
            flops = 4.0 * qk * self.n_heads * self.head_dim
            mem = (2 * w.prefill_tokens * self.q_dim * q.act_bytes
                   + 2 * w.prefill_tokens * self.kv_dim * q.kv_bytes)
            ops.append(OpCall("attn_prefill",
                              axes=(self.n_heads, self.head_dim,
                                    q.compute_dtype),
                              x=float(qk), flops=flops, bytes=mem))
        # Decode attention: memory-bound read of every active request's
        # (window-clamped) KV cache.
        if w.decode_tokens > 0:
            kv_tok = w.decode_kv(self.window)
            flops = 4.0 * kv_tok * self.n_heads * self.head_dim
            mem = kv_tok * self.kv_bytes_per_token(q)
            ops.append(OpCall("attn_decode",
                              axes=(self.n_kv_heads, self.head_dim,
                                    q.compute_dtype),
                              x=float(kv_tok), flops=flops, bytes=mem))
        return ops


@dataclasses.dataclass(frozen=True)
class MLACell(Cell):
    """Multi-head Latent Attention (DeepSeek-V2).

    KV is compressed into a rank-``kv_lora_rank`` latent (+ a shared RoPE
    key); the cache stores the latent, not per-head K/V — the decisive
    memory advantage the simulator must model.  The latent is NOT
    head-sharded: TP shards query heads and the up-projections, while each
    device holds the full latent cache (see templates.py).
    """

    name: str
    d_model: int
    n_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kind: str = "mla"

    @property
    def num_tasks(self) -> int:
        return self.n_heads

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def weight_params(self) -> float:
        p = self.d_model * self.n_heads * self.qk_head_dim            # W_q
        p += self.d_model * (self.kv_lora_rank + self.qk_rope_head_dim)  # W_dkv
        p += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim
                                                 + self.v_head_dim)   # W_ukv
        p += self.n_heads * self.v_head_dim * self.d_model            # W_o
        return float(p)

    def kv_bytes_per_token(self, q: QuantFormat) -> float:
        return (self.kv_lora_rank + self.qk_rope_head_dim) * q.kv_bytes

    def activation_bytes_per_token(self, q: QuantFormat) -> float:
        return self.d_model * q.act_bytes

    def compute(self, w: Workload, q: QuantFormat) -> List[OpCall]:
        ops: List[OpCall] = []
        t = w.total_tokens
        if t == 0:
            return ops
        ops.append(self._gemm(t, self.n_heads * self.qk_head_dim,
                              self.d_model, q))                      # W_q
        ops.append(self._gemm(t, self.kv_lora_rank + self.qk_rope_head_dim,
                              self.d_model, q))                      # W_dkv
        ops.append(self._gemm(t, self.n_heads * (self.qk_nope_head_dim
                                                 + self.v_head_dim),
                              self.kv_lora_rank, q))                 # W_ukv
        ops.append(self._gemm(t, self.d_model,
                              self.n_heads * self.v_head_dim, q))    # W_o
        qk = w.prefill_qk(None)
        if qk > 0:
            flops = 2.0 * qk * self.n_heads * (
                self.qk_head_dim + self.v_head_dim)
            mem = 2 * w.prefill_tokens * self.n_heads * self.qk_head_dim \
                * q.act_bytes
            ops.append(OpCall("attn_prefill",
                              axes=(self.n_heads, self.qk_head_dim,
                                    q.compute_dtype),
                              x=float(qk), flops=flops, bytes=mem))
        if w.decode_tokens > 0:
            kv_tok = w.decode_kv(None)
            # Absorbed-matmul decode: score against the latent directly.
            flops = 2.0 * kv_tok * self.n_heads * (
                self.kv_lora_rank + self.qk_rope_head_dim + self.v_head_dim)
            mem = kv_tok * self.kv_bytes_per_token(q)
            ops.append(OpCall("attn_decode",
                              axes=(self.n_heads, self.kv_lora_rank,
                                    q.compute_dtype),
                              x=float(kv_tok), flops=flops, bytes=mem))
        return ops


@dataclasses.dataclass(frozen=True)
class CrossAttentionCell(Cell):
    """Encoder-decoder cross-attention (Seamless-M4T decoder).

    K/V come from the encoder memory and are computed ONCE per request
    (at prefill); decode steps only read them.
    """

    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    source_len: int                  # encoder memory length (trace-provided)
    kind: str = "cross_attn"

    @property
    def num_tasks(self) -> int:
        return self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def weight_params(self) -> float:
        return float(self.d_model * self.q_dim + 2 * self.d_model * self.kv_dim
                     + self.q_dim * self.d_model)

    def kv_bytes_per_token(self, q: QuantFormat) -> float:
        # Cross-attn KV is per-SOURCE-token; accounted via state_bytes.
        return 0.0

    def state_bytes_per_seq(self, q: QuantFormat) -> float:
        return 2.0 * self.kv_dim * q.kv_bytes * self.source_len

    def activation_bytes_per_token(self, q: QuantFormat) -> float:
        return self.d_model * q.act_bytes

    def compute(self, w: Workload, q: QuantFormat) -> List[OpCall]:
        ops: List[OpCall] = []
        t = w.total_tokens
        if t == 0:
            return ops
        ops.append(self._gemm(t, self.q_dim, self.d_model, q))    # W_q
        ops.append(self._gemm(t, self.d_model, self.q_dim, q))    # W_o
        if w.encoder_tokens > 0:
            # K/V projection of new encoder memory, once per request.
            ops.append(self._gemm(w.encoder_tokens, 2 * self.kv_dim,
                                  self.d_model, q))
        if w.cross_prefill_qk > 0:
            flops = 4.0 * w.cross_prefill_qk * self.n_heads * self.head_dim
            mem = 2 * w.prefill_tokens * self.q_dim * q.act_bytes
            ops.append(OpCall("attn_prefill",
                              axes=(self.n_heads, self.head_dim,
                                    q.compute_dtype),
                              x=float(w.cross_prefill_qk), flops=flops,
                              bytes=mem))
        if w.cross_decode_kv > 0:
            flops = 4.0 * w.cross_decode_kv * self.n_heads * self.head_dim
            mem = w.cross_decode_kv * 2 * self.kv_dim * q.kv_bytes
            ops.append(OpCall("attn_decode",
                              axes=(self.n_kv_heads, self.head_dim,
                                    q.compute_dtype),
                              x=float(w.cross_decode_kv), flops=flops,
                              bytes=mem))
        return ops


@dataclasses.dataclass(frozen=True)
class MLPCell(Cell):
    """Dense feed-forward: 2-matrix (GELU) or 3-matrix gated (SwiGLU)."""

    name: str
    d_model: int
    d_ff: int
    gated: bool = True
    kind: str = "mlp"

    @property
    def num_tasks(self) -> int:
        # Task = a d_ff column group; templates shard d_ff.
        return self.d_ff

    @property
    def num_mats(self) -> int:
        return 3 if self.gated else 2

    def weight_params(self) -> float:
        return float(self.num_mats * self.d_model * self.d_ff)

    def activation_bytes_per_token(self, q: QuantFormat) -> float:
        return self.d_model * q.act_bytes

    def compute(self, w: Workload, q: QuantFormat) -> List[OpCall]:
        t = w.total_tokens
        if t == 0:
            return []
        up_n = (2 if self.gated else 1) * self.d_ff
        return [
            self._gemm(t, up_n, self.d_model, q),
            self._gemm(t, self.d_model, self.d_ff, q),
        ]


@dataclasses.dataclass(frozen=True)
class MoECell(Cell):
    """Mixture-of-Experts FFN with top-k routing (+ optional shared experts).

    Task = expert (the paper's EP distributes experts across devices).
    """

    name: str
    d_model: int
    d_ff_expert: int
    n_routed: int
    top_k: int
    n_shared: int = 0
    gated: bool = True
    kind: str = "moe"

    @property
    def num_tasks(self) -> int:
        return self.n_routed

    @property
    def num_mats(self) -> int:
        return 3 if self.gated else 2

    def expert_params(self) -> float:
        return float(self.num_mats * self.d_model * self.d_ff_expert)

    def weight_params(self) -> float:
        router = self.d_model * self.n_routed
        return (self.n_routed + self.n_shared) * self.expert_params() + router

    @property
    def active_experts_per_token(self) -> int:
        return self.top_k + self.n_shared

    def activation_bytes_per_token(self, q: QuantFormat) -> float:
        return self.d_model * q.act_bytes

    def compute(self, w: Workload, q: QuantFormat) -> List[OpCall]:
        t = w.total_tokens
        if t == 0:
            return []
        # Single-device case; templates.moe_expert_gemms handles sharding
        # (import deferred: templates depends on ir).
        from .templates import moe_expert_gemms
        ops = [self._gemm(t, self.n_routed, self.d_model, q)]   # router
        ops += moe_expert_gemms(self, float(t * self.top_k), self.n_routed,
                                1, q)
        if self.n_shared:
            ops += moe_expert_gemms(self, float(t * self.n_shared),
                                    self.n_shared, 1, q, all_activated=True)
        return ops


@dataclasses.dataclass(frozen=True)
class SSMCell(Cell):
    """Mamba2 SSD (state-space duality) mixer — attention-free.

    Task = SSD head.  Per-sequence recurrent state is O(1) in context
    length: heads * head_dim * d_state scalars (+ conv window) — the
    memory model that lets the simulator admit far more concurrent
    sequences than an attention arch (the point of long_500k).
    """

    name: str
    d_model: int
    d_inner: int
    d_state: int
    n_ssd_heads: int
    d_conv: int = 4
    n_groups: int = 1
    kind: str = "ssm"

    @property
    def num_tasks(self) -> int:
        return self.n_ssd_heads

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_ssd_heads

    def weight_params(self) -> float:
        in_n = (2 * self.d_inner + 2 * self.n_groups * self.d_state
                + self.n_ssd_heads)
        p = self.d_model * in_n                         # in_proj (x,z,B,C,dt)
        p += self.d_conv * (self.d_inner
                            + 2 * self.n_groups * self.d_state)  # conv1d
        p += self.d_inner * self.d_model                # out_proj
        p += 2 * self.n_ssd_heads + self.d_inner        # A, dt_bias, D
        return float(p)

    def state_bytes_per_seq(self, q: QuantFormat) -> float:
        ssm = self.n_ssd_heads * self.head_dim * self.d_state
        conv = self.d_conv * (self.d_inner + 2 * self.n_groups * self.d_state)
        # Recurrent state is kept in fp32 for stability (matches kernels/).
        return float(ssm * 4 + conv * q.act_bytes)

    def activation_bytes_per_token(self, q: QuantFormat) -> float:
        return self.d_model * q.act_bytes

    def compute(self, w: Workload, q: QuantFormat) -> List[OpCall]:
        t = w.total_tokens
        if t == 0:
            return []
        in_n = (2 * self.d_inner + 2 * self.n_groups * self.d_state
                + self.n_ssd_heads)
        ops = [
            self._gemm(t, in_n, self.d_model, q),
            self._gemm(t, self.d_model, self.d_inner, q),
        ]
        # SSD scan: state update + readout, 6 * t * d_inner * d_state FLOPs
        # (B-weighted outer-product update, C readout, decay).
        flops = 6.0 * t * self.d_inner * self.d_state
        mem = t * self.d_inner * q.act_bytes * 2
        if w.decode_tokens > 0:
            # decode reads+writes the full state per sequence
            mem += w.batch_sequences * self.state_bytes_per_seq(q)
        ops.append(OpCall("ssd_scan",
                          axes=(self.d_inner, self.d_state, q.compute_dtype),
                          x=float(t), flops=flops, bytes=mem))
        return ops


# ---------------------------------------------------------------------------
# Blocks and models
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Block:
    """The smallest non-repetitive chain of adjacent cells (paper §3.2.1)."""

    cells: tuple          # tuple[Cell, ...]
    repeat: int           # how many times the block tiles the model

    def __post_init__(self):
        if self.repeat < 1:
            raise ValueError("block repeat must be >= 1")
        if not self.cells:
            raise ValueError("block needs at least one cell")

    def weight_bytes(self, q: QuantFormat) -> float:
        return sum(c.weight_bytes(q) for c in self.cells)

    def weight_bytes_scalars(self) -> float:
        """Total parameter count across all repeats of this block."""
        return sum(c.weight_params() for c in self.cells) * self.repeat

    def kv_bytes_per_token(self, q: QuantFormat) -> float:
        return sum(c.kv_bytes_per_token(q) for c in self.cells)

    def state_bytes_per_seq(self, q: QuantFormat) -> float:
        return sum(c.state_bytes_per_seq(q) for c in self.cells)

    def cell_types(self) -> list:
        """Distinct (kind, signature) groups — planner assigns one scheme
        per group to avoid exponential per-cell enumeration."""
        seen, out = {}, []
        for c in self.cells:
            key = (c.kind, c.name.rsplit(".", 1)[-1])
            if key not in seen:
                seen[key] = True
                out.append(key)
        return out


@dataclasses.dataclass(frozen=True)
class ModelIR:
    """A full model: embedding/head bytes + repeated blocks.

    ``encoder`` (optional) models encoder-decoder architectures: the encoder
    is its own block chain executed once per request at prefill.
    """

    name: str
    d_model: int
    vocab_size: int
    block: Block
    tie_embeddings: bool = False
    encoder: Optional[Block] = None

    # -- aggregates ----------------------------------------------------------

    def embed_params(self) -> float:
        mult = 1 if self.tie_embeddings else 2
        return float(mult * self.vocab_size * self.d_model)

    def total_params(self) -> float:
        p = self.embed_params()
        p += self.block.weight_bytes_scalars()
        if self.encoder is not None:
            p += self.encoder.weight_bytes_scalars()
        return p

    def weight_bytes(self, q: QuantFormat) -> float:
        b = self.embed_params() * q.weight_bytes
        b += self.block.weight_bytes(q) * self.block.repeat
        if self.encoder is not None:
            b += self.encoder.weight_bytes(q) * self.encoder.repeat
        return b

    def kv_bytes_per_token(self, q: QuantFormat) -> float:
        return self.block.kv_bytes_per_token(q) * self.block.repeat

    def state_bytes_per_seq(self, q: QuantFormat) -> float:
        return self.block.state_bytes_per_seq(q) * self.block.repeat

    def lm_head_opcall(self, tokens: int, q: QuantFormat) -> OpCall:
        return Cell._gemm(tokens, self.vocab_size, self.d_model, q)

    @property
    def num_layers(self) -> int:
        return self.block.repeat * len(
            [c for c in self.block.cells if c.kind in
             ("attn", "mla", "ssm", "cross_attn")]
        ) or self.block.repeat

    def describe(self) -> str:
        cells = " -> ".join(f"{c.name}[{c.kind}]" for c in self.block.cells)
        return (f"{self.name}: d_model={self.d_model} vocab={self.vocab_size} "
                f"block=({cells}) x{self.block.repeat}, "
                f"params={self.total_params() / 1e9:.2f}B")


# ---------------------------------------------------------------------------
# IR converter (paper §3.2.1: "parses an LLM's configuration file")
# ---------------------------------------------------------------------------

def ir_from_hf_config(cfg: dict, name: str = "model") -> ModelIR:
    """Build IR from a HuggingFace-style config dict.

    This is the paper's zero-LoC extension path (Table 5 first row): a new
    dense/GQA/MoE LLM needs only its config file.  Architectures with
    unknown cells (SSM, MLA, ...) use the explicit constructors in
    repro/configs/ instead (Table 5 second row).
    """
    d_model = cfg.get("hidden_size") or cfg["d_model"]
    n_layers = cfg.get("num_hidden_layers") or cfg["n_layers"]
    n_heads = cfg.get("num_attention_heads") or cfg["n_heads"]
    n_kv = cfg.get("num_key_value_heads", n_heads)
    head_dim = cfg.get("head_dim", d_model // n_heads)
    d_ff = cfg.get("intermediate_size") or cfg["d_ff"]
    vocab = cfg.get("vocab_size", 32000)
    window = cfg.get("sliding_window", None)
    bias = bool(cfg.get("attention_bias", cfg.get("qkv_bias", False)))

    attn = AttentionCell(name="attn", d_model=d_model, n_heads=n_heads,
                         n_kv_heads=n_kv, head_dim=head_dim, qkv_bias=bias,
                         window=window)
    n_experts = cfg.get("num_local_experts", cfg.get("n_routed_experts", 0))
    if n_experts:
        ffn: Cell = MoECell(name="moe", d_model=d_model,
                            d_ff_expert=cfg.get("moe_intermediate_size", d_ff),
                            n_routed=n_experts,
                            top_k=cfg.get("num_experts_per_tok", 2),
                            n_shared=cfg.get("n_shared_experts", 0))
    else:
        ffn = MLPCell(name="mlp", d_model=d_model, d_ff=d_ff, gated=True)
    block = Block(cells=(attn, ffn), repeat=n_layers)
    return ModelIR(name=name, d_model=d_model, vocab_size=vocab, block=block,
                   tie_embeddings=bool(cfg.get("tie_word_embeddings", False)))
