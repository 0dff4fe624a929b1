"""Batching Module — dynamism-aware iteration-level batching (paper §3.3).

Simulates the request lifecycle of a continuous-batching serving system:

  * greedy admission whenever KV memory permits (no pre-allocation for
    future generated tokens — exactly the paper's greedy semantics),
  * per-iteration batch construction: prefill-priority contiguous batching
    (vLLM-style, the paper's default) or Sarathi-style chunked prefill
    (the paper's §4.5 batching extension: a chunk-size knob + per-request
    chunk counters),
  * KV growth of one token per active decode request per iteration,
  * preemption of the MOST-RECENTLY-added requests when KV overflows
    (paper: "the most recently added requests and their tokens are
    temporarily removed to free memory for earlier requests to complete"),
  * static batching (the paper's §2.3 strawman) and a max-batch-size cap
    (the paper's §4.6 SLO knob).

The module is cost-model-agnostic: it asks a ``step_cost(Workload)``
callback (the LLM Serving Simulator) for each iteration's duration/energy
and advances virtual time.  A fast-forward optimization batches runs of
uneventful decode iterations (no arrival/completion/overflow possible
within the run) into one cost evaluation at the midpoint KV state; this is
exact to first order (decode cost is ~linear in KV length) and is validated
against exact stepping in tests/test_batching.py.

Since the event-engine refactor this module is a one-replica front for
``core/engine.py``: the continuous/chunked/static/decode-role mechanics
live in the engine's ``SchedulerPolicy`` variants (``ContinuousScheduler``
/ ``StaticScheduler``), where every replica of every pool — colocated or
disaggregated — shares them.  ``BatchingModule.run`` simply drives a
single-replica, single-pool engine, which is numerically identical to the
per-replica loop it replaced (tests/test_engine_golden.py).

The port's copy of ``repro/core/batching.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from .ir import Workload
from .trace import DEFAULT_SLO, Request, SLOClass

RefetchDelay = Callable[[Request], float]
# (victim request, its live KV tokens) -> (round-trip delay_s, energy_j)
SwapCost = Callable[[Request, int], Tuple[float, float]]


@dataclasses.dataclass
class BatchingPolicy:
    mode: str = "continuous"             # "continuous" | "static"
    chunked_prefill: Optional[int] = None  # Sarathi chunk size (tokens)
    max_batch_size: Optional[int] = None   # §4.6 SLO knob
    max_prefill_tokens: int = 16384        # per-iteration prefill budget
    fast_forward: bool = True
    fast_forward_cap: int = 64
    # memory-threshold admission control (continuous mode only): when a
    # busy replica's projected KV occupancy (reserved + the head request's
    # demand) would exceed ``admission_watermark * capacity``, the head is
    # deferred (held in queue; the default) or rejected outright
    # (dropped + counted).  None disables the gate (legacy behaviour).
    admission_watermark: Optional[float] = None
    admission_mode: str = "defer"        # "defer" | "reject"


@dataclasses.dataclass
class RequestRecord:
    rid: int
    arrival: float
    context_len: int
    gen_len: int
    first_token_time: float = 0.0
    finish_time: float = 0.0
    preemptions: int = 0          # total evictions (sacrifices + swaps)
    refetch_s: float = 0.0        # KV re-fetch delay charged on re-admissions
    swaps: int = 0                # evictions served by KV swap (not recompute)
    swap_s: float = 0.0           # host-link round-trip delay charged on swaps
    slo_class: SLOClass = DEFAULT_SLO
    rejected: bool = False        # dropped by admission control (never served)

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival

    @property
    def tpot(self) -> float:
        if self.gen_len <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (self.gen_len - 1)

    @property
    def e2e(self) -> float:
        return self.finish_time - self.arrival


@dataclasses.dataclass
class BatchingResult:
    records: List[RequestRecord]
    iterations: int
    total_time: float
    total_energy: float
    preemptions: int              # total evictions (sacrifices + swaps)
    peak_kv_tokens: int
    peak_batch: int
    kv_refetch_s: float = 0.0     # total re-fetch delay across all victims
    swap_outs: int = 0            # victims whose KV moved to host
    swap_ins: int = 0             # swapped victims re-admitted from host
    kv_swap_s: float = 0.0        # total host-link delay across all swaps
    admission_rejected: int = 0   # requests dropped at the watermark
    admission_deferred: int = 0   # unique requests held at the watermark


StepCost = Callable[[Workload], Tuple[float, float]]


class BatchingModule:
    """One replica's iteration-level batching simulation."""

    def __init__(self, kv_capacity_tokens: int, policy: BatchingPolicy,
                 model_windows: Sequence = (None,),
                 max_sequences: int = 512,
                 is_encdec: bool = False,
                 role: str = "both",
                 refetch_delay: Optional[RefetchDelay] = None,
                 preemption=None,
                 swap_cost: Optional[SwapCost] = None):
        if kv_capacity_tokens <= 0:
            raise ValueError("plan has no KV capacity — infeasible")
        if role not in ("both", "decode"):
            raise ValueError(f"unknown batching role {role!r}")
        self.capacity = kv_capacity_tokens
        self.policy = policy
        self.windows = tuple(model_windows)
        self.max_sequences = max_sequences
        self.is_encdec = is_encdec
        # KV-overflow handling: a PreemptionPolicy object or a menu string
        # ("sacrifice", "swap", "swap/lowest-priority-first", ...); None is
        # today's default, sacrifice + recent-first.  ``swap_cost`` prices
        # one victim's host round trip for the swap mechanism.
        self.preemption = preemption
        self.swap_cost = swap_cost
        # role="decode" models the decode pool of a disaggregated
        # deployment: an admitted request's prompt KV is already
        # materialized (shipped from the prefill pool), so admission starts
        # it mid-lifecycle — prefill done, first token produced — and only
        # decode iterations run here.  A preempted request loses its cache
        # and must RE-FETCH it before re-admission: ``refetch_delay(req)``
        # returns the seconds the victim waits before it becomes admissible
        # again.  The coupled simulation routes the re-fetch through the
        # event engine as a real re-prefill + transfer; standalone use
        # defaults to a re-prefill estimate priced through ``step_cost``.
        self.role = role
        self.refetch_delay = refetch_delay

    def run(self, requests: Sequence[Request], step_cost: StepCost
            ) -> BatchingResult:
        from .engine import Engine   # deferred: engine imports our types
        if self.policy.mode == "static" and self.role == "decode":
            raise ValueError("decode role requires continuous batching")
        engine = Engine()
        pool = engine.add_pool(
            "solo", [list(requests)], self.capacity, self.policy,
            step_cost, windows=self.windows,
            max_sequences=self.max_sequences, is_encdec=self.is_encdec,
            role=self.role, refetch_delay=self.refetch_delay,
            preemption=self.preemption, swap_cost=self.swap_cost)
        engine.run()
        results = pool.results()
        if not results:
            return BatchingResult(records=[], iterations=0, total_time=0.0,
                                  total_energy=0.0, preemptions=0,
                                  peak_kv_tokens=0, peak_batch=0)
        return results[0]
