"""Multi-replica request routing: decayed shortest-queue dispatch.

Model-level DP in serving = independent replicas; the router spreads
arrivals by estimated backlog (queued prompt+gen tokens), the simple and
robust straggler-mitigation policy at fleet scale: a slow replica
naturally accumulates backlog and stops receiving work.

Backlog is *decayed* with arrival-time gaps: each replica drains work at an
estimated rate while the clock advances, so a request arriving after a long
quiet period sees near-empty queues instead of the sum of everything ever
routed (the old monotonic-accumulation bug, which effectively degraded this
router to round-robin-by-token-count for late arrivals).

``PoolRouter`` extends the same policy to disaggregated prefill/decode
deployments: each request is dispatched twice — its prompt to a prefill
replica (cost = prompt tokens) and its generation to a decode replica
(cost = gen tokens) — with independently decayed backlogs per pool.  The
disaggregated simulator (repro/disagg/simulate.py) uses the same balancer
for pool-internal replica routing, so simulated and real dispatch agree.

The port's copy of ``repro/serving/router.py``: ``ReplicaRouter`` runs
the port's ``ServingEngine`` replicas.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # real-engine types only; keeps this module torch-free
    from .engine import EngineReport, ServingEngine


def derive_drain_rate(tokens_per_iter: float, iter_seconds: float,
                      fallback: float) -> float:
    """Tokens/s one replica retires, from a measured (or simulated)
    iteration: the principled way to size a ``BacklogBalancer``'s decay.
    The disaggregated simulator derives each pool's rate from its own
    iteration cost on a trace-representative workload (replacing the old
    hard-coded 4096/512 constants); ``fallback`` covers degenerate
    measurements (zero/negative duration)."""
    if iter_seconds > 0.0 and tokens_per_iter > 0.0:
        return tokens_per_iter / iter_seconds
    return fallback


class BacklogBalancer:
    """Least-estimated-backlog assignment with time-based drain decay.

    ``drain_rate`` is the estimated tokens/s one replica retires; between
    consecutive dispatches the recorded backlog of every replica decays by
    ``elapsed * drain_rate`` (floored at zero).  The default is deliberately
    conservative — underestimating drain only makes the balancer more
    eager to spread load, never starves a replica: prefer a measured rate
    via ``derive_drain_rate`` when an iteration-cost model is at hand.
    """

    def __init__(self, num_replicas: int, drain_rate: float = 512.0):
        if num_replicas < 1:
            raise ValueError("need at least one replica")
        self.backlog = [0.0] * num_replicas
        self.last_time = 0.0
        self.drain_rate = drain_rate

    def assign(self, arrival: float, cost: float) -> int:
        """Route one request of ``cost`` tokens arriving at ``arrival``."""
        dt = max(0.0, arrival - self.last_time)
        if dt > 0.0:
            drained = dt * self.drain_rate
            self.backlog = [max(0.0, b - drained) for b in self.backlog]
            self.last_time = arrival
        i = min(range(len(self.backlog)), key=lambda j: self.backlog[j])
        self.backlog[i] += cost
        return i


def _req_fields(r) -> Tuple[float, float, float]:
    """(arrival, prompt_tokens, gen_tokens) from a dict or Request."""
    if isinstance(r, dict):
        return r["arrival"], float(len(r["prompt"])), float(r["gen_len"])
    return r.arrival, float(r.context_len), float(r.gen_len)


class ReplicaRouter:
    def __init__(self, engines: List["ServingEngine"],
                 drain_rate: float = 512.0):
        if not engines:
            raise ValueError("need at least one replica")
        self.engines = engines
        self.drain_rate = drain_rate

    def split(self, requests: Sequence) -> List[List]:
        """Assign requests (sorted by arrival) to replicas by least
        decayed-estimated backlog."""
        bal = BacklogBalancer(len(self.engines), self.drain_rate)
        buckets: List[List] = [[] for _ in self.engines]
        for r in sorted(requests, key=lambda r: _req_fields(r)[0]):
            arrival, prompt, gen = _req_fields(r)
            buckets[bal.assign(arrival, prompt + gen)].append(r)
        return buckets

    def run(self, requests: List[dict],
            time_scale: float = 1.0) -> List["EngineReport"]:
        return [eng.run(bucket, time_scale=time_scale)
                for eng, bucket in zip(self.engines, self.split(requests))]


class PoolRouter:
    """Pool-aware dispatch for disaggregated prefill/decode serving.

    Splits a replica fleet into a prefill pool and a decode pool and
    routes each request twice: prompt work to the prefill pool, generation
    work to the decode pool.  Pools are sized in *replicas*; the physical
    pool split (devices, parallel schemes, KV handoff) is modeled by
    repro/disagg — this class only decides who runs what.
    """

    def __init__(self, num_prefill: int, num_decode: int,
                 prefill_drain_rate: float = 4096.0,
                 decode_drain_rate: float = 512.0):
        if num_prefill < 1 or num_decode < 1:
            raise ValueError("each pool needs at least one replica")
        self.num_prefill = num_prefill
        self.num_decode = num_decode
        self.prefill_drain_rate = prefill_drain_rate
        self.decode_drain_rate = decode_drain_rate

    def split(self, requests: Sequence
              ) -> Tuple[List[List], List[List]]:
        """(prefill_buckets, decode_buckets): per-replica request lists.

        The same request object appears once in each pool — prefill
        replicas run its prompt, decode replicas its generation.
        """
        pre = BacklogBalancer(self.num_prefill, self.prefill_drain_rate)
        dec = BacklogBalancer(self.num_decode, self.decode_drain_rate)
        pre_buckets: List[List] = [[] for _ in range(self.num_prefill)]
        dec_buckets: List[List] = [[] for _ in range(self.num_decode)]
        for r in sorted(requests, key=lambda r: _req_fields(r)[0]):
            arrival, prompt, gen = _req_fields(r)
            pre_buckets[pre.assign(arrival, prompt)].append(r)
            dec_buckets[dec.assign(arrival, gen)].append(r)
        return pre_buckets, dec_buckets
