"""Fault injection and resilience accounting for the event engine.

A ``FaultSchedule`` is a seeded, fully deterministic description of what
goes wrong during one simulated serving run:

  * ``ReplicaFault`` — a fail-stop: at ``start`` the replica's device
    group drops out, its KV cache and in-flight iteration are lost, and
    its active + pending requests re-queue to surviving replicas through
    the pool's sacrifice/recompute path (decode-pool victims re-fetch
    their prompt KV through the prefill pool, exactly like a preemption).
    At ``repair`` (may be ``inf`` = never) the replica returns to service
    with an empty cache.
  * ``LinkDegradation`` — the cross-pool KV wire's effective bandwidth
    drops by ``factor`` inside ``[start, end)`` (transfer/refetch times
    multiply by ``factor``).
  * ``Straggler`` — a replica runs ``slowdown``x slower inside
    ``[start, end)`` (iteration time and energy scale; the step-cost
    cache stays fault-free — the scale is applied after the lookup, so
    degraded runs never pollute healthy cost tables).

Schedules are frozen and hashable: ``cost_key()`` extends the plan's
cost fingerprint so ``SharedCostStore`` entries priced under a degraded
cluster state can never collide with healthy-state entries.

``FaultSchedule.sample`` draws a schedule from seeded MTBF/MTTR
exponentials — same seed, same schedule, bit-identical simulation —
and ``fault_ensemble`` draws N independent schedules for resilience-
aware plan search (``objective="degraded_goodput"``).

The port's copy of ``repro/core/faults.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import ResilienceReport, p95, slo_met


@dataclasses.dataclass(frozen=True)
class ReplicaFault:
    """Fail-stop of one replica: down at ``start``, back (with an empty
    KV cache) at ``repair``.  ``pool`` names the target pool ("serve",
    "prefill", "decode", ...) or "*" for every pool with that index."""

    replica: int
    start: float
    repair: float = math.inf
    pool: str = "*"

    def __post_init__(self):
        if self.replica < 0:
            raise ValueError(f"replica index must be >= 0, "
                             f"got {self.replica}")
        if self.start < 0 or self.repair <= self.start:
            raise ValueError(f"need 0 <= start < repair, got "
                             f"[{self.start}, {self.repair})")


@dataclasses.dataclass(frozen=True)
class LinkDegradation:
    """Cross-pool wire bandwidth degradation: transfer times multiply by
    ``factor`` (>= 1) inside ``[start, end)``."""

    start: float
    end: float
    factor: float

    def __post_init__(self):
        if self.start < 0 or self.end <= self.start:
            raise ValueError(f"need 0 <= start < end, got "
                             f"[{self.start}, {self.end})")
        if self.factor < 1.0:
            raise ValueError(f"degradation factor must be >= 1, "
                             f"got {self.factor}")


@dataclasses.dataclass(frozen=True)
class Straggler:
    """One replica runs ``slowdown``x slower inside ``[start, end)``."""

    replica: int
    start: float
    end: float
    slowdown: float
    pool: str = "*"

    def __post_init__(self):
        if self.replica < 0:
            raise ValueError(f"replica index must be >= 0, "
                             f"got {self.replica}")
        if self.start < 0 or self.end <= self.start:
            raise ValueError(f"need 0 <= start < end, got "
                             f"[{self.start}, {self.end})")
        if self.slowdown < 1.0:
            raise ValueError(f"slowdown must be >= 1, got {self.slowdown}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """One run's worth of injected faults (empty by default).

    ``throttle`` models graceful admission degradation: while any replica
    of a pool is down, the pool's effective ``max_sequences`` is scaled
    by ``throttle`` (1.0 = no throttling; 0.5 = survivors admit at half
    their normal concurrency so queued work doesn't thrash the remaining
    KV into preemption storms).
    """

    replica_faults: Tuple[ReplicaFault, ...] = ()
    link_faults: Tuple[LinkDegradation, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()
    throttle: float = 1.0

    def __post_init__(self):
        # tolerate lists at construction; store tuples (hashable)
        object.__setattr__(self, "replica_faults",
                           tuple(self.replica_faults))
        object.__setattr__(self, "link_faults", tuple(self.link_faults))
        object.__setattr__(self, "stragglers", tuple(self.stragglers))
        if not 0.0 < self.throttle <= 1.0:
            raise ValueError(f"throttle must lie in (0, 1], "
                             f"got {self.throttle}")

    @property
    def empty(self) -> bool:
        return not (self.replica_faults or self.link_faults
                    or self.stragglers)

    def cost_key(self) -> tuple:
        """Hashable fingerprint extension: everything that can change a
        priced step cost or transfer time under this schedule.  Appended
        to ``cost_fingerprint`` so a degraded cluster state's cache
        entries live in their own ``SharedCostStore`` table, never
        shared with healthy-state entries."""
        if self.empty:
            return ()
        return (self.replica_faults, self.link_faults, self.stragglers,
                self.throttle)

    # -- queries the engine and the report builder use ---------------------

    def link_factor(self, t: float) -> float:
        """Wire-time multiplier at time ``t`` (product of overlapping
        degradation windows; 1.0 outside all of them)."""
        f = 1.0
        for d in self.link_faults:
            if d.start <= t < d.end:
                f *= d.factor
        return f

    def restrict(self, pool_sizes: Dict[str, int]) -> "FaultSchedule":
        """The subset of this schedule that can actually fire against a
        deployment with ``pool_sizes`` replicas per pool (a fault aimed
        at replica 3 of a dp=2 plan is inert and excluded from
        availability accounting)."""
        def applies(pool: str, replica: int) -> bool:
            if pool == "*":
                return any(replica < n for n in pool_sizes.values())
            return replica < pool_sizes.get(pool, 0)

        return FaultSchedule(
            replica_faults=tuple(f for f in self.replica_faults
                                 if applies(f.pool, f.replica)),
            link_faults=self.link_faults,
            stragglers=tuple(s for s in self.stragglers
                             if applies(s.pool, s.replica)),
            throttle=self.throttle)

    def windows(self, horizon: float) -> List[Tuple[float, float]]:
        """Merged degraded-time intervals (any fault active), clipped to
        ``[0, horizon]`` — the split used for degraded-vs-nominal
        latency/goodput accounting."""
        raw = [(f.start, f.repair) for f in self.replica_faults]
        raw += [(d.start, d.end) for d in self.link_faults]
        raw += [(s.start, s.end) for s in self.stragglers]
        clipped = [(max(0.0, a), min(horizon, b)) for a, b in raw
                   if a < horizon and b > 0.0]
        if not clipped:
            return []
        clipped.sort()
        merged = [clipped[0]]
        for a, b in clipped[1:]:
            la, lb = merged[-1]
            if a <= lb:
                merged[-1] = (la, max(lb, b))
            else:
                merged.append((a, b))
        return merged

    # -- seeded sampling ---------------------------------------------------

    @classmethod
    def sample(cls, seed: int, horizon_s: float, n_replicas: int,
               pool: str = "*",
               replica_mtbf_s: Optional[float] = None,
               replica_mttr_s: float = 30.0,
               link_mtbf_s: Optional[float] = None,
               link_mttr_s: float = 15.0,
               link_factor: float = 4.0,
               straggler_mtbf_s: Optional[float] = None,
               straggler_mttr_s: float = 15.0,
               straggler_slowdown: float = 2.0,
               throttle: float = 1.0) -> "FaultSchedule":
        """Draw one schedule over ``[0, horizon_s)``.

        Each fault family is an alternating-renewal process per replica
        (up-time ~ Exp(mtbf), down-time ~ Exp(mttr)); ``None`` mtbf
        disables the family.  Deterministic in ``seed`` — the same seed
        always yields the same schedule, so a simulation under it is
        bit-reproducible.
        """
        rng = random.Random(seed)
        replica_faults: List[ReplicaFault] = []
        stragglers: List[Straggler] = []
        link_faults: List[LinkDegradation] = []

        def renewal(mtbf: float, mttr: float):
            """Alternating (down_start, down_end) windows in horizon."""
            t = rng.expovariate(1.0 / mtbf)
            while t < horizon_s:
                down = rng.expovariate(1.0 / mttr)
                yield t, t + down
                t += down + rng.expovariate(1.0 / mtbf)

        for i in range(n_replicas):
            if replica_mtbf_s is not None:
                for a, b in renewal(replica_mtbf_s, replica_mttr_s):
                    replica_faults.append(
                        ReplicaFault(replica=i, start=a, repair=b,
                                     pool=pool))
            if straggler_mtbf_s is not None:
                for a, b in renewal(straggler_mtbf_s, straggler_mttr_s):
                    stragglers.append(
                        Straggler(replica=i, start=a, end=b,
                                  slowdown=straggler_slowdown, pool=pool))
        if link_mtbf_s is not None:
            for a, b in renewal(link_mtbf_s, link_mttr_s):
                link_faults.append(
                    LinkDegradation(start=a, end=b, factor=link_factor))
        return cls(replica_faults=tuple(replica_faults),
                   link_faults=tuple(link_faults),
                   stragglers=tuple(stragglers), throttle=throttle)


def fault_ensemble(seed: int, n: int, horizon_s: float, n_replicas: int,
                   **kw) -> List[FaultSchedule]:
    """``n`` independent seeded schedules (seeds ``seed .. seed+n-1``) —
    the small ensemble resilience-aware search confirms finalists
    against."""
    if n <= 0:
        raise ValueError(f"ensemble size must be > 0, got {n}")
    return [FaultSchedule.sample(seed + i, horizon_s, n_replicas, **kw)
            for i in range(n)]


def normalize_faults(spec) -> Tuple[FaultSchedule, ...]:
    """The ``faults=`` plumbing: None -> (), one schedule -> (it,), a
    sequence of schedules -> tuple.  Empty schedules are dropped."""
    if spec is None:
        return ()
    if isinstance(spec, FaultSchedule):
        spec = (spec,)
    out = []
    for s in spec:
        if not isinstance(s, FaultSchedule):
            raise TypeError(f"faults must be FaultSchedule(s), "
                            f"got {type(s).__name__}")
        if not s.empty:
            out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------
# resilience accounting
# ---------------------------------------------------------------------------

def build_resilience(schedule: FaultSchedule, records: Sequence,
                     total_time: float, pool_sizes: Dict[str, int],
                     requeued: int) -> ResilienceReport:
    """One faulted run's ``ResilienceReport``.

    ``records`` are ALL request records (dropped requests carry
    ``finish_time == 0``); ``pool_sizes`` maps pool name -> replica
    count (availability normalizes by total replica-seconds).
    """
    applied = schedule.restrict(pool_sizes)
    n_replicas = sum(pool_sizes.values())
    horizon = max(total_time, 0.0)

    # availability: 1 - (down replica-seconds / total replica-seconds),
    # counting each applied fail-stop's clipped outage once per pool it
    # hits ("*" wildcards hit every pool with that replica index)
    down_s = 0.0
    for f in applied.replica_faults:
        hits = sum(1 for name, n in pool_sizes.items()
                   if f.replica < n and f.pool in ("*", name))
        down_s += hits * max(0.0, min(f.repair, horizon) - min(f.start,
                                                               horizon))
    denom = n_replicas * horizon
    availability = 1.0 - down_s / denom if denom > 0 else 1.0

    windows = applied.windows(horizon)
    degraded_s = sum(b - a for a, b in windows)

    def in_window(t: float) -> bool:
        return any(a <= t < b for a, b in windows)

    finished = [r for r in records if r.finish_time > 0.0]
    met = sum(1 for r in finished if slo_met(r))
    degraded = [r for r in finished if in_window(r.finish_time)]
    nominal = [r for r in finished if not in_window(r.finish_time)]
    met_deg = sum(1 for r in degraded if slo_met(r))
    met_nom = met - met_deg
    healthy_s = max(0.0, horizon - degraded_s)

    return ResilienceReport(
        availability=availability,
        requests_total=len(records),
        requests_finished=len(finished),
        requests_dropped=len(records) - len(finished),
        requests_requeued=requeued,
        degraded_seconds=degraded_s,
        goodput_rps=met / horizon if horizon > 0 else 0.0,
        degraded_window_goodput_rps=(met_deg / degraded_s
                                     if degraded_s > 0 else 0.0),
        nominal_window_goodput_rps=(met_nom / healthy_s
                                    if healthy_s > 0 else 0.0),
        ttft_p95_degraded=p95([r.ttft for r in degraded]),
        ttft_p95_nominal=p95([r.ttft for r in nominal]),
        tpot_p95_degraded=p95([r.tpot for r in degraded
                               if r.gen_len > 1]),
        tpot_p95_nominal=p95([r.tpot for r in nominal
                              if r.gen_len > 1]),
        ensemble_size=1)


def aggregate_resilience(members: Sequence[ResilienceReport]
                         ) -> ResilienceReport:
    """Ensemble aggregate: counts SUM across members (total outcomes
    over the whole ensemble), rates/percentiles/availability are the
    MEAN (expected behaviour under one random fault draw)."""
    if not members:
        raise ValueError("cannot aggregate an empty ensemble")
    n = len(members)

    def mean(field: str) -> float:
        return sum(getattr(m, field) for m in members) / n

    def total(field: str) -> int:
        return sum(getattr(m, field) for m in members)

    return ResilienceReport(
        availability=mean("availability"),
        requests_total=total("requests_total"),
        requests_finished=total("requests_finished"),
        requests_dropped=total("requests_dropped"),
        requests_requeued=total("requests_requeued"),
        degraded_seconds=mean("degraded_seconds"),
        goodput_rps=mean("goodput_rps"),
        degraded_window_goodput_rps=mean("degraded_window_goodput_rps"),
        nominal_window_goodput_rps=mean("nominal_window_goodput_rps"),
        ttft_p95_degraded=mean("ttft_p95_degraded"),
        ttft_p95_nominal=mean("ttft_p95_nominal"),
        tpot_p95_degraded=mean("tpot_p95_degraded"),
        tpot_p95_nominal=mean("tpot_p95_nominal"),
        ensemble_size=sum(m.ensemble_size for m in members))


def attach_resilience(nominal, fault_reports):
    """A copy of the nominal ``SimulationReport`` carrying the ensemble-
    aggregated resilience of its faulted re-simulations — the report
    shape the ``degraded_goodput`` objective ranks (nominal fields for
    every other objective, faulted goodput for resilience)."""
    members = [r.resilience for r in fault_reports
               if r.resilience is not None]
    if not members:
        return nominal
    return dataclasses.replace(nominal,
                               resilience=aggregate_resilience(members))
