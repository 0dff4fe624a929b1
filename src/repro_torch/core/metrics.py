"""Serving metrics shared by every simulation path.

``SimulationReport`` is the per-plan outcome both the colocated and the
disaggregated simulators emit (so one objective ranks both families), and
``percentile`` is the rank-order estimator the paper's P95 numbers use.
Promoted out of ``simulator.py`` so the disagg subsystem no longer
imports private helpers or re-builds the infeasible report by hand.

Multi-tenant extension: every request record carries an ``SLOClass``
(core/trace.py), so a report also breaks TTFT/TPOT percentiles out per
class (``class_reports``) and measures **SLO goodput** — requests that
met their own class's TTFT/TPOT targets, per second of simulated time.
A class with no targets counts every finished request, so single-tenant
traces degrade to plain request throughput.  ``request_metrics`` is the
one place the latency/goodput block is computed, shared by both exact
simulators so the two families aggregate identically.

The port's copy of ``repro/core/metrics.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence


def percentile(xs: List[float], q: float) -> float:
    """Rank-order percentile (no interpolation): the smallest sample with
    at least ``q`` of the mass at or below it.  Returns 0.0 when empty."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(math.ceil(q * len(s))) - 1)]


def p50(xs: List[float]) -> float:
    return percentile(xs, 0.50)


def p95(xs: List[float]) -> float:
    return percentile(xs, 0.95)


def p99(xs: List[float]) -> float:
    return percentile(xs, 0.99)


def slo_met(rec) -> bool:
    """Did this finished request meet its own class's SLO targets?"""
    return rec.slo_class.met_by(rec.ttft, rec.tpot, rec.gen_len > 1)


@dataclasses.dataclass
class ClassReport:
    """One SLO class's slice of a simulation: latency percentiles over
    just its requests, and how many of them met the class targets."""

    name: str
    priority: int
    num_requests: int
    ttft_mean: float
    ttft_p50: float
    ttft_p95: float
    ttft_p99: float
    tpot_mean: float
    tpot_p50: float
    tpot_p95: float
    tpot_p99: float
    slo_met: int                  # requests meeting their class targets
    goodput_rps: float            # slo_met / simulated seconds

    def summary(self) -> str:
        return (f"[{self.name} p{self.priority}] n={self.num_requests} "
                f"TTFT p50/p95/p99="
                f"{self.ttft_p50 * 1e3:.0f}/{self.ttft_p95 * 1e3:.0f}/"
                f"{self.ttft_p99 * 1e3:.0f}ms "
                f"TPOT p50/p95/p99="
                f"{self.tpot_p50 * 1e3:.1f}/{self.tpot_p95 * 1e3:.1f}/"
                f"{self.tpot_p99 * 1e3:.1f}ms "
                f"SLO {self.slo_met}/{self.num_requests} "
                f"({self.goodput_rps:.2f} req/s)")


def per_class_reports(records: Sequence, total_time: float
                      ) -> List[ClassReport]:
    """Group records by SLO class (highest priority first, then name)."""
    groups: dict = {}
    for rec in records:
        groups.setdefault(rec.slo_class, []).append(rec)
    out: List[ClassReport] = []
    for slo in sorted(groups, key=lambda s: (-s.priority, s.name)):
        recs = groups[slo]
        ttfts = [r.ttft for r in recs]
        tpots = [r.tpot for r in recs if r.gen_len > 1]
        met = sum(1 for r in recs if slo_met(r))
        out.append(ClassReport(
            name=slo.name, priority=slo.priority, num_requests=len(recs),
            ttft_mean=sum(ttfts) / len(ttfts) if ttfts else 0.0,
            ttft_p50=p50(ttfts), ttft_p95=p95(ttfts), ttft_p99=p99(ttfts),
            tpot_mean=sum(tpots) / len(tpots) if tpots else 0.0,
            tpot_p50=p50(tpots), tpot_p95=p95(tpots), tpot_p99=p99(tpots),
            slo_met=met,
            goodput_rps=met / total_time if total_time > 0 else 0.0))
    return out


def request_metrics(records: Sequence, total_time: float) -> dict:
    """The latency/goodput block of a ``SimulationReport``, computed one
    way for every exact simulator (colocated and disagg ``**`` this dict
    into the report constructor)."""
    ttfts = [r.ttft for r in records]
    tpots = [r.tpot for r in records if r.gen_len > 1]
    e2es = [r.e2e for r in records]
    met = sum(1 for r in records if slo_met(r))
    return dict(
        ttft_mean=sum(ttfts) / len(ttfts) if ttfts else 0.0,
        ttft_p50=p50(ttfts), ttft_p95=p95(ttfts), ttft_p99=p99(ttfts),
        tpot_mean=sum(tpots) / len(tpots) if tpots else 0.0,
        tpot_p50=p50(tpots), tpot_p95=p95(tpots), tpot_p99=p99(tpots),
        latency_p95=p95(e2es),
        goodput_rps=met / total_time if total_time > 0 else 0.0,
        class_reports=per_class_reports(records, total_time))


@dataclasses.dataclass
class WindowReport:
    """One time window's slice of a simulation — the unit of the
    TTFT/TPOT/goodput *timeline* a non-stationary run is judged by.

    Arrivals are bucketed by arrival time; latency percentiles and
    goodput cover the requests that FINISHED inside the window (the
    service the operator observed during it).  Unfinished and
    admission-rejected requests appear in ``arrivals``/``rejected``
    only."""

    start: float
    end: float
    arrivals: int                 # requests arriving in [start, end)
    finished: int                 # requests finishing in [start, end)
    rejected: int                 # admission-control drops arriving here
    slo_met: int
    goodput_rps: float            # slo_met / window seconds
    ttft_mean: float
    ttft_p95: float
    tpot_p95: float
    arrival_rate: float           # arrivals / window seconds

    def summary(self) -> str:
        return (f"[{self.start:8.1f}-{self.end:8.1f}s] "
                f"in={self.arrivals} ({self.arrival_rate:.2f}/s) "
                f"out={self.finished} "
                f"TTFT p95={self.ttft_p95 * 1e3:.0f}ms "
                f"TPOT p95={self.tpot_p95 * 1e3:.1f}ms "
                f"goodput={self.goodput_rps:.2f}req/s"
                + (f" rejected={self.rejected}" if self.rejected else ""))


def windowed_metrics(records: Sequence, window_s: Optional[float] = None,
                     boundaries: Optional[Sequence[float]] = None,
                     horizon: Optional[float] = None) -> List[WindowReport]:
    """Slice a run's records into a per-window metric timeline.

    Pass EITHER ``window_s`` (uniform windows from 0) or explicit
    ``boundaries`` (window start times, first must be 0 — e.g. the epoch
    boundaries of a dynamic plan schedule).  ``horizon`` extends the
    last window's end (default: the latest arrival/finish observed).
    """
    if (window_s is None) == (boundaries is None):
        raise ValueError("pass exactly one of window_s / boundaries")
    last = max([max(r.arrival, r.finish_time) for r in records],
               default=0.0)
    horizon = max(horizon if horizon is not None else 0.0, last)
    if window_s is not None:
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        n = max(1, int(math.ceil(horizon / window_s - 1e-12)))
        edges = [i * window_s for i in range(n + 1)]
    else:
        edges = list(boundaries)
        if not edges or edges[0] != 0.0:
            raise ValueError(f"boundaries must start at 0, got {edges!r}")
        if any(b >= a for a, b in zip(edges[1:], edges)):
            raise ValueError(f"boundaries must be strictly increasing, "
                             f"got {edges!r}")
        edges.append(max(horizon, edges[-1] + 1e-9))
    out: List[WindowReport] = []
    for start, end in zip(edges, edges[1:]):
        is_last = end == edges[-1]
        arrived = [r for r in records
                   if start <= r.arrival and (r.arrival < end or is_last)]
        done = [r for r in records if r.finish_time > 0.0
                and start <= r.finish_time
                and (r.finish_time < end or is_last)]
        ttfts = [r.ttft for r in done]
        tpots = [r.tpot for r in done if r.gen_len > 1]
        met = sum(1 for r in done if slo_met(r))
        span = end - start
        out.append(WindowReport(
            start=start, end=end, arrivals=len(arrived),
            finished=len(done),
            rejected=sum(1 for r in arrived
                         if getattr(r, "rejected", False)),
            slo_met=met,
            goodput_rps=met / span if span > 0 else 0.0,
            ttft_mean=sum(ttfts) / len(ttfts) if ttfts else 0.0,
            ttft_p95=p95(ttfts), tpot_p95=p95(tpots),
            arrival_rate=len(arrived) / span if span > 0 else 0.0))
    return out


@dataclasses.dataclass
class ResilienceReport:
    """Outcome of one faulted run (or an ensemble aggregate) — what a
    plan's service looked like while the cluster was degraded.

    ``goodput_rps`` is the WHOLE faulted run's SLO goodput (the
    ``degraded_goodput`` search objective ranks on it: resilience is
    how much good service survives the fault draw, not only inside the
    outage windows); the window-split fields compare service during vs
    outside merged fault windows.  For an ensemble aggregate
    (``ensemble_size > 1``) counts are summed across members and
    rates/percentiles are member means.
    """

    availability: float           # 1 - down replica-seconds / total
    requests_total: int
    requests_finished: int
    requests_dropped: int         # never finished (e.g. stuck on a dead
                                  # replica with no survivor to take them)
    requests_requeued: int        # fault-induced KV losses re-queued
    degraded_seconds: float       # merged fault-window time
    goodput_rps: float            # SLO-met / s over the whole faulted run
    degraded_window_goodput_rps: float
    nominal_window_goodput_rps: float
    ttft_p95_degraded: float      # requests finishing inside fault windows
    ttft_p95_nominal: float
    tpot_p95_degraded: float
    tpot_p95_nominal: float
    ensemble_size: int = 1

    def summary(self) -> str:
        return (f"avail={self.availability:.3f} "
                f"goodput={self.goodput_rps:.2f}req/s "
                f"(degraded-window "
                f"{self.degraded_window_goodput_rps:.2f}, nominal "
                f"{self.nominal_window_goodput_rps:.2f}) "
                f"requeued={self.requests_requeued} "
                f"dropped={self.requests_dropped} "
                f"[x{self.ensemble_size}]")


@dataclasses.dataclass
class SimulationReport:
    """Per-plan simulation outcome (the paper's 'comprehensive evaluation')."""

    plan_label: str
    e2e_latency: float            # seconds to drain the trace
    total_energy: float           # joules across the whole cluster
    ttft_mean: float
    ttft_p95: float
    tpot_mean: float
    tpot_p95: float
    latency_p95: float            # per-request e2e P95
    throughput_tok_s: float
    mfu: float
    mbu: float
    iterations: int
    preemptions: int              # total evictions (sacrifices + swaps)
    peak_kv_tokens: int
    peak_batch: int
    feasible: bool = True
    records: Optional[list] = None
    # latency tails beyond the paper's p95
    ttft_p50: float = 0.0
    ttft_p99: float = 0.0
    tpot_p50: float = 0.0
    tpot_p99: float = 0.0
    # preemption-mechanism split: sacrifices recompute, swaps round-trip
    # the KV over the host link (kv_swap_s) — distinguishable in output
    swap_outs: int = 0
    swap_ins: int = 0
    kv_swap_s: float = 0.0
    kv_refetch_s: float = 0.0     # disagg decode re-fetch delay total
    # multi-tenant SLO outcome
    goodput_rps: float = 0.0      # requests meeting their class SLO / s
    class_reports: Optional[List[ClassReport]] = None
    # fault-injection outcome: set only when the run (or an ensemble of
    # re-simulations) carried a non-empty FaultSchedule
    resilience: Optional[ResilienceReport] = None
    # memory-threshold admission control (BatchingPolicy.admission_*)
    admission_rejected: int = 0   # requests dropped at the watermark
    admission_deferred: int = 0   # unique requests held at the watermark
    # per-window metric timeline (simulate(window_s=...) or a dynamic
    # run's epoch boundaries) — list of WindowReport
    windows: Optional[List[WindowReport]] = None
    # epoch-gated re-planning outcome (core/dynamic.ReconfigReport):
    # itemized reconfiguration cost of a dynamic plan schedule
    reconfig: Optional[object] = None

    @classmethod
    def infeasible(cls, plan_label: str) -> "SimulationReport":
        """The canonical 'this plan cannot run' report (ranked last by
        every minimizing objective)."""
        return cls(
            plan_label=plan_label, e2e_latency=float("inf"),
            total_energy=float("inf"), ttft_mean=0, ttft_p95=0,
            tpot_mean=0, tpot_p95=0, latency_p95=0, throughput_tok_s=0,
            mfu=0, mbu=0, iterations=0, preemptions=0, peak_kv_tokens=0,
            peak_batch=0, feasible=False)

    @property
    def sacrifices(self) -> int:
        """Evictions served by recompute (preemptions minus swap-outs)."""
        return self.preemptions - self.swap_outs

    def summary(self) -> str:
        line = (f"{self.plan_label}: e2e={self.e2e_latency:.2f}s "
                f"energy={self.total_energy / 1e3:.2f}kJ "
                f"TTFT={self.ttft_mean * 1e3:.1f}ms "
                f"TPOT={self.tpot_mean * 1e3:.2f}ms "
                f"MFU={self.mfu:.2%} MBU={self.mbu:.2%} "
                f"preempt={self.preemptions}")
        if self.swap_outs:
            line += (f" (swap={self.swap_outs}, "
                     f"{self.kv_swap_s:.2f}s on host link)")
        if self.kv_refetch_s > 0:
            line += f" refetch={self.kv_refetch_s:.2f}s"
        if self.goodput_rps > 0:
            line += f" goodput={self.goodput_rps:.2f}req/s"
        if self.admission_rejected or self.admission_deferred:
            line += (f" admission(rej={self.admission_rejected}, "
                     f"defer={self.admission_deferred})")
        return line

    def __str__(self) -> str:
        if not self.feasible:
            return f"{self.plan_label}: INFEASIBLE"
        lines = [self.summary(),
                 (f"  TTFT p50/p95/p99 = {self.ttft_p50 * 1e3:.1f}/"
                  f"{self.ttft_p95 * 1e3:.1f}/{self.ttft_p99 * 1e3:.1f} ms"),
                 (f"  TPOT p50/p95/p99 = {self.tpot_p50 * 1e3:.2f}/"
                  f"{self.tpot_p95 * 1e3:.2f}/{self.tpot_p99 * 1e3:.2f} ms")]
        for cr in self.class_reports or ():
            lines.append("  " + cr.summary())
        if self.resilience is not None:
            lines.append("  resilience: " + self.resilience.summary())
        if self.reconfig is not None:
            lines.append("  reconfig: " + self.reconfig.summary())
        for w in self.windows or ():
            lines.append("  " + w.summary())
        return "\n".join(lines)
