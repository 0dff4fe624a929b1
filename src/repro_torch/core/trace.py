"""Request traces (paper §3.3, §4.1 Table 1) and multi-tenant SLO classes.

A request = (arrival time, context length, generation length).  The paper
derives three traces from public datasets; offline, we synthesize traces
matched to Table 1's first two moments with Poisson arrivals (the paper's
own arrival model, §4.1):

    Summarization : ctx 2742.11 +/- 944.33, gen  172.22 +/-  73.17, n=1188
    Creation      : ctx  306.82 +/-  81.03, gen 1128.34 +/- 419.64, n=512
    Chat          : ctx   73.32 +/- 148.65, gen  189.47 +/- 174.18, n=1024

Lengths are drawn from a log-normal fitted to (mu, sigma) — positive,
right-skewed, like real LLM traffic — then clamped to [1, max_len].
Generators are seeded and deterministic.

Multi-tenant traffic: every request carries an ``SLOClass`` — a named
tenant class with a scheduling priority and optional TTFT/TPOT targets.
``synthesize_mixed_trace`` merges independently-seeded per-class Poisson
streams (e.g. latency-sensitive chat sharing a deployment with batchy
summarization) into one trace; the engine's preemption policies and the
``"goodput"`` search objective (requests meeting their class SLO per
second) read the class off each request.  Single-class traces default to
``DEFAULT_SLO`` (priority 0, no targets), which keeps every legacy code
path byte-identical.

The port's copy of ``repro/core/trace.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One tenant class: a name, a scheduling priority (higher = more
    important — preemption policies evict lower priorities first), and
    optional latency targets (None = unconstrained on that metric)."""

    name: str = "default"
    priority: int = 0
    ttft_target_s: Optional[float] = None
    tpot_target_s: Optional[float] = None

    def met_by(self, ttft: float, tpot: float, has_decode: bool) -> bool:
        """Does a request with these measured latencies meet the SLO?"""
        if self.ttft_target_s is not None and ttft > self.ttft_target_s:
            return False
        if (self.tpot_target_s is not None and has_decode
                and tpot > self.tpot_target_s):
            return False
        return True


DEFAULT_SLO = SLOClass()


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    arrival: float            # seconds
    context_len: int          # prompt tokens
    gen_len: int              # output tokens to produce
    source_len: int = 0       # encoder-side tokens (enc-dec models only)
    slo_class: SLOClass = DEFAULT_SLO


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    ctx_mean: float
    ctx_std: float
    gen_mean: float
    gen_std: float
    num_requests: int


TRACE_SPECS = {
    "summarization": TraceSpec("summarization", 2742.11, 944.33,
                               172.22, 73.17, 1188),
    "creation": TraceSpec("creation", 306.82, 81.03, 1128.34, 419.64, 512),
    "chat": TraceSpec("chat", 73.32, 148.65, 189.47, 174.18, 1024),
}


def _lognormal_params(mean: float, std: float) -> tuple:
    """(mu, sigma) of a log-normal with the given mean/std."""
    var = std * std
    sigma2 = math.log(1.0 + var / (mean * mean))
    mu = math.log(mean) - sigma2 / 2.0
    return mu, math.sqrt(sigma2)


class _GeneratorDraws:
    """Adapts a ``numpy.random.Generator`` to the two draw methods the
    synthesizer uses, so parallel search workers can regenerate
    byte-identical traces: ``numpy.random.default_rng(seed)`` is a
    deterministic function of the seed in every process, with none of
    the cross-process state a shared module-level RNG would have."""

    def __init__(self, gen):
        self.gen = gen

    def expovariate(self, rate: float) -> float:
        return float(self.gen.exponential(1.0 / rate))

    def lognormvariate(self, mu: float, sigma: float) -> float:
        return float(self.gen.lognormal(mu, sigma))

    def random(self) -> float:
        return float(self.gen.random())


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

class ArrivalProcess:
    """A (possibly non-stationary) arrival-time process.

    ``iter_arrivals(rng)`` yields absolute arrival times, drawing from
    ``rng`` lazily — exactly one draw sequence per arrival — so a
    seeded generator produces the same trace in every process.  Every
    rate-accepting entry point (``synthesize_trace``, ``get_trace``,
    ``ClassTraffic``, ``mixed_trace``) takes an ``ArrivalProcess`` in
    place of the legacy float rate; a bare float means
    ``ConstantRate(rate)``, whose draw sequence is byte-identical to
    the pre-process code path (golden-pinned).
    """

    #: True for processes whose rate never varies in time.
    stationary: bool = False

    def iter_arrivals(self, rng):
        raise NotImplementedError

    def rate_at(self, t: float) -> float:
        """Instantaneous (or, for doubly-stochastic processes, mean)
        arrival rate at absolute time ``t``."""
        raise NotImplementedError

    def peak_rate(self) -> float:
        """An upper bound on the instantaneous rate (thinning bound /
        conservative capacity-planning rate)."""
        raise NotImplementedError

    def mean_rate(self, horizon_s: float) -> float:
        """Time-averaged rate over ``[0, horizon_s]``."""
        if horizon_s <= 0:
            raise ValueError(f"horizon must be positive, got {horizon_s}")
        k = 256
        dt = horizon_s / k
        return sum(self.rate_at((i + 0.5) * dt) for i in range(k)) / k


@dataclasses.dataclass(frozen=True)
class ConstantRate(ArrivalProcess):
    """Stationary Poisson arrivals — the legacy model, bit-identical."""

    rate: float
    stationary = True

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(
                f"arrival_rate must be positive, got {self.rate}")

    def iter_arrivals(self, rng):
        t = 0.0
        while True:
            t += rng.expovariate(self.rate)
            yield t

    def rate_at(self, t: float) -> float:
        return self.rate

    def peak_rate(self) -> float:
        return self.rate

    def mean_rate(self, horizon_s: float) -> float:
        return self.rate


@dataclasses.dataclass(frozen=True)
class PiecewiseRate(ArrivalProcess):
    """Piecewise-constant rate: ``rates[i]`` req/s from ``starts[i]``
    until ``starts[i+1]``; the last rate holds forever.  Arrivals are
    drawn by exact hazard inversion (one unit-exponential draw per
    arrival — no thinning, no discretization), so the draw count is
    deterministic and seeded traces replay bit-identically."""

    starts: Tuple[float, ...]
    rates: Tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "starts", tuple(self.starts))
        object.__setattr__(self, "rates", tuple(self.rates))
        if not self.starts or len(self.starts) != len(self.rates):
            raise ValueError("starts and rates must be equal-length and "
                             f"non-empty, got {len(self.starts)} starts / "
                             f"{len(self.rates)} rates")
        if self.starts[0] != 0.0:
            raise ValueError(f"first segment must start at 0, "
                             f"got {self.starts[0]}")
        if any(b >= a for a, b in zip(self.starts[1:], self.starts)):
            raise ValueError(f"segment starts must be strictly increasing, "
                             f"got {self.starts}")
        if any(r < 0 for r in self.rates):
            raise ValueError(f"rates must be non-negative, got {self.rates}")
        if self.rates[-1] <= 0:
            raise ValueError("final segment rate must be positive (it "
                             "holds forever and must eventually produce "
                             f"each arrival), got {self.rates[-1]}")

    def iter_arrivals(self, rng):
        t = 0.0
        idx = 0
        while True:
            e = rng.expovariate(1.0)     # unit-exponential hazard target
            while True:
                rate = self.rates[idx]
                end = self.starts[idx + 1] \
                    if idx + 1 < len(self.starts) else math.inf
                if rate > 0:
                    dt = e / rate
                    if t + dt <= end:
                        t += dt
                        break
                    e -= (end - t) * rate
                t = end
                idx += 1
            yield t

    def rate_at(self, t: float) -> float:
        return self.rates[max(0, bisect.bisect_right(self.starts, t) - 1)]

    def peak_rate(self) -> float:
        return max(self.rates)


@dataclasses.dataclass(frozen=True)
class DiurnalRate(ArrivalProcess):
    """Sinusoidal diurnal swing:
    ``rate(t) = base * (1 + amplitude * sin(2*pi*(t - phase)/period))``.
    Drawn by Lewis–Shedler thinning against the peak-rate bound — one
    exponential + one uniform draw per proposal."""

    base_rate: float
    amplitude: float = 0.5
    period_s: float = 86400.0
    phase_s: float = 0.0

    def __post_init__(self):
        if self.base_rate <= 0:
            raise ValueError(
                f"base_rate must be positive, got {self.base_rate}")
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1], got {self.amplitude}")
        if self.period_s <= 0:
            raise ValueError(
                f"period_s must be positive, got {self.period_s}")

    def iter_arrivals(self, rng):
        bound = self.base_rate * (1.0 + self.amplitude)
        t = 0.0
        while True:
            t += rng.expovariate(bound)
            if rng.random() * bound <= self.rate_at(t):
                yield t

    def rate_at(self, t: float) -> float:
        return self.base_rate * (1.0 + self.amplitude * math.sin(
            2.0 * math.pi * (t - self.phase_s) / self.period_s))

    def peak_rate(self) -> float:
        return self.base_rate * (1.0 + self.amplitude)

    def mean_rate(self, horizon_s: float) -> float:
        if horizon_s <= 0:
            raise ValueError(f"horizon must be positive, got {horizon_s}")
        # exact: integral of base*(1 + a*sin(...)) has closed form
        w = 2.0 * math.pi / self.period_s
        integral = self.base_rate * (
            horizon_s + (self.amplitude / w)
            * (math.cos(-w * self.phase_s)
               - math.cos(w * (horizon_s - self.phase_s))))
        return integral / horizon_s


@dataclasses.dataclass(frozen=True)
class BurstProcess(ArrivalProcess):
    """MMPP-style on/off bursts: a two-phase Markov-modulated Poisson
    process alternating between a quiet phase at ``base_rate`` and a
    burst phase at ``burst_rate``, with exponentially-distributed phase
    holding times.  Arrivals inside each phase are drawn by exact
    hazard inversion, with phase-transition draws interleaved
    deterministically, so seeded traces replay bit-identically."""

    base_rate: float
    burst_rate: float
    mean_burst_s: float
    mean_gap_s: float
    start_in_burst: bool = False

    def __post_init__(self):
        if self.base_rate < 0:
            raise ValueError(
                f"base_rate must be non-negative, got {self.base_rate}")
        if self.burst_rate <= 0:
            raise ValueError(
                f"burst_rate must be positive, got {self.burst_rate}")
        if self.burst_rate < self.base_rate:
            raise ValueError(
                f"burst_rate ({self.burst_rate}) must be >= base_rate "
                f"({self.base_rate})")
        if self.mean_burst_s <= 0 or self.mean_gap_s <= 0:
            raise ValueError(
                f"phase means must be positive, got burst="
                f"{self.mean_burst_s} gap={self.mean_gap_s}")

    def _hold(self, in_burst: bool) -> float:
        return self.mean_burst_s if in_burst else self.mean_gap_s

    def iter_arrivals(self, rng):
        t = 0.0
        in_burst = self.start_in_burst
        phase_end = t + rng.expovariate(1.0 / self._hold(in_burst))
        while True:
            e = rng.expovariate(1.0)
            while True:
                rate = self.burst_rate if in_burst else self.base_rate
                if rate > 0:
                    dt = e / rate
                    if t + dt <= phase_end:
                        t += dt
                        break
                    e -= (phase_end - t) * rate
                t = phase_end
                in_burst = not in_burst
                phase_end = t + rng.expovariate(1.0 / self._hold(in_burst))
            yield t

    def rate_at(self, t: float) -> float:
        """The duty-cycled MEAN rate — the modulating phase chain is
        part of the random draw, so the realized instantaneous rate is
        not a function of ``t`` alone."""
        total = self.mean_burst_s + self.mean_gap_s
        return (self.burst_rate * self.mean_burst_s
                + self.base_rate * self.mean_gap_s) / total

    def peak_rate(self) -> float:
        return self.burst_rate

    def mean_rate(self, horizon_s: float) -> float:
        return self.rate_at(0.0)


RateLike = Union[float, int, ArrivalProcess]


def as_arrival_process(rate: RateLike) -> ArrivalProcess:
    """Coerce a float rate (legacy API) or pass through a process."""
    if isinstance(rate, ArrivalProcess):
        return rate
    if not isinstance(rate, (int, float)) or isinstance(rate, bool):
        raise TypeError(f"arrival_rate must be a positive number or an "
                        f"ArrivalProcess, got {rate!r}")
    return ConstantRate(float(rate))


def synthesize_trace(spec: TraceSpec, arrival_rate: RateLike,
                     seed: int = 0, num_requests: Optional[int] = None,
                     max_len: int = 131072, source_len: int = 0,
                     rng=None, slo_class: SLOClass = DEFAULT_SLO
                     ) -> List[Request]:
    """Arrivals from ``arrival_rate`` (a req/s float = stationary
    Poisson, or any ``ArrivalProcess``), log-normal lengths.

    ``rng`` overrides the default seeded ``random.Random``: pass either a
    ``random.Random`` or an explicit ``numpy.random.Generator`` (adapted
    transparently).  Two calls with equal-state generators produce
    byte-identical traces — the determinism contract parallel search
    workers (``jobs=N``) rely on when each regenerates its own copy.
    The default path is unchanged (same draws as before): a float rate
    routes through ``ConstantRate``, whose per-arrival draw sequence is
    identical to the legacy inline loop (golden-pinned).

    ``slo_class`` tags every request with one tenant class (see
    ``synthesize_mixed_trace`` for multi-class traffic).

    Raises ``ValueError`` on non-positive ``arrival_rate`` or
    ``num_requests`` instead of silently emitting degenerate traces.
    """
    process = as_arrival_process(arrival_rate)
    if num_requests is not None and num_requests <= 0:
        raise ValueError(
            f"num_requests must be positive, got {num_requests}")
    if rng is None:
        rng = random.Random(seed)
    elif not hasattr(rng, "expovariate"):
        rng = _GeneratorDraws(rng)       # numpy Generator
    n = spec.num_requests if num_requests is None else num_requests
    if n <= 0:
        raise ValueError(f"trace spec {spec.name!r} has non-positive "
                         f"num_requests {n}")
    cmu, csig = _lognormal_params(spec.ctx_mean, spec.ctx_std)
    gmu, gsig = _lognormal_params(spec.gen_mean, spec.gen_std)
    out: List[Request] = []
    arrivals = process.iter_arrivals(rng)
    for i in range(n):
        t = next(arrivals)
        ctx = max(1, min(max_len, int(round(rng.lognormvariate(cmu, csig)))))
        gen = max(1, min(max_len, int(round(rng.lognormvariate(gmu, gsig)))))
        out.append(Request(rid=i, arrival=t, context_len=ctx, gen_len=gen,
                           source_len=source_len, slo_class=slo_class))
    return out


def get_trace(name: str, arrival_rate: RateLike = 0.5, seed: int = 0,
              num_requests: Optional[int] = None,
              source_len: int = 0, rng=None,
              slo_class: SLOClass = DEFAULT_SLO) -> List[Request]:
    if name not in TRACE_SPECS:
        raise KeyError(f"unknown trace {name!r}; known: {sorted(TRACE_SPECS)}")
    return synthesize_trace(TRACE_SPECS[name], arrival_rate, seed=seed,
                            num_requests=num_requests, source_len=source_len,
                            rng=rng, slo_class=slo_class)


# ---------------------------------------------------------------------------
# multi-tenant traffic
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassTraffic:
    """One tenant class's share of a mixed trace: which length
    distribution it draws from, how fast it arrives, and its SLO."""

    spec: TraceSpec
    arrival_rate: RateLike         # this class's own rate or ArrivalProcess
    slo: SLOClass
    num_requests: Optional[int] = None
    source_len: int = 0


def synthesize_mixed_trace(components: Sequence[ClassTraffic],
                           seed: int = 0, max_len: int = 131072
                           ) -> List[Request]:
    """Merge independently-seeded per-class arrival streams into one
    trace (e.g. chat + summarization sharing a deployment).  Each
    component's ``arrival_rate`` may be a float (stationary Poisson) or
    any ``ArrivalProcess`` (e.g. a diurnal chat class over a piecewise
    batch class).

    Each component draws from its own sub-seeded generator
    (``seed + 1000 * index``) so adding or re-ordering classes never
    perturbs another class's draws; the merged trace is sorted by
    arrival (ties by class order) and re-numbered with contiguous rids.

    Raises ``ValueError`` on an empty ``components`` sequence.
    """
    if not components:
        raise ValueError("components must be a non-empty sequence of "
                         "ClassTraffic")
    streams: List[List[Request]] = []
    for k, comp in enumerate(components):
        streams.append(synthesize_trace(
            comp.spec, comp.arrival_rate, seed=seed + 1000 * k,
            num_requests=comp.num_requests, max_len=max_len,
            source_len=comp.source_len, slo_class=comp.slo))
    merged = sorted(((r, k) for k, s in enumerate(streams) for r in s),
                    key=lambda rk: (rk[0].arrival, rk[1], rk[0].rid))
    return [dataclasses.replace(r, rid=i) for i, (r, _) in enumerate(merged)]


def mixed_trace(components: Sequence[tuple], seed: int = 0,
                max_len: int = 131072) -> List[Request]:
    """Convenience front for ``synthesize_mixed_trace``: each component
    is ``(trace_name, arrival_rate, slo_class[, num_requests])``, where
    ``arrival_rate`` is a float or any ``ArrivalProcess``."""
    if not components:
        raise ValueError("components must be a non-empty sequence")
    parts = []
    for comp in components:
        name, rate, slo = comp[0], comp[1], comp[2]
        n = comp[3] if len(comp) > 3 else None
        if name not in TRACE_SPECS:
            raise KeyError(
                f"unknown trace {name!r}; known: {sorted(TRACE_SPECS)}")
        parts.append(ClassTraffic(TRACE_SPECS[name], rate, slo,
                                  num_requests=n))
    return synthesize_mixed_trace(parts, seed=seed, max_len=max_len)


def retag_slo(requests: Sequence[Request],
              slo_classes: Union[None, Dict[str, SLOClass],
                                 Sequence[SLOClass]]) -> List[Request]:
    """Re-attach SLO classes to a trace by class NAME.

    ``slo_classes`` maps class names to replacement ``SLOClass`` objects
    (a sequence is keyed by each class's own name).  Requests whose class
    name has no entry keep their class; ``None`` is a no-op returning the
    input unchanged — the single-tenant fast path.  This is the
    ``slo_classes=`` plumbing ``simulate()``/``search()`` expose: traces
    synthesized with bare class names can have targets attached at
    evaluation time without regenerating the trace.
    """
    if slo_classes is None:
        return list(requests) if not isinstance(requests, list) else requests
    if not isinstance(slo_classes, dict):
        slo_classes = {c.name: c for c in slo_classes}
    return [dataclasses.replace(r, slo_class=slo_classes[r.slo_class.name])
            if r.slo_class.name in slo_classes else r
            for r in requests]


def prefix_trace(requests: Sequence[Request], fraction: float,
                 presorted: bool = False) -> List[Request]:
    """The first ``ceil(fraction * n)`` requests of a trace, by arrival.

    Used by successive-halving rungs (``core/multifid.py``): a short
    prefix of the trace is a cheap but *exact* fidelity level.  The
    prefix is taken by COUNT with arrival times kept absolute, because
    the first k arrivals of a Poisson process are themselves a Poisson
    process observed over a shorter window — rate, length distributions
    and SLO-class mix are preserved in expectation, so rung rankings are
    unbiased estimates of the full-trace ranking.  Ties on arrival break
    by ``rid`` so the prefix is deterministic.  ``fraction >= 1`` returns
    the (sorted) full trace; ``presorted`` skips the sort when the caller
    already ordered by ``(arrival, rid)``.
    """
    if fraction <= 0:
        raise ValueError(f"prefix fraction must be positive, got {fraction}")
    ordered = list(requests) if presorted else \
        sorted(requests, key=lambda r: (r.arrival, r.rid))
    if fraction >= 1.0:
        return ordered
    k = max(1, math.ceil(len(ordered) * fraction))
    return ordered[:k]


def trace_stats(reqs: List[Request]) -> dict:
    n = len(reqs)
    cm = sum(r.context_len for r in reqs) / n
    gm = sum(r.gen_len for r in reqs) / n
    cv = math.sqrt(sum((r.context_len - cm) ** 2 for r in reqs) / n)
    gv = math.sqrt(sum((r.gen_len - gm) ** 2 for r in reqs) / n)
    return {"n": n, "ctx_mean": cm, "ctx_std": cv, "gen_mean": gm,
            "gen_std": gv, "span_s": reqs[-1].arrival if reqs else 0.0}
