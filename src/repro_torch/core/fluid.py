"""Fluid-limit surrogate of the batching dynamics — plans in microseconds.

The exact event engine (core/engine.py) prices every iteration of every
replica; at ~tens of plans per second it is the scaling bottleneck of
plan search (BENCH_core.json).  This module scores a plan by integrating
the *fluid limit* of the same dynamics instead: the discrete request
population is replaced by coupled ordinary differential equations for

    Q(t)  — requests waiting for admission,
    P(t)  — admitted requests still prefilling,
    N(t)  — requests decoding (the running batch),
    M(t)  — KV-token occupancy, carried implicitly as N x (mean ctx +
            half the mean generation): the admission cap ``B_cap`` is the
            KV capacity divided by that per-request footprint, so memory
            gates admission exactly as the engine's greedy rule does in
            expectation,

driven by the SAME per-step cost model the engine uses: a handful of
``PlanSimulator.iteration_cost`` probes (one mean-prompt prefill, two
decode batches) anchor the service rates, so the surrogate and the
engine disagree only on stochastic fine structure (bursts, preemption,
discreteness), never on the cost of an iteration.  Three probes plus a
~hundred-step Euler integration come to a few hundred microseconds per
plan — two to three orders of magnitude faster than exact simulation.

Disaggregated plans integrate BOTH pools and the cross-pool KV wire in
one coupled system: the prefill pool's completion flux feeds a link
stage with service rate 1/wire_s (the ``SharedLink`` FIFO's fluid
limit), whose output is the decode pool's arrival process — the transfer
rate is the coupling term joining the two pools' ODEs.

The surrogate returns a ``SimulationReport`` so every search objective
(latency, energy, ttft, tpot, throughput) ranks fluid and exact reports
through one code path.  Fidelity caveats (all second-order for ranking):
percentiles are dispersion-scaled means, preemption/re-fetch churn is
not modeled (admission respects the same KV cap instead), and chunked
prefill is treated as contiguous.  ``MultiFidelitySearch``
(core/multifid.py) uses these scores only to pick a survivor frontier;
the exact engine confirms the winners.

The port's copy of ``repro/core/fluid.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from .batching import BatchingPolicy
from .engine import SharedCostStore, StepCostCache
from .ir import Workload
from .mapper import ExecutionPlan
from .metrics import ClassReport, SimulationReport, percentile
from .profiles import CollectiveModel, ProfileStore
from .simulator import PlanSimulator
from .trace import DEFAULT_SLO, Request, SLOClass, prefix_trace, retag_slo

# engine Pool default — the surrogate's sequence-slot cap must match
_MAX_SEQUENCES = 512


@dataclasses.dataclass(frozen=True)
class ClassSummary:
    """One SLO class's slice of a trace summary: its population and its
    own length moments, so multi-tenant screening does not collapse the
    mix into one aggregate distribution."""

    slo: SLOClass
    n: int
    ctx_mean: float
    gen_mean: float
    ctx_p95: float
    gen_p95: float


@dataclasses.dataclass(frozen=True)
class TraceSummary:
    """First/second-moment summary of a request trace — the fluid model's
    entire view of the workload (computed once per search, shared by
    every candidate's surrogate evaluation)."""

    n: int
    span_s: float             # last arrival time
    arrival_rate: float       # req/s over the arrival window
    ctx_mean: float
    gen_mean: float
    ctx_p95: float
    gen_p95: float
    source_mean: float = 0.0  # encoder-side tokens (enc-dec models)
    # per-SLO-class populations (highest priority first); empty means
    # treat the whole trace as one DEFAULT_SLO class
    classes: tuple = ()
    # stationarity diagnostics over 4 equal arrival windows: the max
    # per-window deviation from the uniform share in Poisson standard
    # errors (z ~ <2 for a stationary trace; diurnal/burst traces score
    # far higher), and the busiest window's arrival rate.  The fluid
    # model assumes ONE arrival rate, so a high score means the
    # surrogate is screening a workload it cannot represent —
    # ``MultiFidelitySearch`` refuses or falls back to ``peak_rate``.
    nonstationarity: float = 0.0
    peak_rate: float = 0.0

    @classmethod
    def of(cls, requests: Sequence[Request]) -> "TraceSummary":
        n = len(requests)
        if n == 0:
            return cls(0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0)
        span = max(r.arrival for r in requests)
        ctxs = [r.context_len for r in requests]
        gens = [r.gen_len for r in requests]
        groups: dict = {}
        for r in requests:
            groups.setdefault(r.slo_class, []).append(r)
        classes = []
        for slo in sorted(groups, key=lambda s: (-s.priority, s.name)):
            rs = groups[slo]
            k = len(rs)
            classes.append(ClassSummary(
                slo=slo, n=k,
                ctx_mean=sum(r.context_len for r in rs) / k,
                gen_mean=sum(r.gen_len for r in rs) / k,
                ctx_p95=float(percentile(
                    [float(r.context_len) for r in rs], 0.95)),
                gen_p95=float(percentile(
                    [float(r.gen_len) for r in rs], 0.95))))
        z = 0.0
        peak = n / span if span > 0 else float("inf")
        if span > 0 and n >= 8:
            win = span / 4.0
            counts = [0] * 4
            for r in requests:
                counts[min(int(r.arrival / win), 3)] += 1
            m = n / 4.0
            z = max(abs(c - m) for c in counts) / math.sqrt(m)
            peak = max(counts) / win
        return cls(
            n=n, span_s=span,
            arrival_rate=n / span if span > 0 else float("inf"),
            ctx_mean=sum(ctxs) / n, gen_mean=sum(gens) / n,
            ctx_p95=float(percentile([float(c) for c in ctxs], 0.95)),
            gen_p95=float(percentile([float(g) for g in gens], 0.95)),
            source_mean=sum(r.source_len for r in requests) / n,
            classes=tuple(classes),
            nonstationarity=z, peak_rate=peak)

    @classmethod
    def of_prefixes(cls, requests: Sequence[Request],
                    fractions: Sequence[float]) -> dict:
        """Summaries of count-prefixes of ``requests``: maps each fraction
        in ``fractions`` (plus 1.0, the full trace) to the summary of the
        first ``ceil(f * n)`` requests by arrival, sharing one sort.

        The first k arrivals of a Poisson process are themselves a Poisson
        sample over a shorter window (arrival times kept absolute — see
        ``trace.prefix_trace``), so prefix summaries preserve the
        arrival-rate and length statistics the fluid model and the
        halving rungs consume.
        """
        ordered = sorted(requests, key=lambda r: (r.arrival, r.rid))
        out = {}
        for f in set(fractions) | {1.0}:
            out[f] = cls.of(prefix_trace(ordered, f, presorted=True))
        return out


@dataclasses.dataclass
class _PoolRates:
    """One pool's fluid-rate anchors, probed from its cost model."""

    t_pre: float              # seconds to prefill one mean prompt
    e_pre: float              # energy of that prefill iteration
    td0: float                # decode iteration time ~ td0 + td1 * B
    td1: float
    ed0: float                # decode iteration energy ~ ed0 + ed1 * B
    ed1: float
    b_cap: float              # per-replica running cap (KV/slots/batch)
    dp: int                   # replicas

    def t_dec(self, b: float) -> float:
        return max(1e-12, self.td0 + self.td1 * b)

    def e_dec(self, b: float) -> float:
        return max(0.0, self.ed0 + self.ed1 * b)


def _probe_rates(sim: PlanSimulator, cache: StepCostCache,
                 ts: TraceSummary, capacity: int, dp: int,
                 policy: BatchingPolicy,
                 decode_only: bool = False) -> _PoolRates:
    """Anchor one pool's fluid rates with three cost-model probes: one
    mean-prompt prefill and two decode batches (B=1 and B=cap) whose
    linear fit prices any fractional fluid batch."""
    windows = sim.windows
    is_encdec = sim.scheme.model.encoder is not None
    src = int(round(ts.source_mean)) if is_encdec else 0
    c = max(1, int(round(ts.ctx_mean)))
    g = max(1.0, ts.gen_mean)
    kv = max(1, int(round(ts.ctx_mean + ts.gen_mean / 2.0)))

    # per-replica running cap: KV footprint, sequence slots, batch knob,
    # and the trace's own max concurrency; >= 1 (engine liveness: an
    # idle replica always admits its head request)
    b_kv = capacity / float(kv)
    b_cap = min(b_kv, float(_MAX_SEQUENCES),
                float(policy.max_batch_size or _MAX_SEQUENCES),
                max(1.0, ts.n / float(dp)))
    b_cap = max(1.0, b_cap)

    w_pre = Workload.from_batch(
        [(c, c)], [], windows, batch_sequences=1,
        encoder_tokens=src if not decode_only else 0,
        prefill_source=[src] if is_encdec else ())
    t_pre, e_pre, _ = cache.cost(w_pre)

    b_hi = max(2, int(min(b_cap, 4096.0)))
    dec_src = ([src] if is_encdec else [])

    def dec_probe(b: int) -> Tuple[float, float]:
        w = Workload.from_batch([], [kv] * b, windows, batch_sequences=b,
                                decode_source=dec_src * b)
        t, e, _ = cache.cost(w)
        return t, e

    t1, e1 = dec_probe(1)
    t2, e2 = dec_probe(b_hi)
    td1 = (t2 - t1) / (b_hi - 1)
    ed1 = (e2 - e1) / (b_hi - 1)
    return _PoolRates(t_pre=max(t_pre, 1e-12), e_pre=e_pre,
                      td0=t1 - td1, td1=td1, ed0=e1 - ed1, ed1=ed1,
                      b_cap=b_cap, dp=dp)


def _attained_fraction(mean: float, p95v: float,
                       target: Optional[float]) -> float:
    """Fraction of requests under ``target`` given the surrogate's
    (mean, p95) dispersion pair: 0.5 of the mass sits at or below the
    mean, 0.95 at or below p95, linear between — a two-point CDF sketch,
    enough to rank plans by goodput, not a tail model."""
    if target is None:
        return 1.0
    if target <= 0.0:
        return 0.0
    if mean <= 0.0 or (target >= p95v and target >= mean):
        return 1.0
    if target <= mean:
        return min(1.0, 0.5 * target / mean)
    return min(1.0, 0.5 + 0.45 * (target - mean) / max(p95v - mean, 1e-12))


def _class_goodput(ts: TraceSummary, wait: float, t_pre: float,
                   tpot: float, drain_s: float) -> tuple:
    """(goodput_rps, class_reports) from the fluid means, split per SLO
    class: every class shares the queueing wait and decode pacing, but
    pays prefill service proportional to its OWN mean prompt, and its
    TTFT dispersion comes from its own length spread — so a latency-tight
    chat class is not judged by a batchy summarization class's tails."""
    classes = ts.classes or (ClassSummary(
        DEFAULT_SLO, ts.n, ts.ctx_mean, ts.gen_mean,
        ts.ctx_p95, ts.gen_p95),)
    met_total = 0.0
    reports = []
    for c in classes:
        scale = c.ctx_mean / ts.ctx_mean if ts.ctx_mean > 0 else 1.0
        ttft_c = wait + t_pre * scale
        disp_c = c.ctx_p95 / c.ctx_mean if c.ctx_mean > 0 else 1.0
        ttft_p95_c = ttft_c * disp_c
        frac = (_attained_fraction(ttft_c, ttft_p95_c,
                                   c.slo.ttft_target_s)
                * _attained_fraction(tpot, tpot, c.slo.tpot_target_s))
        met = c.n * frac
        met_total += met
        reports.append(ClassReport(
            name=c.slo.name, priority=c.slo.priority, num_requests=c.n,
            ttft_mean=ttft_c, ttft_p50=ttft_c, ttft_p95=ttft_p95_c,
            ttft_p99=ttft_p95_c,
            tpot_mean=tpot, tpot_p50=tpot, tpot_p95=tpot, tpot_p99=tpot,
            slo_met=int(met + 0.5),
            goodput_rps=met / drain_s if drain_s > 0 else 0.0))
    goodput = met_total / drain_s if drain_s > 0 else 0.0
    return goodput, reports


def _dispersed_report(label: str, ts: TraceSummary, ttft: float,
                      tpot: float, drain_s: float, energy: float,
                      tokens: float, peak_n: float, kv_per_req: float,
                      capacity: int, iterations: float,
                      t_pre: float = 0.0) -> SimulationReport:
    """Fold fluid means into a SimulationReport; percentile fields are
    means scaled by the trace's own length dispersion (enough to rank,
    not a tail model).  ``t_pre`` is the prefill-service floor inside
    ``ttft`` (the rest is queueing wait shared by every class) — the
    split the per-class goodput estimate needs."""
    ctx_disp = ts.ctx_p95 / ts.ctx_mean if ts.ctx_mean > 0 else 1.0
    gen = max(1.0, ts.gen_mean)
    ttft = max(0.0, ttft)
    tpot = max(0.0, tpot)
    t_pre = min(max(0.0, t_pre), ttft)
    e2e_mean = ttft + tpot * max(0.0, gen - 1.0)
    e2e_p95 = ttft * ctx_disp + tpot * max(0.0, ts.gen_p95 - 1.0)
    goodput, class_reports = _class_goodput(ts, ttft - t_pre, t_pre,
                                            tpot, drain_s)
    return SimulationReport(
        plan_label=label,
        e2e_latency=drain_s,
        total_energy=energy,
        ttft_mean=ttft, ttft_p95=ttft * ctx_disp,
        tpot_mean=tpot, tpot_p95=tpot,
        latency_p95=max(e2e_mean, e2e_p95),
        throughput_tok_s=tokens / drain_s if drain_s > 0 else 0.0,
        mfu=0.0, mbu=0.0,
        iterations=int(iterations),
        preemptions=0,
        peak_kv_tokens=int(min(capacity, peak_n * kv_per_req)),
        peak_batch=int(peak_n + 0.5),
        feasible=True,
        ttft_p50=ttft, ttft_p99=ttft * ctx_disp,
        tpot_p50=tpot, tpot_p99=tpot,
        goodput_rps=goodput, class_reports=class_reports)


class FluidSimulator:
    """Fluid-limit surrogate of one colocated plan's trace simulation.

    Mirrors ``PlanSimulator``'s constructor so search code can build
    either fidelity from the same (plan, store, coll) triple; the cost
    probes go through a ``StepCostCache`` so ``cache_stats`` reports the
    surrogate's cost reuse just like the exact simulators do.
    """

    steps: int = 48           # Euler steps over the arrival window

    def __init__(self, plan: ExecutionPlan, store: ProfileStore,
                 coll: CollectiveModel,
                 cost_store: Optional[SharedCostStore] = None):
        self.plan = plan
        self.scheme = plan.scheme
        self.sim = PlanSimulator(plan, store, coll, cost_store=cost_store)
        self.cache = self.sim.cost_cache()
        self.cache_stats = {"hits": 0, "misses": 0}

    def simulate(self, requests: Sequence[Request],
                 policy: Optional[BatchingPolicy] = None,
                 keep_records: bool = False,
                 summary: Optional[TraceSummary] = None,
                 preemption=None,
                 slo_classes=None) -> SimulationReport:
        # ``preemption`` is accepted for signature parity with the exact
        # simulator and ignored: the fluid limit admits within the same
        # KV cap instead of modeling eviction churn.
        policy = policy or BatchingPolicy()
        scheme = self.scheme
        cap = scheme.kv_token_capacity(self.plan.cluster.device.hbm_bytes)
        if cap <= 0:
            return SimulationReport.infeasible(scheme.label())
        if summary is None:
            requests = retag_slo(requests, slo_classes)
        ts = summary or TraceSummary.of(requests)
        if ts.n == 0:
            return SimulationReport.infeasible(scheme.label())
        rates = _probe_rates(self.sim, self.cache, ts, cap,
                             scheme.model_dp, policy)
        out = _integrate_colocated(rates, ts, self.steps)
        self.cache_stats = self.cache.stats()
        kv_per_req = ts.ctx_mean + ts.gen_mean / 2.0
        return _dispersed_report(scheme.label(), ts, out["ttft"],
                                 out["tpot"], out["t"], out["energy"],
                                 out["tokens"], out["peak_n"] / rates.dp,
                                 kv_per_req, cap, out["iters"],
                                 t_pre=rates.t_pre)


def _integrate_colocated(r: _PoolRates, ts: TraceSummary,
                         steps: int) -> dict:
    """Forward-Euler integration of the colocated fluid system.

    Aggregate (all-replica) state; the engine-time split between prefill
    and decode is the fluid analogue of contiguous batching: admitted
    prompts claim a share ``u`` of each replica-second and decode runs in
    the remaining ``1-u``, so a prefill backlog slows token emission
    exactly as prefill-priority iterations do in the engine.
    """
    lam = ts.arrival_rate * 1.0            # aggregate arrivals/s
    n = float(ts.n)
    gbar = max(1.0, ts.gen_mean)
    cap_total = r.b_cap * r.dp
    q = p = nd = done = tok = energy = 0.0
    aw = tpw = 0.0            # ∫(Q+P)dt, token-weighted decode intervals
    peak_n = 0.0
    iters = 0.0
    t = 0.0
    span = ts.span_s
    dt = span / steps if span > 0 else 0.0
    if dt <= 0:                            # burst trace: all arrive at 0
        q = n
        dt = _drain_dt_estimate(r, n, gbar, cap_total, steps)
    budget = 40 * steps                    # hard bound on the Euler loop
    remaining_arrivals = n

    for _ in range(budget):
        if done >= n - 1e-6:
            break
        if t >= span and q + p + nd <= 1e-9:
            break
        # arrivals (exact count over the window, fluid within it)
        if remaining_arrivals > 0 and span > 0:
            a = min(remaining_arrivals, lam * dt)
            if t + dt >= span:
                a = remaining_arrivals
            q += a
            remaining_arrivals -= a
        # admission: memory/slot-gated, instantaneous in the fluid limit
        slots = cap_total - nd - p
        if slots > 0 and q > 0:
            x = min(q, slots)
            q -= x
            p += x
        # prefill claims engine time first (prefill-priority batching)
        u = 0.0
        if p > 0:
            pref = min(p, r.dp * dt / r.t_pre)
            u = pref * r.t_pre / (r.dp * dt)
            p -= pref
            nd += pref
            energy += pref * r.e_pre
            iters += pref
        peak_n = max(peak_n, nd)
        # decode in the remaining share
        if nd > 1e-9 and u < 1.0:
            b = max(1.0, nd / r.dp)
            tdb = r.t_dec(b)
            emitted = (1.0 - u) * nd / tdb * dt
            comp = min(nd, emitted / gbar)
            tok += emitted
            # token-weighted inter-token interval (exact even when a
            # request decodes end-to-end inside one Euler step, where the
            # ∫N dt / tokens estimate collapses to zero)
            tpw += emitted * tdb / (1.0 - u)
            nd -= comp
            done += comp
            energy += (1.0 - u) * dt * r.dp * r.e_dec(b) / tdb
            iters += (1.0 - u) * dt * r.dp / tdb
        aw += (q + p) * dt
        t += dt
        if t >= span and q + p + nd > 1e-9:
            # drain phase: re-scale dt to the remaining work
            dt = max(dt, _drain_dt_estimate(r, q + p + nd, gbar,
                                            cap_total, steps))
    else:
        # budget exhausted (deep overload): extrapolate the linear tail
        left = n - done
        b = max(1.0, min(cap_total, nd) / r.dp) if nd > 0 else 1.0
        mu = nd / r.t_dec(b) / gbar if nd > 0 else r.dp / r.t_pre
        tail = left / max(mu, 1e-9)
        aw += (q + p) * tail / 2.0
        tpw += left * gbar * r.t_dec(b)
        tok += left * gbar
        t += tail
        done = n

    tok = min(tok, n * gbar)
    # queueing integral plus the service-time floor: a request that never
    # waits still pays its own prefill (without the floor, sub-dt prefill
    # clears within one Euler step and every plan's TTFT collapses to 0)
    ttft = aw / n + r.t_pre
    tpot = tpw / tok if tok > 0 else 0.0
    return {"ttft": ttft, "tpot": tpot, "t": t, "energy": energy,
            "tokens": tok, "peak_n": peak_n, "iters": iters}


def _drain_dt_estimate(r: _PoolRates, backlog: float, gbar: float,
                       cap_total: float, steps: int) -> float:
    """Step size that resolves draining ``backlog`` requests in ~steps."""
    b = max(1.0, min(backlog, cap_total) / r.dp)
    mu = min(cap_total, backlog) / r.t_dec(b) / gbar  # completions/s
    mu = min(mu, r.dp / r.t_pre) if backlog > cap_total else mu
    est = backlog / max(mu, 1e-9) + backlog * r.t_pre / r.dp
    return max(est / steps, 1e-9)


class FluidDisaggSimulator:
    """Fluid-limit surrogate of a disaggregated plan: both pools and the
    shared KV wire integrated as one coupled system.

    Mirrors ``DisaggSimulator``'s constructor; the underlying exact
    simulator is built only for its per-pool cost hooks and transfer
    estimator — no events run.
    """

    steps: int = 48

    def __init__(self, plan, store: ProfileStore, coll: CollectiveModel,
                 kv_model=None, decode_store: Optional[ProfileStore] = None,
                 decode_coll: Optional[CollectiveModel] = None,
                 cost_store: Optional[SharedCostStore] = None):
        from ..disagg.simulate import DisaggSimulator
        self.exact = DisaggSimulator(plan, store, coll, kv_model,
                                     decode_store=decode_store,
                                     decode_coll=decode_coll,
                                     cost_store=cost_store)
        self.plan = plan
        self.scheme = plan.scheme
        self.pre_cache = self.exact.pre_sim.cost_cache()
        self.dec_cache = self.exact.dec_sim.cost_cache()
        self.cache_stats = {"hits": 0, "misses": 0}

    def simulate(self, requests: Sequence[Request],
                 policy: Optional[BatchingPolicy] = None,
                 keep_records: bool = False,
                 prefill_policy: Optional[BatchingPolicy] = None,
                 decode_policy: Optional[BatchingPolicy] = None,
                 summary: Optional[TraceSummary] = None,
                 preemption=None,
                 slo_classes=None) -> SimulationReport:
        # ``preemption`` accepted for parity with DisaggSimulator and
        # ignored (no eviction churn in the fluid limit)
        plan = self.plan
        pre_pol = (prefill_policy or plan.prefill_policy or policy
                   or BatchingPolicy())
        dec_pol = (decode_policy or plan.decode_policy or policy
                   or BatchingPolicy())
        if pre_pol.mode == "static" or dec_pol.mode == "static":
            # mirror the exact simulator: static batching has no
            # meaningful decode-only pool
            return SimulationReport.infeasible(plan.label())
        pre_s, dec_s = self.scheme.prefill, self.scheme.decode
        pre_cap = pre_s.kv_token_capacity(
            plan.prefill_cluster.device.hbm_bytes)
        dec_cap = dec_s.kv_token_capacity(
            plan.decode_cluster.device.hbm_bytes)
        if pre_cap <= 0 or dec_cap <= 0:
            return SimulationReport.infeasible(plan.label())
        if summary is None:
            requests = retag_slo(requests, slo_classes)
        ts = summary or TraceSummary.of(requests)
        if ts.n == 0:
            return SimulationReport.infeasible(plan.label())

        pre = _probe_rates(self.exact.pre_sim, self.pre_cache, ts,
                           pre_cap, pre_s.model_dp, pre_pol)
        dec = _probe_rates(self.exact.dec_sim, self.dec_cache, ts,
                           dec_cap, dec_s.model_dp, dec_pol,
                           decode_only=True)
        lanes = min(pre_s.devices_per_replica, dec_s.devices_per_replica)
        est = self.exact.kv.estimate(
            self.scheme.model, max(1, int(round(ts.ctx_mean))),
            pre_s.quant, plan.transfer_span, lanes=lanes)

        out = _integrate_disagg(pre, dec, est, ts, self.steps)
        self.cache_stats = {
            k: self.pre_cache.stats()[k] + self.dec_cache.stats()[k]
            for k in ("hits", "misses", "entries", "evictions")}
        kv_per_req = ts.ctx_mean + ts.gen_mean / 2.0
        return _dispersed_report(plan.label(), ts, out["ttft"],
                                 out["tpot"], out["t"], out["energy"],
                                 out["tokens"], out["peak_n"] / dec.dp,
                                 kv_per_req, dec_cap, out["iters"],
                                 t_pre=pre.t_pre)


def _integrate_disagg(pre: _PoolRates, dec: _PoolRates, est,
                      ts: TraceSummary, steps: int) -> dict:
    """Coupled fluid system: prefill pool -> shared KV wire -> decode
    pool.  The wire's service rate (1/wire_s, the SharedLink FIFO's
    fluid limit) is the coupling term: the decode pool's arrival flux is
    the transfer completion rate, never more than the wire admits."""
    lam = ts.arrival_rate
    n = float(ts.n)
    gbar = max(1.0, ts.gen_mean)
    dec_tokens_per_req = max(0.0, gbar - 1.0)   # first token at prefill
    wire = max(est.wire_s, 0.0)
    dcap_total = dec.b_cap * dec.dp

    qp = pp = 0.0             # prefill pool: waiting / in prefill
    ql = 0.0                  # transfers queued on the shared wire
    qd = nd = 0.0             # decode pool: awaiting slot / decoding
    done = tok = energy = 0.0
    awp = al = awd = tpw = 0.0
    peak_n = 0.0
    iters = 0.0
    t = 0.0
    span = ts.span_s
    dt = span / steps if span > 0 else 0.0
    if dt <= 0:
        qp = n
        dt = _drain_dt_estimate(dec, n, gbar, dcap_total, steps) \
            + n * pre.t_pre / pre.dp / steps
    budget = 40 * steps
    remaining_arrivals = n
    first_tokens = 0.0

    for _ in range(budget):
        if done >= n - 1e-6:
            break
        if t >= span and qp + pp + ql + qd + nd <= 1e-9:
            break
        if remaining_arrivals > 0 and span > 0:
            a = min(remaining_arrivals, lam * dt)
            if t + dt >= span:
                a = remaining_arrivals
            qp += a
            remaining_arrivals -= a
        # ---- prefill pool (prefill-only iterations) ----
        if qp > 0:
            pp += qp            # admission gated only by prefill service
            qp = 0.0
        fin = 0.0
        if pp > 0:
            fin = min(pp, pre.dp * dt / pre.t_pre)
            pp -= fin
            energy += fin * pre.e_pre
            iters += fin
            first_tokens += fin
        # ---- shared wire: the cross-pool coupling term ----
        ql += fin
        if ql > 0:
            moved = min(ql, dt / wire) if wire > 0 else ql
            ql -= moved
            qd += moved
        # ---- decode pool (decode-only continuous batching) ----
        slots = dcap_total - nd
        if slots > 0 and qd > 0:
            x = min(qd, slots)
            qd -= x
            nd += x
        peak_n = max(peak_n, nd)
        if nd > 1e-9 and dec_tokens_per_req > 0:
            b = max(1.0, nd / dec.dp)
            tdb = dec.t_dec(b)
            emitted = nd / tdb * dt
            comp = min(nd, emitted / dec_tokens_per_req)
            tok += emitted
            tpw += emitted * tdb   # token-weighted inter-token interval
            nd -= comp
            done += comp
            energy += dt * dec.dp * dec.e_dec(b) / tdb
            iters += dt * dec.dp / tdb
        elif dec_tokens_per_req <= 0:
            done += nd + qd
            nd = qd = 0.0
        awp += (qp + pp) * dt
        al += ql * dt
        awd += qd * dt
        t += dt
        if t >= span and qp + pp + ql + qd + nd > 1e-9:
            backlog = qp + pp + ql + qd + nd
            dt = max(dt, _drain_dt_estimate(dec, backlog, gbar,
                                            dcap_total, steps))
    else:
        left = n - done
        b = max(1.0, min(dcap_total, nd) / dec.dp) if nd > 0 else 1.0
        mu = (nd / dec.t_dec(b) / max(dec_tokens_per_req, 1.0)
              if nd > 0 else pre.dp / pre.t_pre)
        tail = left / max(mu, 1e-9)
        awp += (qp + pp) * tail / 2.0
        tpw += left * dec_tokens_per_req * dec.t_dec(b)
        tok += left * dec_tokens_per_req
        t += tail
        done = n

    tok = min(tok, n * dec_tokens_per_req)
    total_tok = tok + min(first_tokens, n)       # first tokens count too
    energy += n * est.energy_j                   # every shipped cache
    ttft = awp / n + pre.t_pre     # queueing + own-prefill service floor
    # time between token 1 and 2: transfer (uncontended tail + queueing
    # on the wire) plus decode-slot wait; then decode pacing
    xfer = est.delay_s + al / n
    slot_wait = awd / n
    per_tok = tpw / tok if tok > 0 else 0.0
    if dec_tokens_per_req > 0:
        tpot = (xfer + slot_wait + per_tok * dec_tokens_per_req) \
            / dec_tokens_per_req
    else:
        tpot = 0.0
    return {"ttft": ttft, "tpot": tpot, "t": t, "energy": energy,
            "tokens": total_tok, "peak_n": peak_n, "iters": iters}
