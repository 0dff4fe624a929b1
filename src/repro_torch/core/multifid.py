"""Multi-fidelity plan search: fluid screening, exact confirmation.

Plan search cost is dominated by exact trace simulation — tens of
milliseconds per candidate — while the fluid surrogate (core/fluid.py)
scores a candidate in a few hundred microseconds from the same cost
models.  ``MultiFidelitySearch`` exploits the gap with the classic
screen-then-confirm loop:

  1. SCREEN every candidate ``ApexSearch.candidates()`` enumerates with
     the fluid surrogate (one shared ``TraceSummary``, computed once),
  2. keep a SURVIVOR FRONTIER: the top ``frontier_k`` surrogate
     candidates under EVERY objective in ``OBJECTIVES`` (not just the
     requested one — the surrogate's ranking noise is objective-
     dependent, so a multi-objective frontier hedges against it), plus
     the top ``frontier_k`` under the requested objective among
     candidates whose surrogate means fit a ``slo_slack``-widened SLO
     band (candidates the surrogate thinks are near-feasible survive
     even if their surrogate objective is middling),
  3. CONFIRM the survivors with the exact event engine — but as a
     successive-halving LADDER, not a cliff: survivors are first
     simulated exactly on a short PREFIX of the trace (default 25% of
     requests — the first k arrivals of a Poisson trace are themselves a
     Poisson sample, so prefix rankings are unbiased), the top fraction
     per objective (tie-aware, SLO-band-slackened — the same frontier
     semantics as screening) promotes to the next longer prefix, and
     only the finalists pay for the full trace.  Serial or across
     ``jobs`` forked workers; ranked exactly as ``ApexSearch.search``
     would have.

With a ~1000-candidate joint search this turns a many-minute exact
sweep into roughly a second of screening plus a handful of exact
simulations, while the frontier (default width 8 per objective) is wide
enough that the exact search's winner survives screening AND every
halving rung (tested in tests/test_fluid.py and tests/test_halving.py
across seeded model/trace points).

The port's copy of ``repro/core/multifid.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable, List, Optional, Sequence

from .batching import BatchingPolicy
from .cluster import Cluster
from .fluid import TraceSummary
from .metrics import SimulationReport
from .search import (OBJECTIVES, ApexSearch, SearchResult, _call_progress)
from .trace import Request, prefix_trace, retag_slo


@dataclasses.dataclass
class RungStat:
    """Telemetry for one successive-halving rung: who was evaluated on
    how much trace, who promoted, and what it cost."""

    fraction: float                    # of the trace (by request count)
    n_requests: int                    # prefix length actually simulated
    evaluated: int                     # survivors entering this rung
    promoted: int                      # survivors leaving this rung
    seconds: float                     # rung wall time
    cache_hits: int                    # summed StepCostCache counters
    cache_misses: int
    survivor_indices: List[int]        # global candidate indices promoted


@dataclasses.dataclass
class MultiFidelityResult:
    """A ``SearchResult`` over the confirmed survivors, plus the
    screening/halving telemetry that justifies trusting it."""

    result: SearchResult               # exact ranking over the finalists
    num_candidates: int                # size of the full candidate set
    num_survivors: int                 # finalists exact-confirmed on the
                                       # FULL trace (= len(all_reports))
    screen_seconds: float              # fluid sweep wall time
    confirm_seconds: float             # exact wall time: rungs + finals
    surrogate_reports: List[SimulationReport]   # fluid report per candidate
    survivor_indices: List[int]        # finalists, as candidate indices
    screen_survivors: int = 0          # survivors out of fluid screening
                                       # (what enters the first rung)
    rungs: List[RungStat] = dataclasses.field(default_factory=list)

    @property
    def best(self) -> SimulationReport:
        return self.result.best

    @property
    def best_plan(self):
        return self.result.best_plan

    @property
    def surrogate_plans_per_sec(self) -> float:
        if self.screen_seconds <= 0:
            return float("inf")
        return self.num_candidates / self.screen_seconds


class MultiFidelitySearch:
    """Layered on an ``ApexSearch``: same candidate set, same objectives,
    same exact simulators for the final ranking — only the sweep over
    non-survivors is replaced by the fluid surrogate."""

    # quarter-window deviation (Poisson standard errors) above which a
    # trace is treated as non-stationary — ~2 is ordinary Poisson noise,
    # so 6 only trips on flagrant diurnal/burst structure
    NONSTATIONARY_Z = 6.0

    def __init__(self, search: ApexSearch, frontier_k: int = 8,
                 slo_slack: float = 1.5,
                 screen_objectives: Optional[Sequence[str]] = None,
                 tie_rel: float = 5e-3,
                 rungs: Sequence[float] = (0.25, 0.5),
                 promote_frac: float = 1 / 3,
                 min_rung_requests: int = 8,
                 rung_tie_rel: float = 1e-6):
        """``rungs`` are trace-prefix fractions for successive halving
        (ascending; the full trace is the implicit final rung); each rung
        promotes the tie-aware top ``max(frontier_k, ceil(promote_frac *
        entrants))`` under the requested objective, plus the SLO band —
        never narrower than the screening frontier, so halving only ever
        prunes when there is real headroom.  Rungs whose prefix would be
        shorter than ``min_rung_requests`` are skipped (tiny prefixes
        rank on noise).

        ``tie_rel`` (screening) and ``rung_tie_rel`` (halving rungs) are
        deliberately different: the wide screening band absorbs the
        surrogate's MODEL error, but rungs run the exact engine, where
        only genuine ties (symmetric plan variants with bit-equal
        objectives) are ambiguous — a wide band at rungs floods
        promotion past ``promote_frac`` and erases the ladder's savings.
        Prefix-vs-full ranking drift is instead absorbed by the generous
        ``promote_frac`` and the ``frontier_k`` floor."""
        self.inner = search
        if frontier_k <= 0:
            raise ValueError(f"frontier_k must be > 0, got {frontier_k}")
        self.frontier_k = frontier_k
        self.slo_slack = slo_slack
        self.tie_rel = tie_rel
        self.rungs = list(rungs)
        if any(not 0.0 < f < 1.0 for f in self.rungs):
            raise ValueError(f"rung fractions must lie in (0, 1), "
                             f"got {list(rungs)}")
        if any(b <= a for a, b in zip(self.rungs, self.rungs[1:])):
            raise ValueError(f"rung fractions must be strictly "
                             f"increasing, got {list(rungs)}")
        if not 0.0 < promote_frac <= 1.0:
            raise ValueError(f"promote_frac must lie in (0, 1], "
                             f"got {promote_frac}")
        self.promote_frac = promote_frac
        self.min_rung_requests = min_rung_requests
        self.rung_tie_rel = rung_tie_rel
        self.screen_objectives = list(screen_objectives or OBJECTIVES)
        unknown = [o for o in self.screen_objectives if o not in OBJECTIVES]
        if unknown:
            raise KeyError(f"unknown screening objectives {unknown}; "
                           f"known: {sorted(OBJECTIVES)}")

    # -- survivor selection ---------------------------------------------------

    def _topk_with_ties(self, feas: List[int],
                        reports: List[SimulationReport], key,
                        k: Optional[int] = None,
                        tie_rel: Optional[float] = None) -> List[int]:
        """Top ``k`` (default ``frontier_k``) of ``feas`` under ``key``,
        EXPANDED to every candidate within ``tie_rel`` of the k-th value:
        when a fidelity level cannot distinguish plans (e.g. span-
        dominated latency at light load, where dozens tie to the arrival
        window), cutting the tie block at k would drop candidates on
        index order — an arbitrary choice the next, higher fidelity
        should make."""
        k = self.frontier_k if k is None else k
        tie_rel = self.tie_rel if tie_rel is None else tie_rel
        ranked = sorted(feas, key=lambda i: key(reports[i]))
        if len(ranked) <= k:
            return ranked
        kth = key(reports[ranked[k - 1]])
        thr = kth + tie_rel * abs(kth)
        return [i for i in ranked if key(reports[i]) <= thr]

    def _frontier(self, reports: List[SimulationReport], objective: str,
                  slo_ttft_s: Optional[float],
                  slo_tpot_s: Optional[float],
                  objectives: Optional[Sequence[str]] = None,
                  k: Optional[int] = None,
                  tie_rel: Optional[float] = None) -> List[int]:
        """Indices surviving one fidelity level: the tie-aware top ``k``
        under every objective in ``objectives`` (default: the screening
        objectives), plus the top ``k`` under the requested objective
        among candidates in the slackened SLO band.  Halving rungs reuse
        this with ``objectives=(objective,)``, a promotion-sized ``k``,
        and the exact-fidelity ``rung_tie_rel`` — same semantics,
        narrower lens."""
        feas = [i for i, r in enumerate(reports) if r.feasible]
        if not feas:
            return []
        keep: set = set()
        for name in (objectives if objectives is not None
                     else self.screen_objectives):
            keep.update(self._topk_with_ties(feas, reports,
                                             OBJECTIVES[name], k=k,
                                             tie_rel=tie_rel))
        # near-SLO band under the requested objective: surrogate MEANS
        # within slack x SLO (means, not p95 — the surrogate's percentiles
        # are dispersion-scaled means, so the band uses the sturdier
        # statistic and the slack absorbs the dispersion)
        if slo_ttft_s is not None or slo_tpot_s is not None:
            def in_band(i: int) -> bool:
                r = reports[i]
                if slo_ttft_s is not None and \
                        r.ttft_mean > slo_ttft_s * self.slo_slack:
                    return False
                if slo_tpot_s is not None and \
                        r.tpot_mean > slo_tpot_s * self.slo_slack:
                    return False
                return True
            band = [i for i in feas if in_band(i)]
            if band:
                keep.update(self._topk_with_ties(band, reports,
                                                 OBJECTIVES[objective],
                                                 k=k, tie_rel=tie_rel))
        return sorted(keep)

    # -- the search -----------------------------------------------------------

    def search(self, requests: Sequence[Request],
               objective: str = "latency",
               quant: str = "fp16",
               feasible_only: bool = False,
               policy: Optional[BatchingPolicy] = None,
               max_model_dp: Optional[int] = None,
               slo_ttft_s: Optional[float] = None,
               slo_tpot_s: Optional[float] = None,
               disaggregated: bool = False,
               transfer_mode: str = "layerwise",
               decode_quant: Optional[str] = None,
               max_disagg_plans: int = 256,
               pool_menu: Optional[Sequence[Cluster]] = None,
               max_total_devices: Optional[int] = None,
               prefill_policy: Optional[BatchingPolicy] = None,
               decode_policy: Optional[BatchingPolicy] = None,
               progress: Optional[Callable] = None,
               verbose: bool = False,
               jobs: int = 1,
               preemption=None,
               slo_classes=None,
               halving: bool = True,
               faults=None,
               nonstationary: str = "raise",
               dynamic=None) -> MultiFidelityResult:
        """Same signature semantics as ``ApexSearch.search``; returns a
        ``MultiFidelityResult`` whose ``result`` ranks only the confirmed
        finalists (``result.all_reports`` holds one EXACT full-trace
        report per finalist, in ``survivor_indices`` order).
        ``objective="goodput"`` screens by the surrogate's per-class
        SLO-attainment estimate (the frontier always includes the top-k
        under every objective, goodput among them) and confirms with the
        engine's measured goodput.

        ``halving=True`` (default) climbs the successive-halving ladder
        between screening and full confirmation: survivors are exactly
        simulated on each ``rungs`` trace prefix in turn, promoting the
        tie-aware frontier under the requested objective, so the full
        trace is paid only by the finalists.  ``halving=False`` skips
        the ladder (every screening survivor runs the full
        trace).

        ``faults`` applies ONLY to the final full-trace confirmation:
        screening (fluid surrogate) and the halving rungs stay
        fault-free by design — the surrogate has no fault dynamics and
        prefix rungs would rank on truncated fault windows — so the
        ladder orders candidates by nominal service and the finalists
        pay for the seeded faulted re-simulations that
        ``objective="degraded_goodput"`` ranks on.

        The fluid surrogate assumes ONE arrival rate; on a markedly
        non-stationary trace (``TraceSummary.nonstationarity`` above
        ~6 Poisson standard errors — diurnal or bursty arrivals) it
        would silently mis-rank.  ``nonstationary`` picks the response:
        ``"raise"`` (default) refuses with a clear error, ``"peak"``
        screens conservatively at the busiest quarter-window's arrival
        rate, ``"ignore"`` keeps the mean-rate screening (exact rungs
        and confirmation still correct the ranking downstream).

        ``dynamic`` (a ``core.dynamic.DynamicSpec``) extends the final
        confirmed ranking with epoch-gated plan-switching schedules over
        the finalists, exactly as in ``ApexSearch.search(dynamic=...)``
        — only exact-confirmed plans enter timetables, so the surrogate
        never ranks a switch."""
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; choose "
                             f"one of {sorted(OBJECTIVES)}")
        if jobs < 0:
            raise ValueError(f"jobs must be >= 0, got {jobs}")
        from .faults import attach_resilience, normalize_faults
        faults = normalize_faults(faults)
        if objective == "degraded_goodput" and not faults:
            raise ValueError(
                "objective='degraded_goodput' needs a non-empty fault "
                "ensemble: pass faults=FaultSchedule(...) or "
                "faults=fault_ensemble(...)")
        obj = OBJECTIVES[objective]
        inner = self.inner
        requests = retag_slo(requests, slo_classes)
        candidates, kv_model = inner.candidates(
            quant=quant, feasible_only=feasible_only,
            max_model_dp=max_model_dp, disaggregated=disaggregated,
            transfer_mode=transfer_mode, decode_quant=decode_quant,
            max_disagg_plans=max_disagg_plans, pool_menu=pool_menu,
            max_total_devices=max_total_devices)
        n_cand = len(candidates)
        # one shared sort: the screening summary and every rung prefix
        # slice off the same arrival-ordered trace
        ordered = sorted(requests, key=lambda r: (r.arrival, r.rid))
        summaries = TraceSummary.of_prefixes(
            ordered, self.rungs if halving else ())
        ts = summaries[1.0]
        if nonstationary not in ("raise", "peak", "ignore"):
            raise ValueError(f"unknown nonstationary mode "
                             f"{nonstationary!r} (raise|peak|ignore)")
        if ts.nonstationarity > self.NONSTATIONARY_Z:
            if nonstationary == "raise":
                raise ValueError(
                    f"trace is non-stationary (z={ts.nonstationarity:.1f} "
                    f"Poisson standard errors across quarter-windows, "
                    f"threshold {self.NONSTATIONARY_Z:g}): the fluid "
                    "surrogate screens on ONE arrival rate and would "
                    "mis-rank.  Pass nonstationary='peak' to screen at "
                    "the busiest window's rate, 'ignore' to accept "
                    "mean-rate screening, or use ApexSearch.search "
                    "(exact, optionally with dynamic=DynamicSpec(...)).")
            if nonstationary == "peak":
                summaries = {f: dataclasses.replace(
                    s, arrival_rate=max(s.arrival_rate, s.peak_rate))
                    for f, s in summaries.items()}
                ts = summaries[1.0]

        # ---- phase 1: fluid screening (cheap enough to stay serial) ----
        t0 = _time.perf_counter()
        surrogate: List[SimulationReport] = []
        for i, cand in enumerate(candidates):
            family = cand[0]
            _, sim = inner.make_simulator(cand, kv_model, fluid=True)
            sim_kwargs = {} if family == "colocated" else {
                "prefill_policy": prefill_policy,
                "decode_policy": decode_policy}
            surrogate.append(sim.simulate(requests, policy=policy,
                                          summary=ts, **sim_kwargs))
            if verbose and (i + 1) % max(1, n_cand // 10) == 0:
                print(f"[screen] {i + 1}/{n_cand} surrogate-scored")
        screen_s = _time.perf_counter() - t0

        survivors = self._frontier(surrogate, objective,
                                   slo_ttft_s, slo_tpot_s)
        if not survivors:
            # surrogate found nothing feasible — fall back to confirming
            # every candidate rather than failing on surrogate pessimism
            survivors = list(range(n_cand))
        screen_survivors = len(survivors)
        if verbose:
            print(f"[screen] {n_cand} candidates -> "
                  f"{len(survivors)} survivors "
                  f"({screen_s:.2f}s, "
                  f"{n_cand / screen_s if screen_s > 0 else 0:.0f} plans/s)")

        def make_eval(idx: List[int], reqs: Sequence[Request],
                      fault_set=()):
            """Exact evaluation of candidates ``idx`` on trace ``reqs`` —
            one closure shape for every rung and the final confirm
            (``fault_set`` is non-empty only at the final confirm)."""
            def eval_one(j: int):
                cand = candidates[idx[j]]
                _, sim = inner.make_simulator(cand, kv_model)
                sim_kwargs = {} if cand[0] == "colocated" else {
                    "prefill_policy": prefill_policy,
                    "decode_policy": decode_policy}
                rep = sim.simulate(reqs, policy=policy,
                                   preemption=preemption, **sim_kwargs)
                st = getattr(sim, "cache_stats", None) or {}
                hits, misses = st.get("hits", 0), st.get("misses", 0)
                if fault_set and rep.feasible:
                    members = []
                    for f in fault_set:
                        members.append(sim.simulate(
                            reqs, policy=policy, preemption=preemption,
                            faults=f, **sim_kwargs))
                        st = getattr(sim, "cache_stats", None) or {}
                        hits += st.get("hits", 0)
                        misses += st.get("misses", 0)
                    rep = attach_resilience(rep, members)
                return rep, hits, misses
            return eval_one

        # ---- phase 2a: successive-halving rungs on trace prefixes ----
        t1 = _time.perf_counter()
        rung_stats: List[RungStat] = []
        hits = misses = 0
        if halving:
            for frac in self.rungs:
                if len(survivors) <= self.frontier_k:
                    break       # nothing left to halve
                prefix = prefix_trace(ordered, frac, presorted=True)
                if len(prefix) < self.min_rung_requests:
                    continue    # too short to rank on signal
                tr = _time.perf_counter()
                rung_reports, _, rh, rm = inner._evaluate_ranked(
                    make_eval(survivors, prefix), len(survivors), obj,
                    slo_ttft_s, slo_tpot_s, jobs=jobs,
                    verbose=verbose, tag=f"rung {frac:.0%}")
                hits += rh
                misses += rm
                k_promote = max(self.frontier_k,
                                math.ceil(self.promote_frac
                                          * len(survivors)))
                promoted = self._frontier(rung_reports, objective,
                                          slo_ttft_s, slo_tpot_s,
                                          objectives=(objective,),
                                          k=k_promote,
                                          tie_rel=self.rung_tie_rel)
                if promoted:
                    next_survivors = [survivors[j] for j in promoted]
                else:
                    # every survivor infeasible on this prefix (e.g. the
                    # prefix undershoots a KV/SLO cliff) — promotion by
                    # pessimism: keep everyone, let a higher fidelity rank
                    next_survivors = survivors
                rung_stats.append(RungStat(
                    fraction=frac, n_requests=len(prefix),
                    evaluated=len(survivors),
                    promoted=len(next_survivors),
                    seconds=_time.perf_counter() - tr,
                    cache_hits=rh, cache_misses=rm,
                    survivor_indices=next_survivors))
                if verbose:
                    print(f"[rung {frac:.0%}] {len(survivors)} -> "
                          f"{len(next_survivors)} promoted "
                          f"({len(prefix)} requests, "
                          f"{rung_stats[-1].seconds:.2f}s)")
                survivors = next_survivors

        # ---- phase 2b: full-trace confirmation of the finalists ----
        def confirm_progress(done, total, best):
            if progress:
                _call_progress(progress, done, total, best)
            if verbose and (done == total or done % max(1, total // 5) == 0):
                lbl = best.plan_label if best is not None else "<none>"
                print(f"[confirm] {done}/{total} exact, best={lbl}")

        reports, best_j, fh, fm = inner._evaluate_ranked(
            make_eval(survivors, requests, fault_set=faults),
            len(survivors), obj,
            slo_ttft_s, slo_tpot_s,
            jobs=jobs, progress=confirm_progress, tag="confirm")
        hits += fh
        misses += fm
        confirm_s = _time.perf_counter() - t1
        if best_j is None:
            raise RuntimeError(
                "no feasible plan found (memory or SLO constraints too "
                f"tight) among {len(survivors)} survivors of "
                f"{n_cand} candidates")
        best_plan, _ = inner.make_simulator(candidates[survivors[best_j]],
                                            kv_model)
        result = SearchResult(
            best=reports[best_j], best_plan=best_plan,
            all_reports=reports, num_schemes=n_cand,
            num_feasible=sum(r.feasible for r in reports),
            search_seconds=screen_s + confirm_s,
            objective=objective,
            slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
            cache_hits=hits, cache_misses=misses)
        if dynamic is not None and not dynamic.is_empty:
            # schedules draw only on the exact-confirmed finalists
            # (reports align with ``survivors`` positions)
            result = inner._extend_dynamic(
                result, dynamic, [candidates[i] for i in survivors],
                kv_model, requests, obj, policy=policy,
                preemption=preemption, t0=t0)
        return MultiFidelityResult(
            result=result, num_candidates=n_cand,
            num_survivors=len(survivors),
            screen_seconds=screen_s, confirm_seconds=confirm_s,
            surrogate_reports=surrogate, survivor_indices=survivors,
            screen_survivors=screen_survivors, rungs=rung_stats)
