"""Automated parallel-execution search — APEX's top-level workflow (Fig. 2).

Given (model IR, cluster, request trace):
  1. generate parallel schemes (planner.py, Algorithm 1),
  2. map each to physical devices (mapper.py),
  3. simulate serving the trace under iteration-level batching
     (batching.py + simulator.py),
  4. rank by a parameterizable objective — latency, energy, or
     SLO-constrained (paper §3.1: "APEX can optimize towards different
     objectives ... based on a parametrizable target metric").

Also provides the paper's three comparison points (§4.2): the heuristic
baseline plan, the Feasible Optimal (no cell-level DP / heterogeneous
sharding), and the unconstrained APEX Optimal.

Candidate enumeration and simulator construction are factored out of the
search loop (``candidates()`` / ``make_simulator()``) so the exact path
here and the fluid-surrogate screening path (core/multifid.py) evaluate
the SAME candidate set through either fidelity.  ``search(jobs=N)``
fans the per-plan simulations out across forked worker processes —
plans are independent and every evaluation is a pure function of
(plan, requests), so the parallel reports are identical to serial.

The port's copy of ``repro/core/search.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import inspect
import time as _time
from typing import Callable, List, Optional, Sequence, Tuple

from .batching import BatchingPolicy
from .cluster import Cluster
from .ir import ModelIR
from .mapper import ExecutionPlan, map_scheme
from .planner import (ParallelScheme, generate_schemes, heuristic_scheme,
                      prefilter_schemes)
from .engine import SharedCostStore
from .profiles import AnalyticBackend, CollectiveModel, ProfileBackend, \
    ProfileStore
from .simulator import PlanSimulator, SimulationReport
from .trace import Request, retag_slo


Objective = Callable[[SimulationReport], float]

OBJECTIVES = {
    "latency": lambda r: r.e2e_latency,
    "energy": lambda r: r.total_energy,
    "ttft": lambda r: r.ttft_p95,
    "tpot": lambda r: r.tpot_p95,
    "throughput": lambda r: -r.throughput_tok_s,   # maximize tok/s
    # maximize requests meeting their own SLO class's targets per second
    # (classless traces degrade to request throughput)
    "goodput": lambda r: -r.goodput_rps,
    # resilience-aware: maximize SLO goodput under a seeded fault
    # ensemble (``search(..., faults=...)``).  Reports without a
    # resilience block (fluid surrogate screening, halving rungs — both
    # fault-free by design) rank by their fault-free goodput, so the
    # multi-fidelity ladder still orders candidates sensibly and only
    # exact confirmation pays for faulted re-simulation.
    "degraded_goodput": lambda r: -(r.resilience.goodput_rps
                                    if r.resilience is not None
                                    else r.goodput_rps),
}

# A candidate plan before simulation: family is "colocated" | "disagg",
# pools is None (shared cluster) or a (prefill_cluster, decode_cluster)
# pair from a heterogeneous pool menu.
Candidate = Tuple[str, object, Optional[tuple]]


# ---------------------------------------------------------------------------
# forked parallel evaluation
# ---------------------------------------------------------------------------

class PlanEvaluationError(RuntimeError):
    """A per-candidate evaluation crashed — carries WHICH candidate.

    Raised by ``fork_map`` for both serial and forked failures, so a
    crash on candidate 137 of 1000 names the failing plan instead of
    surfacing as an anonymous worker traceback (forked workers cannot
    even propagate arbitrary exceptions — they may not pickle)."""

    def __init__(self, index: int, label: Optional[str],
                 cause_repr: str, worker_traceback: str = ""):
        self.index = index
        self.label = label
        self.cause_repr = cause_repr
        self.worker_traceback = worker_traceback
        what = f"evaluation of candidate {index}"
        if label:
            what += f" ({label})"
        super().__init__(f"{what} failed: {cause_repr}")


class _WorkerFailure:
    """Picklable stand-in a forked worker sends back when ``fn(i)``
    raises (the exception object itself may hold unpicklable state —
    simulator closures, heap lambdas)."""

    __slots__ = ("index", "cause_repr", "traceback")

    def __init__(self, index: int, cause_repr: str, traceback: str):
        self.index = index
        self.cause_repr = cause_repr
        self.traceback = traceback


def _label_of(label, i: int) -> Optional[str]:
    if label is None:
        return None
    try:
        return label(i)
    except Exception:
        return None


# The work closure is stashed module-level and inherited by forked
# workers (copy-on-write), so nothing but an index crosses the pipe on
# the way in and a picklable report on the way out.
_FORK_WORK: dict = {"fn": None}


def _fork_call(i: int):
    try:
        return _FORK_WORK["fn"](i)
    except Exception as exc:          # -> picklable failure sentinel
        import traceback
        return _WorkerFailure(i, repr(exc), traceback.format_exc())


def _serial_map(fn: Callable[[int], object], n: int,
                progress: Optional[Callable[[int], None]] = None,
                label: Optional[Callable[[int], str]] = None) -> list:
    out = []
    for i in range(n):
        try:
            out.append(fn(i))
        except Exception as exc:
            raise PlanEvaluationError(i, _label_of(label, i),
                                      repr(exc)) from exc
        if progress:
            progress(i + 1)
    return out


def fork_map(fn: Callable[[int], object], n: int, jobs: int,
             progress: Optional[Callable[[int], None]] = None,
             label: Optional[Callable[[int], str]] = None) -> list:
    """``[fn(i) for i in range(n)]`` across ``jobs`` forked processes.

    Falls back to the serial loop when ``jobs <= 1``, there is nothing
    to parallelize, or the platform has no fork (the only start method
    that inherits the closure without pickling it).  Spawn-only
    platforms (Windows, some macOS configurations) get the serial
    fallback with a warning rather than a crash.  Results come back
    in index order, so callers see exactly the serial sequence.

    A crash inside ``fn(i)`` — serial or forked — raises
    ``PlanEvaluationError`` naming the failing index (and its
    ``label(i)``, when given), never a bare worker traceback.
    """
    if jobs <= 1 or n <= 1:
        return _serial_map(fn, n, progress, label)
    import multiprocessing as mp
    if "fork" not in mp.get_all_start_methods():
        import warnings
        warnings.warn(
            "search(jobs=N) needs the 'fork' start method, which this "
            "platform does not offer; evaluating serially instead",
            RuntimeWarning, stacklevel=2)
        return _serial_map(fn, n, progress, label)
    try:
        ctx = mp.get_context("fork")
    except ValueError:
        return _serial_map(fn, n, progress, label)
    _FORK_WORK["fn"] = fn
    try:
        with ctx.Pool(min(jobs, n)) as pool:
            out = []
            for i, res in enumerate(pool.imap(_fork_call, range(n))):
                if isinstance(res, _WorkerFailure):
                    raise PlanEvaluationError(
                        res.index, _label_of(label, res.index),
                        res.cause_repr, res.traceback)
                out.append(res)
                if progress:
                    progress(i + 1)
            return out
    finally:
        _FORK_WORK["fn"] = None


def _call_progress(progress, done: int, total: int, best) -> None:
    """Invoke a progress callback with (done, total) or, when it accepts
    a third parameter, (done, total, current_best_report)."""
    try:
        n_params = len(inspect.signature(progress).parameters)
    except (TypeError, ValueError):
        n_params = 2
    if n_params >= 3:
        progress(done, total, best)
    else:
        progress(done, total)


@dataclasses.dataclass
class SearchResult:
    best: SimulationReport
    best_plan: object              # ExecutionPlan | disagg.DisaggPlan
    all_reports: List[SimulationReport]
    num_schemes: int
    num_feasible: int
    search_seconds: float
    objective: str = "latency"     # what the search ranked by
    slo_ttft_s: Optional[float] = None   # the SLO filters the search used
    slo_tpot_s: Optional[float] = None
    cache_hits: int = 0            # summed StepCostCache counters across
    cache_misses: int = 0          # every simulated candidate

    def admissible(self, r: SimulationReport) -> bool:
        """Feasible AND within the search's own SLO filters — the same
        predicate ``search`` applied when picking ``best``, so ``top``
        never surfaces plans the search itself rejected."""
        if not r.feasible:
            return False
        if self.slo_ttft_s is not None and r.ttft_p95 > self.slo_ttft_s:
            return False
        if self.slo_tpot_s is not None and r.tpot_p95 > self.slo_tpot_s:
            return False
        return True

    def top(self, k: int = 5) -> List[SimulationReport]:
        """Best-k admissible reports under the *search's own* objective."""
        key = OBJECTIVES.get(self.objective, OBJECTIVES["latency"])
        return sorted(filter(self.admissible, self.all_reports),
                      key=key)[:k]


class ApexSearch:
    """One search context: model + cluster + profiling backend."""

    def __init__(self, model: ModelIR, cluster: Cluster,
                 backend: Optional[ProfileBackend] = None,
                 freq_ghz: Optional[float] = None,
                 grid_stride: int = 1,
                 share_step_costs: bool = True):
        self.model = model
        self.cluster = cluster
        self.freq_ghz = freq_ghz
        self.grid_stride = grid_stride
        self.backend = backend or AnalyticBackend(cluster, freq_ghz=freq_ghz)
        self.store = ProfileStore(self.backend, grid_stride=grid_stride)
        self.coll = CollectiveModel(cluster, freq_ghz=freq_ghz)
        # search-scoped cross-plan step-cost store: candidates with equal
        # cost fingerprints (e.g. DP widths of one layout) price each
        # workload once per SEARCH instead of once per plan; it persists
        # across search() calls on this context, like ProfileStore does.
        # share_step_costs=False restores fully private per-simulator
        # caches (results are bit-identical either way — tested).
        self.cost_store = SharedCostStore() if share_step_costs else None
        # per-pool-cluster cost models for heterogeneous disagg candidates
        self._pool_ctx: dict = {}

    def _pool_cost_models(self, cluster: Cluster):
        """(store, coll) for one pool cluster of a heterogeneous plan,
        cached so every candidate pair sharing a pool reuses its tables."""
        key = id(cluster)
        if key not in self._pool_ctx:
            backend = AnalyticBackend(cluster, freq_ghz=self.freq_ghz)
            self._pool_ctx[key] = (
                ProfileStore(backend, grid_stride=self.grid_stride),
                CollectiveModel(cluster, freq_ghz=self.freq_ghz))
        return self._pool_ctx[key]

    # -- single-plan evaluation -------------------------------------------------

    def evaluate(self, scheme: ParallelScheme, requests: Sequence[Request],
                 policy: Optional[BatchingPolicy] = None,
                 keep_records: bool = False,
                 preemption=None,
                 slo_classes=None,
                 faults=None) -> SimulationReport:
        from .faults import attach_resilience, normalize_faults
        faults = normalize_faults(faults)
        plan = map_scheme(scheme, self.cluster)
        sim = PlanSimulator(plan, self.store, self.coll,
                            cost_store=self.cost_store)
        rep = sim.simulate(requests, policy=policy,
                           keep_records=keep_records,
                           preemption=preemption, slo_classes=slo_classes)
        if faults and rep.feasible:
            members = [sim.simulate(requests, policy=policy,
                                    preemption=preemption,
                                    slo_classes=slo_classes, faults=f)
                       for f in faults]
            rep = attach_resilience(rep, members)
        return rep

    def evaluate_baseline(self, requests: Sequence[Request],
                          quant: str = "fp16",
                          policy: Optional[BatchingPolicy] = None
                          ) -> SimulationReport:
        """The heuristic plan: TP in-node, PP across nodes (paper §4.2)."""
        scheme = heuristic_scheme(self.model, self.cluster.num_devices,
                                  cluster=self.cluster, quant=quant)
        return self.evaluate(scheme, requests, policy=policy)

    # -- candidate enumeration (shared by exact and surrogate search) ----------

    def candidates(self, quant: str = "fp16",
                   feasible_only: bool = False,
                   max_model_dp: Optional[int] = None,
                   disaggregated: bool = False,
                   transfer_mode: str = "layerwise",
                   decode_quant: Optional[str] = None,
                   max_disagg_plans: int = 256,
                   pool_menu: Optional[Sequence[Cluster]] = None,
                   max_total_devices: Optional[int] = None
                   ) -> Tuple[List[Candidate], object]:
        """Enumerate the candidate set one search call would simulate.

        Returns ``(candidates, kv_model)`` where each candidate is
        ``(family, scheme, pools)`` — see ``make_simulator`` — and
        ``kv_model`` is the shared-cluster KV-transfer model (None for a
        colocated-only search).
        """
        schemes = generate_schemes(self.model, self.cluster.num_devices,
                                   quant=quant,
                                   allow_cell_dp=not feasible_only,
                                   max_model_dp=max_model_dp)
        if feasible_only:
            schemes = [s for s in schemes
                       if s.is_feasible_for_current_systems()]
        # cheap static pre-filter: drop plans whose weights alone overflow
        schemes = prefilter_schemes(schemes,
                                    self.cluster.device.hbm_bytes)

        candidates: List[Candidate] = [("colocated", s, None)
                                       for s in schemes]
        kv_model = None
        if disaggregated:
            from ..disagg import (KVTransferModel, generate_disagg_schemes)
            dschemes = generate_disagg_schemes(
                self.model, self.cluster, quant=quant,
                decode_quant=decode_quant,
                feasible_only=True, transfer_mode=transfer_mode,
                max_model_dp=max_model_dp, max_plans=max_disagg_plans)
            kv_model = KVTransferModel(self.coll, mode=transfer_mode)
            candidates += [("disagg", s, None) for s in dschemes]
            if pool_menu:
                budget = max_total_devices or self.cluster.num_devices
                pairs = [(a, b) for a in pool_menu for b in pool_menu
                         if a.num_devices + b.num_devices <= budget]
                # menu pairs get their own candidate budget, split evenly
                # so neither the shared-cluster split family nor an early
                # pair starves the rest of slots
                per_pair = max(1, max_disagg_plans // max(1, len(pairs)))
                for pre_c, dec_c in pairs:
                    hschemes = generate_disagg_schemes(
                        self.model, quant=quant,
                        decode_quant=decode_quant,
                        feasible_only=True,
                        transfer_mode=transfer_mode,
                        max_model_dp=max_model_dp, max_plans=per_pair,
                        prefill_cluster=pre_c, decode_cluster=dec_c)
                    candidates += [("disagg", s, (pre_c, dec_c))
                                   for s in hschemes]
        return candidates, kv_model

    def make_simulator(self, candidate: Candidate, kv_model=None,
                       fluid: bool = False):
        """(plan, simulator) for one candidate, at either fidelity.

        ``fluid=True`` builds the fluid-ODE surrogate (core/fluid.py)
        from the same cost models the exact simulator would use, so the
        two fidelities disagree only on dynamics, never on step costs.
        """
        family, scheme, pools = candidate
        cs = self.cost_store
        if family == "colocated":
            plan = map_scheme(scheme, self.cluster)
            if fluid:
                from .fluid import FluidSimulator
                return plan, FluidSimulator(plan, self.store, self.coll,
                                            cost_store=cs)
            return plan, PlanSimulator(plan, self.store, self.coll,
                                       cost_store=cs)
        from ..disagg import DisaggSimulator, map_disagg_scheme
        if fluid:
            from .fluid import FluidDisaggSimulator
            sim_cls = FluidDisaggSimulator
        else:
            sim_cls = DisaggSimulator
        if pools is None:
            plan = map_disagg_scheme(scheme, self.cluster)
            return plan, sim_cls(plan, self.store, self.coll, kv_model,
                                 cost_store=cs)
        pre_c, dec_c = pools
        plan = map_disagg_scheme(scheme, prefill_cluster=pre_c,
                                 decode_cluster=dec_c)
        pre_store, pre_coll = self._pool_cost_models(pre_c)
        dec_store, dec_coll = self._pool_cost_models(dec_c)
        return plan, sim_cls(plan, pre_store, pre_coll,
                             decode_store=dec_store, decode_coll=dec_coll,
                             cost_store=cs)

    # -- full search --------------------------------------------------------------

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
               faults=None,
               dynamic=None) -> SearchResult:
        """Rank plans under ``objective``; with ``disaggregated=True`` the
        candidate set is the union of colocated schemes and two-pool
        disaggregated schemes (disagg/), scored by the same simulator
        metrics so one objective ranks both families jointly.

        ``pool_menu`` adds HETEROGENEOUS disaggregated candidates: every
        ordered (prefill_cluster, decode_cluster) pair from the menu whose
        combined device count fits ``max_total_devices`` (default: this
        search's cluster size) is enumerated — e.g. a menu of
        ``[h100_node(8), h200_node(8)]`` tries H100-prefill/H200-decode and
        every other assignment (including same-device pairs — two separate
        islands joined by a cross-pool link are a different deployment
        from splitting one shared cluster, and are labeled with their pool
        devices to stay distinguishable).  Each pool is costed on its own
        cluster's analytic model; the KV handoff crosses the pair's
        cross-pool link.  ``max_disagg_plans`` caps each disagg family
        separately (the shared-cluster splits, and the menu pairs jointly)
        — with a menu, up to ~2x that many disagg candidates simulate.

        ``prefill_policy``/``decode_policy`` drive the two pools of every
        disaggregated candidate with their own batching policies (e.g.
        chunked prefill only on the prefill pool, a different
        max_batch_size per pool), defaulting to the shared ``policy``;
        colocated candidates always use ``policy``.

        Long searches need not run silently: ``progress(done, total)`` —
        or ``progress(done, total, best_report)`` if the callback takes a
        third parameter — fires after every candidate, and
        ``verbose=True`` prints periodic candidates-evaluated /
        current-best lines.

        ``jobs=N`` evaluates candidates across N forked processes.  Plans
        are independent and each simulation is a pure function of
        (plan, requests), so the reports — and therefore the ranking —
        are identical to a serial run.

        ``preemption`` selects every candidate's KV-overflow policy
        (menu string or ``PreemptionPolicy``; None = sacrifice +
        recent-first); ``slo_classes`` re-tags the trace's SLO classes
        by name before simulation, so ``objective="goodput"`` ranks by
        requests meeting their class targets per second.

        ``faults`` (a ``FaultSchedule`` or a ``fault_ensemble`` list)
        re-simulates every feasible candidate under each member schedule
        and attaches the ensemble-aggregated ``ResilienceReport`` to its
        nominal report — required by ``objective="degraded_goodput"``,
        which ranks plans by how much SLO goodput survives the draws.

        ``dynamic`` (a ``core.dynamic.DynamicSpec``) extends the ranking
        with epoch-gated plan SWITCHING: schedules over the static
        sweep's top-k plans are simulated through
        ``DynamicPlanSimulator`` (reconfiguration costs itemized in each
        report's ``reconfig``) and ranked under the same objective and
        SLO filters, so the winner may be a switching timetable — or the
        best static plan, an honest negative result.  An empty spec
        returns the static result unchanged (bit-identical to
        ``dynamic=None``).  Dynamic candidates are evaluated fault-free;
        to rank plan switching UNDER faults, drive
        ``DynamicPlanSimulator`` with a ``fault_schedule`` directly.
        """
        t0 = _time.perf_counter()
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
        requests = retag_slo(requests, slo_classes)
        candidates, kv_model = self.candidates(
            quant=quant, feasible_only=feasible_only,
            max_model_dp=max_model_dp, disaggregated=disaggregated,
            transfer_mode=transfer_mode, decode_quant=decode_quant,
            max_disagg_plans=max_disagg_plans, pool_menu=pool_menu,
            max_total_devices=max_total_devices)

        def eval_one(i: int):
            family = candidates[i][0]
            _, sim = self.make_simulator(candidates[i], kv_model)
            sim_kwargs = {} if family == "colocated" else {
                "prefill_policy": prefill_policy,
                "decode_policy": decode_policy}
            rep = sim.simulate(requests, policy=policy,
                               preemption=preemption, **sim_kwargs)
            st = getattr(sim, "cache_stats", None) or {}
            hits, misses = st.get("hits", 0), st.get("misses", 0)
            if faults and rep.feasible:
                members = []
                for f in faults:
                    members.append(sim.simulate(
                        requests, policy=policy, preemption=preemption,
                        faults=f, **sim_kwargs))
                    st = getattr(sim, "cache_stats", None) or {}
                    hits += st.get("hits", 0)
                    misses += st.get("misses", 0)
                rep = attach_resilience(rep, members)
            return rep, hits, misses

        reports, best_idx, hits, misses = self._evaluate_ranked(
            eval_one, len(candidates), obj, slo_ttft_s, slo_tpot_s,
            jobs=jobs, progress=progress, verbose=verbose,
            tag="search",
            label=lambda i: candidates[i][1].label())
        if best_idx is None:
            raise RuntimeError(
                "no feasible plan found (memory or SLO constraints too "
                f"tight) among {len(candidates)} schemes")
        best_plan, _ = self.make_simulator(candidates[best_idx], kv_model)
        result = SearchResult(best=reports[best_idx], best_plan=best_plan,
                              all_reports=reports,
                              num_schemes=len(candidates),
                              num_feasible=sum(r.feasible for r in reports),
                              search_seconds=_time.perf_counter() - t0,
                              objective=objective,
                              slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
                              cache_hits=hits, cache_misses=misses)
        if dynamic is None or dynamic.is_empty:
            return result
        return self._extend_dynamic(result, dynamic, candidates, kv_model,
                                    requests, obj, policy=policy,
                                    preemption=preemption, t0=t0)

    def _extend_dynamic(self, result: SearchResult, spec, candidates,
                        kv_model, requests, obj,
                        policy=None, preemption=None,
                        t0: float = 0.0) -> SearchResult:
        """Rank {static winners} ∪ {epoch schedules over the top-k static
        plans} under one objective (``search(dynamic=...)``'s second
        phase).  Schedule plan indices are ranks into the top-k list."""
        from .dynamic import DynamicPlanSimulator, build_schedules
        ranked = sorted((r for r in result.all_reports
                         if result.admissible(r)), key=obj)[:spec.top_k]
        by_label = {r.plan_label: i for i, r in enumerate(result.all_reports)}
        top_cands = [candidates[by_label[r.plan_label]] for r in ranked]
        if spec.mechanism == "migrate":
            top_cands = [c for c in top_cands if c[0] == "colocated"]
        if len(top_cands) < 2:
            return result          # nothing to switch between
        horizon = max((r.arrival for r in requests), default=0.0)
        schedules = build_schedules(spec, requests, horizon, len(top_cands))
        dyn_reports = []
        for sched in schedules:
            dyn = DynamicPlanSimulator(self, top_cands, sched,
                                       kv_model=kv_model,
                                       mechanism=spec.mechanism)
            dyn_reports.append(dyn.simulate(
                requests, policy=policy, preemption=preemption))
        all_reports = result.all_reports + dyn_reports
        merged = dataclasses.replace(
            result, all_reports=all_reports,
            num_schemes=result.num_schemes + len(dyn_reports),
            num_feasible=sum(r.feasible for r in all_reports),
            search_seconds=_time.perf_counter() - t0)
        winners = [r for r in all_reports if merged.admissible(r)]
        if winners:
            best = min(winners, key=obj)
            if best.plan_label != result.best.plan_label:
                # a switching timetable won: best_plan stays the epoch-0
                # static plan (the deployment you boot into); the full
                # timetable lives in best.reconfig + the plan label
                merged = dataclasses.replace(merged, best=best)
        return merged

    def _evaluate_ranked(self, eval_one: Callable[[int], tuple], n: int,
                         obj: Objective,
                         slo_ttft_s: Optional[float],
                         slo_tpot_s: Optional[float],
                         jobs: int = 1,
                         progress: Optional[Callable] = None,
                         verbose: bool = False,
                         tag: str = "search",
                         label: Optional[Callable[[int], str]] = None):
        """Run ``eval_one`` over ``range(n)`` (serial or forked), track
        the SLO-filtered objective winner, and aggregate cache counters.
        Returns (reports, best_idx, cache_hits, cache_misses)."""
        state = {"best": None, "best_idx": None, "done": 0}
        results: List[tuple] = []
        every = max(1, n // 20)

        def admit(rep) -> bool:
            if not rep.feasible:
                return False
            if slo_ttft_s is not None and rep.ttft_p95 > slo_ttft_s:
                return False
            if slo_tpot_s is not None and rep.tpot_p95 > slo_tpot_s:
                return False
            return True

        def on_result(i: int, rep) -> None:
            if admit(rep) and (state["best"] is None
                               or obj(rep) < obj(state["best"])):
                state["best"] = rep
                state["best_idx"] = i
            state["done"] += 1
            if progress:
                _call_progress(progress, state["done"], n, state["best"])
            if verbose and (state["done"] % every == 0
                            or state["done"] == n):
                b = state["best"]
                cur = (f"best={b.plan_label} obj={obj(b):.4g}"
                       if b is not None else "best=<none feasible>")
                print(f"[{tag}] {state['done']}/{n} evaluated, {cur}")

        def run(i: int):
            res = eval_one(i)
            return res

        ordered = fork_map(run, n, jobs, label=label)
        for i, res in enumerate(ordered):
            results.append(res)
            on_result(i, res[0])
        reports = [r for r, _, _ in results]
        hits = sum(h for _, h, _ in results)
        misses = sum(m for _, _, m in results)
        return reports, state["best_idx"], hits, misses


def compare_three_plans(model: ModelIR, cluster: Cluster,
                        requests: Sequence[Request], quant: str = "fp16",
                        policy: Optional[BatchingPolicy] = None) -> dict:
    """Reproduce a Table-2 row: baseline vs Feasible Optimal vs APEX Optimal."""
    search = ApexSearch(model, cluster)
    base = search.evaluate_baseline(requests, quant=quant, policy=policy)
    feas = search.search(requests, quant=quant, feasible_only=True,
                         policy=policy)
    full = search.search(requests, quant=quant, feasible_only=False,
                         policy=policy)
    return {
        "baseline": base,
        "feasible_optimal": feas.best,
        "apex_optimal": full.best,
        "feasible_speedup": base.e2e_latency / feas.best.e2e_latency,
        "apex_speedup": base.e2e_latency / full.best.e2e_latency,
        "search": full,
    }
