"""Coupled two-pool simulation of disaggregated prefill/decode serving.

Both pools run inside ONE event engine (core/engine.py) on a single
global clock: the prefill pool's replicas run prefill-only iterations
(requests truncated to their first token), finished prompts hand their KV
cache to the decode pool through the KV-transfer model, and the decode
pool runs decode-only continuous batching with *transfer-delayed
admissions* — a request becomes visible to a decode replica when its
transfer completes on the shared cross-pool wire.

Engine coupling (both on by default, switchable for A/B studies):

  * ``congestion=True`` — simultaneous prefill completions contend for
    the cross-pool link: transfers claim a ``SharedLink`` FIFO in
    completion order, each occupying the wire for its full serialization
    time (layerwise streams lead the completion by ``stream_lead_s``).
    With ``congestion=False`` (or a wire fast enough never to queue)
    every transfer takes its independent per-request time — the
    pre-engine behavior, kept as the golden baseline.
  * ``reprefill_occupancy=True`` — a decode-pool preemption routes the
    victim's re-fetch back through the engine as a REAL re-prefill job
    on the prefill pool (occupying it, delaying other prompts' TTFT)
    followed by a fresh transfer over the shared link.  With
    ``reprefill_occupancy=False`` the victim is only charged the
    full-cache wire delay (the pre-engine model: the delay was paid but
    the prefill pool never re-ran the prompt).

Per-pool policies: ``simulate(prefill_policy=..., decode_policy=...)``
(or the same fields on ``DisaggPlan``) drive each pool's replicas with
their own ``SchedulerPolicy`` — e.g. chunked prefill only on the prefill
pool — defaulting to the shared ``policy``.

Heterogeneous pools: when the plan carries per-pool clusters (different
``DeviceSpec`` per pool), each pool's iteration costs, KV capacity, and
energy come from its OWN cluster — per-pool ``ProfileStore`` /
``CollectiveModel`` (and therefore each pool's own ``PowerModel``) — and
the KV handoff is costed on the plan's explicit cross-pool network level.
With a shared cluster this degenerates to the homogeneous behavior.

The port's copy of ``repro/disagg/simulate.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..core.batching import BatchingPolicy, RequestRecord, SwapCost
from ..core.engine import Engine, SharedCostStore, SharedLink
from ..core.ir import Workload
from ..core.metrics import SimulationReport, request_metrics, \
    windowed_metrics
from ..core.profiles import AnalyticBackend, CollectiveModel, ProfileStore
from ..core.simulator import PlanSimulator, default_swap_cost
from ..core.trace import Request, retag_slo
from ..serving.router import BacklogBalancer, derive_drain_rate
from .kv_transfer import KVTransferModel
from .pools import DisaggPlan


class DisaggSimulator:
    """Costs one DisaggPlan by running its two pools against one trace.

    ``store``/``coll`` cost the prefill pool; ``decode_store``/
    ``decode_coll`` the decode pool.  For homogeneous plans the decode-side
    objects default to the prefill-side ones (one shared cluster); for
    heterogeneous plans they default to fresh analytic models of the decode
    pool's own cluster.
    """

    def __init__(self, plan: DisaggPlan, store: ProfileStore,
                 coll: CollectiveModel,
                 kv_model: Optional[KVTransferModel] = None,
                 decode_store: Optional[ProfileStore] = None,
                 decode_coll: Optional[CollectiveModel] = None,
                 cost_store: Optional[SharedCostStore] = None):
        self.plan = plan
        self.scheme = plan.scheme
        if decode_coll is None:
            decode_coll = coll if plan.homogeneous else CollectiveModel(
                plan.decode_cluster, freq_ghz=coll.power.freq_ghz)
        if decode_store is None:
            # inherit frequency/grid granularity from the prefill side so
            # the two pools are costed under one regime
            decode_store = store if plan.homogeneous else ProfileStore(
                AnalyticBackend(plan.decode_cluster,
                                freq_ghz=getattr(store.backend,
                                                 "freq_ghz", None)),
                grid_stride=store.grid_stride)
        if kv_model is None:
            kv_model = KVTransferModel(
                coll, plan.scheme.transfer_mode, link=plan.cross_level,
                endpoint_powers=None if plan.cross_level is None
                else (coll.power, decode_coll.power))
        self.kv = kv_model
        if self.kv.mode != plan.scheme.transfer_mode:
            raise ValueError(
                f"kv_model mode {self.kv.mode!r} != scheme transfer mode "
                f"{plan.scheme.transfer_mode!r}")
        self.pre_sim = PlanSimulator(plan.prefill_plan, store, coll,
                                     cost_store=cost_store)
        self.dec_sim = PlanSimulator(plan.decode_plan, decode_store,
                                     decode_coll, cost_store=cost_store)
        # last simulate()'s combined pool cache counters (cost reuse)
        self.cache_stats = {"hits": 0, "misses": 0, "entries": 0,
                            "evictions": 0}

    # -- helpers --------------------------------------------------------------

    def _drain_rates(self, requests: Sequence[Request],
                     dec_policy: BatchingPolicy) -> tuple:
        """Per-replica drain rates for the two pools' backlog balancers,
        derived from each pool's OWN iteration throughput on a
        trace-representative workload (mean prompt for the prefill pool;
        a mean-KV decode batch for the decode pool)."""
        n = max(1, len(requests))
        ctx = max(1, sum(r.context_len for r in requests) // n)
        gen = max(1, sum(r.gen_len for r in requests) // n)
        w_pre = Workload.from_batch([(ctx, ctx)], [], self.pre_sim.windows,
                                    batch_sequences=1)
        t_pre, _ = self.pre_sim.iteration_cost(w_pre)
        bs = dec_policy.max_batch_size or 32
        w_dec = Workload.from_batch([], [ctx + gen // 2] * bs,
                                    self.dec_sim.windows,
                                    batch_sequences=bs)
        t_dec, _ = self.dec_sim.iteration_cost(w_dec)
        return (derive_drain_rate(ctx, t_pre, fallback=4096.0),
                derive_drain_rate(bs, t_dec, fallback=512.0))

    # -- full-trace simulation ------------------------------------------------

    def simulate(self, requests: Sequence[Request],
                 policy: Optional[BatchingPolicy] = None,
                 keep_records: bool = False,
                 prefill_policy: Optional[BatchingPolicy] = None,
                 decode_policy: Optional[BatchingPolicy] = None,
                 congestion: bool = True,
                 reprefill_occupancy: bool = True,
                 link: Optional[SharedLink] = None,
                 preemption=None,
                 swap_cost: Optional[SwapCost] = None,
                 slo_classes=None,
                 faults=None,
                 window_s: Optional[float] = None) -> SimulationReport:
        """``preemption`` drives BOTH pools' KV-overflow handling (menu
        string or ``PreemptionPolicy``; None = sacrifice + recent-first).
        Under ``swap`` a decode-pool victim's KV parks on the host —
        never leaving the node — so the re-prefill/re-transfer coupling
        (``on_preempt``) fires only for sacrifice.  ``swap_cost``
        overrides the per-pool PCIe host-link pricing; ``slo_classes``
        re-tags the trace's SLO classes by name.

        ``faults`` (a ``core.faults.FaultSchedule``) injects pool-aware
        fail-stops ("prefill"/"decode"/"*" targets), stragglers, and
        cross-pool ``LinkDegradation`` windows (the shared wire's
        transfer times stretch inside them); the report then carries a
        ``resilience`` block.  A decode-pool failure's victims re-fetch
        their prompt KV through the prefill pool, exactly like
        sacrificed preemptees.

        ``window_s`` attaches a per-window metric timeline; per-pool
        policies may carry ``admission_watermark`` gates — rejected
        requests are excluded from the latency stats and counted in
        ``admission_rejected``."""
        plan = self.plan
        requests = retag_slo(requests, slo_classes)
        faulted = faults is not None and not faults.empty
        if faulted and not reprefill_occupancy:
            # the staged baseline drains the two pools back-to-back on
            # detached schedules — a mid-run failure has no coupled
            # dynamics to degrade there
            raise ValueError("fault injection requires "
                             "reprefill_occupancy=True (the coupled "
                             "two-pool mode)")
        pre_pol = (prefill_policy or plan.prefill_policy or policy
                   or BatchingPolicy())
        dec_pol = (decode_policy or plan.decode_policy or policy
                   or BatchingPolicy())
        if pre_pol.mode == "static" or dec_pol.mode == "static":
            # static batching has no meaningful decode-only pool (the
            # strawman prefills and drains one batch at a time); report
            # the plan as infeasible rather than crash mid-search
            return SimulationReport.infeasible(plan.label())
        pre_s, dec_s = self.scheme.prefill, self.scheme.decode
        pre_cap = pre_s.kv_token_capacity(
            plan.prefill_cluster.device.hbm_bytes)
        dec_cap = dec_s.kv_token_capacity(
            plan.decode_cluster.device.hbm_bytes)
        if pre_cap <= 0 or dec_cap <= 0:
            return SimulationReport.infeasible(plan.label())

        is_encdec = self.scheme.model.encoder is not None
        by_rid = {r.rid: r for r in requests}
        lanes = min(pre_s.devices_per_replica, dec_s.devices_per_replica)
        ests: Dict[int, object] = {}

        def est_of(req: Request):
            if req.rid not in ests:
                ests[req.rid] = self.kv.estimate(
                    self.scheme.model, req.context_len, pre_s.quant,
                    plan.transfer_span, lanes=lanes)
            return ests[req.rid]

        pre_rate, dec_rate = self._drain_rates(requests, dec_pol)

        # ---- prefill pool: prefill-only iterations, balancer-routed ----
        # (decayed shortest-queue dispatch — the same balancer the serving
        # PoolRouter uses, so simulated and real dispatch agree; the
        # balancer instance stays live to also place re-prefill jobs)
        pre_reqs = [dataclasses.replace(r, gen_len=1) for r in requests]
        pre_bal = BacklogBalancer(pre_s.model_dp, drain_rate=pre_rate)
        pre_buckets: List[List[Request]] = [[] for _ in range(pre_s.model_dp)]
        for r in sorted(pre_reqs, key=lambda r: (r.arrival, r.rid)):
            pre_buckets[pre_bal.assign(r.arrival,
                                       float(r.context_len))].append(r)

        engine = Engine()
        if link is None:
            link = SharedLink(congestion=congestion,
                              degradation=faults.link_factor
                              if faulted and faults.link_faults else None)
        elif faulted and faults.link_faults and link.degradation is None:
            link.degradation = faults.link_factor
        dec_bal = BacklogBalancer(dec_s.model_dp, drain_rate=dec_rate)
        parked: Dict[int, tuple] = {}   # refetch rid -> (replica, req, t0)
        state = {"refetch_seq": 0}
        finishes: List[tuple] = []      # staged mode: (finish_time, req)

        def on_prefill_finish(replica, req, rec, now):
            if not reprefill_occupancy:
                # no decode->prefill feedback: transfers are resolved in
                # finish order after the prefill pool drains (staged run),
                # which hands the decode pool its full arrival horizon —
                # the same information structure as the pre-engine loops
                finishes.append((now, by_rid[req.rid]))
                return
            if req.rid < 0:
                # a re-prefill occupancy job completed: re-ship the cache
                # and return the victim to its decode replica
                dec_rep, victim, t0 = parked.pop(req.rid)
                est = est_of(victim)
                done = link.transfer(now, est)
                dec_pool.incoming_unknown -= 1

                def stamp_and_route(t, rep=dec_rep, v=victim, t0=t0):
                    vrec = rep.records[v.rid]
                    vrec.refetch_s += t - t0
                    rep.kv_refetch_s += t - t0
                    return rep

                engine.deliver(dec_pool, stamp_and_route,
                               dataclasses.replace(victim, arrival=done),
                               done)
                return
            orig = by_rid[req.rid]
            if orig.gen_len <= 1:       # finishes at the prefill pool
                return
            done = link.transfer(now, est_of(orig))
            engine.deliver(
                dec_pool,
                lambda t, g=float(orig.gen_len):
                dec_pool.replicas[dec_bal.assign(t, g)],
                dataclasses.replace(orig, arrival=done), done)

        def on_decode_preempt(dec_rep, victim, now):
            # route the re-fetch through the engine: a REAL re-prefill on
            # the prefill pool (occupying it), then a fresh transfer.
            # Placement reads the prefill replicas' LIVE queue depth (the
            # trace pre-pass balancer's clock has already run to the last
            # arrival and would see a stale, future-contaminated backlog)
            state["refetch_seq"] -= 1
            rid = state["refetch_seq"]
            job = Request(rid=rid, arrival=now,
                          context_len=victim.context_len, gen_len=1,
                          source_len=victim.source_len)
            parked[rid] = (dec_rep, victim, now)
            dec_pool.incoming_unknown += 1
            target = min(
                pre_pool.replicas,
                key=lambda rep: (sum(r.context_len for r in rep.pending)
                                 + sum(a.prefill_remaining
                                       for a in rep.active), rep.index))
            target.shadow.add(rid)
            engine.deliver(pre_pool, target, job, now)

        def refetch_wire_delay(r: Request) -> float:
            # delay-only model: full-cache wire time (no prefill left to
            # stream behind), costed through the same transfer model
            return est_of(r).wire_s

        fault_key = faults.cost_key() if faulted else ()
        dec_cache = self.dec_sim.cost_cache(fault_key=fault_key)
        pre_cache = self.pre_sim.cost_cache(fault_key=fault_key)

        def add_decode_pool(buckets):
            return engine.add_pool(
                "decode", buckets, dec_cap, dec_pol, dec_cache,
                windows=self.dec_sim.windows, is_encdec=is_encdec,
                role="decode",
                refetch_delay=None if reprefill_occupancy
                else refetch_wire_delay,
                on_preempt=on_decode_preempt if reprefill_occupancy
                else None,
                preemption=preemption,
                swap_cost=swap_cost or default_swap_cost(
                    dec_s, power=self.dec_sim.coll.power))

        pre_pool = engine.add_pool(
            "prefill", pre_buckets, pre_cap, pre_pol, pre_cache,
            windows=self.pre_sim.windows, is_encdec=is_encdec,
            on_finish=on_prefill_finish,
            preemption=preemption,
            swap_cost=swap_cost or default_swap_cost(
                pre_s, power=self.pre_sim.coll.power))
        if reprefill_occupancy:
            # fully coupled: one joint event loop; transfers and re-fetch
            # re-prefills flow between the pools as live events
            dec_pool = add_decode_pool([[] for _ in range(dec_s.model_dp)])
            dec_pool.upstream = pre_pool   # bounds decode fast-forward
            if faulted:
                engine.install_faults(faults)
            engine.run()
        else:
            # staged: drain the prefill pool, resolve transfers through
            # the (possibly congested) link in completion order, then run
            # the decode pool with every arrival known
            engine.run()
            dec_reqs = []
            for t_finish, req in finishes:
                if req.gen_len <= 1:
                    continue
                done = link.transfer(t_finish, est_of(req))
                dec_reqs.append(dataclasses.replace(req, arrival=done))
            dec_buckets: List[List[Request]] = [
                [] for _ in range(dec_s.model_dp)]
            for r in sorted(dec_reqs, key=lambda r: (r.arrival, r.rid)):
                dec_buckets[dec_bal.assign(r.arrival,
                                           float(r.gen_len))].append(r)
            dec_pool = add_decode_pool(dec_buckets)
            engine.run()

        pre_results = pre_pool.results()
        dec_results = dec_pool.results()
        self.cache_stats = {
            k: pre_cache.stats()[k] + dec_cache.stats()[k]
            for k in ("hits", "misses", "entries", "evictions")}
        results = pre_results + dec_results
        if not results:
            return SimulationReport.infeasible(plan.label())

        # replay memoized cost calls into the utilization accumulators in
        # pool/replica order (the legacy sequential summation order)
        for sim, pool in ((self.pre_sim, pre_pool),
                          (self.dec_sim, dec_pool)):
            sim._flops_accum = 0.0
            sim._bytes_accum = 0.0
            pool.replay_accumulators(sim)

        pre_records: Dict[int, RequestRecord] = {
            rec.rid: rec for res in pre_results for rec in res.records}
        dec_records: Dict[int, RequestRecord] = {
            rec.rid: rec for res in dec_results for rec in res.records}

        # ---- transfer energy: every shipped cache + every re-fetch ----
        # (energy is congestion-independent — the same bytes cross the
        # wire whether or not they queued)
        transfer_energy = 0.0
        for rid in pre_records:
            req = by_rid[rid]
            if req.gen_len <= 1:
                continue
            transfer_energy += est_of(req).energy_j
        for rec in dec_records.values():
            # only sacrificed victims re-ship over the wire; a swapped
            # victim's KV parks on the host and never crosses the link
            sacrifices = rec.preemptions - rec.swaps
            if sacrifices > 0:
                transfer_energy += sacrifices * est_of(
                    by_rid[rec.rid]).energy_j

        # ---- merge per-request records across the two pools ----
        merged: List[RequestRecord] = []
        for rid, pre_rec in sorted(pre_records.items()):
            req = by_rid[rid]
            rec = RequestRecord(rid, req.arrival, req.context_len,
                                req.gen_len, slo_class=req.slo_class)
            rec.first_token_time = pre_rec.first_token_time
            rec.rejected = pre_rec.rejected
            dec_rec = dec_records.get(rid)
            if dec_rec is not None:
                rec.finish_time = dec_rec.finish_time
                rec.preemptions = pre_rec.preemptions + dec_rec.preemptions
                rec.refetch_s = dec_rec.refetch_s
                rec.swaps = pre_rec.swaps + dec_rec.swaps
                rec.swap_s = pre_rec.swap_s + dec_rec.swap_s
                rec.rejected = rec.rejected or dec_rec.rejected
            else:                      # gen_len == 1: done at prefill
                rec.finish_time = pre_rec.finish_time
                rec.preemptions = pre_rec.preemptions
                rec.swaps = pre_rec.swaps
                rec.swap_s = pre_rec.swap_s
            merged.append(rec)

        merged = [r for r in merged if not r.rejected]
        all_merged = merged
        if faulted:
            # stranded on a dead replica with no survivor: never finished
            merged = [r for r in merged if r.finish_time > 0.0]
        total_time = max(res.total_time for res in results)
        total_energy = (sum(res.total_energy for res in results)
                        + transfer_energy)
        gen_tokens = sum(r.gen_len for r in merged)

        # utilization against each pool's OWN silicon: a H100-prefill/
        # H200-decode deployment is normalized by the sum of per-pool
        # peak rates, not one device's numbers
        pre_dev = plan.prefill_cluster.device
        dec_dev = plan.decode_cluster.device
        n_pre, n_dec = self.scheme.prefill_devices, self.scheme.decode_devices
        flops = self.pre_sim._flops_accum + self.dec_sim._flops_accum
        nbytes = self.pre_sim._bytes_accum + self.dec_sim._bytes_accum
        peak = (n_pre * pre_dev.flops(self.pre_sim.q.compute_dtype)
                + n_dec * dec_dev.flops(self.dec_sim.q.compute_dtype))
        bw = n_pre * pre_dev.hbm_bw + n_dec * dec_dev.hbm_bw
        mfu = flops / (total_time * peak) if total_time > 0 else 0.0
        mbu = nbytes / (total_time * bw) if total_time > 0 else 0.0

        resilience = None
        if faulted:
            from ..core.faults import build_resilience
            resilience = build_resilience(
                faults, all_merged, total_time,
                {"prefill": pre_s.model_dp, "decode": dec_s.model_dp},
                engine.fault_requeues)

        return SimulationReport(
            plan_label=plan.label(),
            e2e_latency=total_time,
            total_energy=total_energy,
            throughput_tok_s=gen_tokens / total_time if total_time else 0.0,
            mfu=min(mfu, 1.0), mbu=min(mbu, 1.0),
            iterations=sum(r.iterations for r in results),
            preemptions=sum(r.preemptions for r in results),
            peak_kv_tokens=max(r.peak_kv_tokens for r in results),
            peak_batch=max(r.peak_batch for r in results),
            feasible=True,
            records=merged if keep_records else None,
            swap_outs=sum(r.swap_outs for r in results),
            swap_ins=sum(r.swap_ins for r in results),
            kv_swap_s=sum(r.kv_swap_s for r in results),
            kv_refetch_s=sum(r.kv_refetch_s for r in results),
            resilience=resilience,
            admission_rejected=sum(r.admission_rejected for r in results),
            admission_deferred=sum(r.admission_deferred for r in results),
            windows=(windowed_metrics(merged, window_s=window_s,
                                      horizon=total_time)
                     if window_s is not None else None),
            **request_metrics(merged, total_time))
