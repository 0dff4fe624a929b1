"""LLM Serving Simulator (paper §3.4).

Estimates per-iteration execution time and energy for an ExecutionPlan by
querying the operation-level ProfileStore, then extrapolates block results
to the full model:

  * only ONE Transformer block is costed; per-stage time multiplies by
    blocks-per-stage (the paper's repetitive-structure trick, Fig. 8),
  * iteration latency = max over pipeline stages (+ inter-stage p2p), since
    continuous batching pipelines successive iterations and the slowest
    stage paces the system (paper: "taking the maximum across all pipeline
    stages"),
  * energy = SUM across all stages and replicas (all devices burn power),
  * cell-level collectives are costed at the network level chosen by the
    Device Mapper.

It reports the paper's serving metrics: TTFT, TPOT, P95 latency, end-to-end
latency, energy, MFU and MBU.

Full-trace simulation runs on the event engine (core/engine.py): each
model-DP replica is an engine actor, and the per-iteration cost callback
is wrapped in a ``StepCostCache`` so identical iterations recurring across
the event stream are costed once (utilization tallies are replayed in
replica order afterwards, keeping MFU/MBU bit-identical to the sequential
accounting of the legacy loop).

The port's copy of ``repro/core/simulator.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .batching import BatchingPolicy, SwapCost
from .cluster import NetworkLevel, host_link
from .engine import Engine, SharedCostStore, StepCostCache
from .ir import Workload
from .mapper import ExecutionPlan
from .metrics import SimulationReport, p95, request_metrics, \
    windowed_metrics
from .profiles import CollectiveModel, ProfileStore
from .quant import get_format
from .templates import reshard_collectives
from .trace import Request, retag_slo

# Backwards-compatible aliases: SimulationReport and the p95 estimator
# used to live here (core/metrics.py is their home now).
_p95 = p95


def default_swap_cost(scheme, link: Optional[NetworkLevel] = None,
                      power=None) -> SwapCost:
    """Price one victim's KV round trip over the device<->host link.

    Each device of the replica swaps its own KV shard concurrently, so
    the delay is the per-device shard's serialization time on ``link``
    (default: the PCIe host link) — out now, back in before resumption,
    hence the factor of two — while energy charges every device of the
    replica at DMA-level utilization for the trip.
    """
    link = link or host_link()
    per_tok = scheme.kv_bytes_per_token_per_device()
    per_seq = scheme.state_bytes_per_seq_per_device()
    n_dev = scheme.devices_per_replica

    def cost(req: Request, kv_tokens: int):
        nbytes = per_tok * kv_tokens + per_seq
        t = nbytes / link.bw_per_device + link.launch_s + link.latency_s
        roundtrip = 2.0 * t
        energy = (power.energy(roundtrip, utilization=0.15) * n_dev
                  if power is not None else 0.0)
        return roundtrip, energy

    return cost


def _cluster_key(cluster) -> tuple:
    """A ``Cluster`` as a hashable tuple (``DeviceSpec.peak_flops`` is a
    dict, so the dataclass itself cannot key a table).  Covers every
    field the profile and collective models read: device rates/power and
    all interconnect levels."""
    d = cluster.device
    return (cluster.name, cluster.num_devices, cluster.levels,
            d.name, tuple(sorted(d.peak_flops.items())), d.hbm_bytes,
            d.hbm_bw, d.idle_power_w, d.peak_power_w, d.base_freq_ghz)


def cost_fingerprint(plan: ExecutionPlan, store: ProfileStore,
                     coll: CollectiveModel, fault_key: tuple = ()) -> tuple:
    """Everything ``PlanSimulator.iteration_cost`` reads, as a hashable key.

    Two plans with equal fingerprints price every workload identically, so
    they may share one ``SharedCostStore`` table.  The fingerprint covers
    the per-stage scheme layout (cells, sharding, blocks-per-stage via
    ``pp_stages``), the quant format, the cluster (device + network specs
    feed both ``ProfileStore.query`` and ``CollectiveModel.query``), the
    pipeline span, and the profile-backend knobs.  It deliberately
    EXCLUDES ``model_dp``: replicas of the same layout run identical
    iterations, and sharing across DP widths is the big cross-plan win.
    All components are frozen dataclasses, so equality is structural.

    ``fault_key`` (``FaultSchedule.cost_key()``) segregates runs under a
    degraded cluster state: straggler-scaled or link-degraded dynamics
    must never reuse (or seed) a healthy state's table.
    """
    scheme = plan.scheme
    base = (scheme.model, scheme.pp_stages, scheme.cell_schemes,
            scheme.quant, plan.stage_span,
            tuple(g.span for g in plan.cell_groups),
            _cluster_key(plan.cluster),
            getattr(store.backend, "freq_ghz", None), store.grid_stride)
    if fault_key:
        base = base + (("faults",) + tuple(fault_key),)
    return base


class PlanSimulator:
    """Costs one ExecutionPlan's iterations and runs full-trace simulations."""

    def __init__(self, plan: ExecutionPlan, store: ProfileStore,
                 coll: CollectiveModel,
                 cost_store: Optional[SharedCostStore] = None):
        self.plan = plan
        self.store = store
        self.coll = coll
        self.cost_store = cost_store
        self._fingerprint: Optional[tuple] = None
        self.scheme = plan.scheme
        self.q = get_format(self.scheme.quant)
        self._flops_accum = 0.0
        self._bytes_accum = 0.0
        self._last_inc = (0.0, 0.0)   # per-call accumulator increment
        # last simulate()'s StepCostCache counters (cost-reuse telemetry)
        self.cache_stats = {"hits": 0, "misses": 0, "entries": 0,
                            "evictions": 0}
        # set by simulate(stop_at=...): unfinished work at the epoch stop
        self.carryover: Optional[dict] = None
        # distinct attention windows in the model (for Workload building)
        self.windows = sorted(
            {getattr(c, "window", None) for c in self.scheme.model.block.cells},
            key=lambda w: (w is None, w))

    def fingerprint(self) -> tuple:
        """This plan's cost-model fingerprint (computed once, cached —
        hashing the scheme's cell tree is not free on the hot path)."""
        if self._fingerprint is None:
            self._fingerprint = cost_fingerprint(self.plan, self.store,
                                                 self.coll)
        return self._fingerprint

    def cost_cache(self, fault_key: tuple = ()) -> StepCostCache:
        """A fresh ``StepCostCache`` for one run: a view onto the shared
        store's fingerprint table when one was provided, private
        otherwise (direct ``PlanSimulator`` use stays golden-identical).
        A non-empty ``fault_key`` selects the degraded-state bucket —
        healthy-state entries are never visible to a faulted run."""
        if self.cost_store is not None:
            fp = self.fingerprint()
            if fault_key:
                fp = fp + (("faults",) + tuple(fault_key),)
            return self.cost_store.cache(fp, self.iteration_cost,
                                         owner=self)
        return StepCostCache(self.iteration_cost, owner=self)

    # -- per-iteration cost (the engine's step_cost callback) -----------------

    def iteration_cost(self, w: Workload) -> Tuple[float, float]:
        """(time_s, energy_j) for one iteration of one replica.

        Pipeline model: the batch is split into ``pp`` microbatches (paper
        §2.4: "input requests are split into micro-batches to flow through
        the pipeline stages"); at steady state (continuous batching keeps
        the pipeline full) the slowest stage paces the system, so one full
        iteration of the whole batch takes  pp * (slowest stage's
        microbatch time).  This is the paper's "max across pipeline stages"
        extrapolation applied at microbatch granularity — and it correctly
        denies PP a latency win in the flat memory-bound decode regime
        (stage time ~ weight reads, independent of microbatch size).

        Side effect: folds the iteration's FLOP/byte tallies into
        ``_flops_accum``/``_bytes_accum`` as ONE increment per call and
        exposes it as ``_last_inc`` so the engine's ``StepCostCache`` can
        replay cached calls into the same accounting.
        """
        if w.is_empty():
            self._last_inc = (0.0, 0.0)
            return 0.0, 0.0
        scheme = self.scheme
        pp = scheme.pp_stages
        mb = w.divided(pp)                    # one microbatch's workload
        stage_time = 0.0                      # per stage-visit (microbatch)
        stage_energy = 0.0
        stage_flops = 0.0
        stage_bytes = 0.0
        enc_flops = 0.0
        # One block's cells on one microbatch, scaled by blocks-per-stage.
        for idx, cs in enumerate(scheme.cell_schemes):
            for op in cs.compute_ops(mb, self.q):
                t, e = self.store.query(op.op, op.axes, op.x)
                stage_time += t * op.count
                stage_energy += e * op.count * cs.devices
                stage_flops += op.flops * cs.devices
                stage_bytes += op.bytes * cs.devices
            for cc in cs.collectives(mb, self.q):
                t, e = self.coll.query(cc.kind, cc.nbytes, cc.group_size)
                stage_time += t
                stage_energy += e
            nxt = scheme.cell_schemes[(idx + 1) % len(scheme.cell_schemes)]
            for cc in reshard_collectives(cs, nxt, mb, self.q,
                                          scheme.stage_devices):
                t, e = self.coll.query(cc.kind, cc.nbytes, cc.group_size)
                stage_time += t
                stage_energy += e
        bps = scheme.blocks_per_stage
        stage_time *= bps
        stage_energy *= bps
        stage_flops *= bps
        stage_bytes *= bps

        # Boundary work on the pacing stage: encoder (first stage) and LM
        # head (last stage) — the slower of the two paces the pipeline.
        extra_time = 0.0
        if scheme.model.encoder is not None and mb.encoder_tokens > 0:
            enc_w = Workload(prefill_tokens=mb.encoder_tokens,
                             windows={None: (float(mb.encoder_tokens) ** 2
                                             / max(1, mb.batch_sequences),
                                             0.0)},
                             batch_sequences=mb.batch_sequences)
            enc_t, enc_e, enc_flops = self._encoder_cost(enc_w)
            extra_time = max(extra_time, enc_t)
            stage_energy += enc_e
        head_tokens = mb.decode_tokens + (1 if mb.prefill_tokens else 0)
        if head_tokens:
            op = scheme.model.lm_head_opcall(head_tokens, self.q)
            t, e = self.store.query(op.op,
                                    (op.axes[0] // scheme.stage_devices,
                                     op.axes[1], op.axes[2]), op.x)
            extra_time = max(extra_time, t)
            stage_energy += e * scheme.stage_devices
            stage_flops += op.flops / pp  # amortize over the pp accounting

        visit_time = stage_time + extra_time
        if pp > 1:
            act = mb.total_tokens * scheme.model.d_model * self.q.act_bytes
            t_p2p, e_p2p = self.coll.query("p2p", act, self.plan.stage_span)
            visit_time += t_p2p
            stage_energy += e_p2p

        # pp stage-visits per microbatch x pp microbatches per iteration:
        iter_time = pp * visit_time
        iter_energy = pp * pp * stage_energy
        inc_f = stage_flops * pp * pp + enc_flops
        inc_b = stage_bytes * pp * pp
        self._flops_accum += inc_f
        self._bytes_accum += inc_b
        self._last_inc = (inc_f, inc_b)
        return iter_time, iter_energy

    def _encoder_cost(self, enc_w: Workload) -> Tuple[float, float, float]:
        enc = self.scheme.model.encoder
        t_total = e_total = f_total = 0.0
        # Encoder cells reuse the FIRST cell scheme's sharding (encoder TP
        # tracks decoder TP — standard enc-dec deployment).
        ref = self.scheme.cell_schemes[0]
        for cell in enc.cells:
            for op in cell.compute(enc_w, self.q):
                t, e = self.store.query(op.op, op.axes, op.x / ref.shard)
                t_total += t
                e_total += e * ref.shard
                f_total += op.flops
        return t_total * enc.repeat, e_total * enc.repeat, f_total

    # -- full-trace simulation --------------------------------------------------

    @staticmethod
    def _collect_carryover(pool) -> dict:
        """Unfinished requests at an epoch stop, for the next segment.

        ``{rid: (request, snapshot, partial_record)}`` where ``snapshot``
        is ``(prefill_done, generated, first_token_time)`` for requests
        with live or swap-parked KV (None for queued, not-yet-started
        ones), and ``partial_record`` carries the progress stats accrued
        so far (preemptions, refetch/swap delays, a stamped first-token
        time) for the controller's record merge."""
        carry: dict = {}
        for rep in pool.replicas:
            for a in rep.active:
                rid = a.req.rid
                carry[rid] = (a.req,
                              (a.prefill_done, a.generated,
                               a.first_token_time),
                              rep.records.get(rid))
            for req in rep.pending:
                snap = rep.swapped.get(req.rid)
                carry[req.rid] = (req, snap, rep.records.get(req.rid))
        return carry

    def simulate(self, requests: Sequence[Request],
                 policy: Optional[BatchingPolicy] = None,
                 keep_records: bool = False,
                 preemption=None,
                 swap_cost: Optional[SwapCost] = None,
                 slo_classes=None,
                 faults=None,
                 window_s: Optional[float] = None,
                 stop_at: Optional[float] = None,
                 carry_in: Optional[dict] = None) -> SimulationReport:
        """``preemption`` selects the KV-overflow policy (menu string or
        ``PreemptionPolicy``; None = sacrifice + recent-first, the
        golden-pinned default); ``swap_cost`` overrides the PCIe host-link
        pricing the swap mechanism defaults to.  ``slo_classes`` re-tags
        the trace's SLO classes by name (``trace.retag_slo``).

        ``faults`` (a ``core.faults.FaultSchedule``) injects fail-stops/
        stragglers into the run; the report then carries a
        ``resilience`` block, and unfinished requests (stranded on a dead
        replica) are dropped from the latency stats.  An empty schedule
        is bit-identical to ``faults=None``.

        ``window_s`` attaches a per-window metric timeline
        (``metrics.windowed_metrics``) to the report — the lens for
        non-stationary traces, where whole-run aggregates hide the peak
        hour.  Admission-rejected requests (see
        ``BatchingPolicy.admission_watermark``) are excluded from the
        latency/goodput stats and counted in ``admission_rejected``.

        ``stop_at`` halts the run at an epoch boundary (core/dynamic.py):
        the engine stops at that instant, unfinished requests are dropped
        from the stats, and ``self.carryover`` maps each unfinished rid to
        ``(request, progress_snapshot_or_None, partial_record_or_None)``
        so the next plan segment can resume them.  ``carry_in`` is the
        inverse: ``{rid: (prefill_done, generated, first_token_time)}``
        snapshots pre-seeded as swap-parked progress, restored without
        recompute when the rid (which must be in ``requests``) is
        admitted."""
        policy = policy or BatchingPolicy()
        scheme = self.scheme
        requests = retag_slo(requests, slo_classes)
        faulted = faults is not None and not faults.empty
        self._flops_accum = 0.0
        self._bytes_accum = 0.0
        cap = scheme.kv_token_capacity(self.plan.cluster.device.hbm_bytes)
        if cap <= 0:
            return SimulationReport.infeasible(scheme.label())

        # model-level DP: round-robin request routing to independent replicas
        buckets: List[List[Request]] = [[] for _ in range(scheme.model_dp)]
        for i, r in enumerate(requests):
            buckets[i % scheme.model_dp].append(r)

        engine = Engine()
        cache = self.cost_cache(
            fault_key=faults.cost_key() if faulted else ())
        pool = engine.add_pool(
            "serve", buckets, cap, policy, cache,
            windows=self.windows,
            is_encdec=scheme.model.encoder is not None,
            preemption=preemption,
            swap_cost=swap_cost or default_swap_cost(
                scheme, power=self.coll.power))
        if carry_in:
            # migrated in-flight progress: park each snapshot on the
            # replica that owns the rid — admission restores it through
            # the swap-in path (no recompute, no first-token re-stamp)
            for rep in pool.replicas:
                for rid, snap in carry_in.items():
                    if rid in rep.records:
                        rep.swapped[rid] = tuple(snap)
        if faulted:
            engine.install_faults(faults)
        if stop_at is not None:
            engine.install_epoch(stop_at, lambda t: engine.stop())
        engine.run()
        self.carryover = (self._collect_carryover(pool)
                          if stop_at is not None else None)
        results = pool.results()
        self.cache_stats = cache.stats()

        # replay the memoized cost calls into the utilization accumulators
        # in replica order (the legacy sequential summation order)
        self._flops_accum = 0.0
        self._bytes_accum = 0.0
        pool.replay_accumulators(self)

        all_records = [rec for res in results for rec in res.records]
        served = [r for r in all_records if not r.rejected]
        if faulted or stop_at is not None:
            # a request stranded on a dead replica (or still in flight at
            # an epoch stop) never finished — excluded from the
            # latency/goodput stats; epoch stops hand it to the next
            # segment via ``self.carryover``
            records = [r for r in served if r.finish_time > 0.0]
        else:
            records = served
        total_time = max(res.total_time for res in results)
        total_energy = sum(res.total_energy for res in results)
        gen_tokens = sum(r.gen_len for r in records)

        n_dev = scheme.total_devices
        peak = self.plan.cluster.device.flops(self.q.compute_dtype)
        bw = self.plan.cluster.device.hbm_bw
        mfu = (self._flops_accum
               / (total_time * n_dev * peak)) if total_time > 0 else 0.0
        mbu = (self._bytes_accum
               / (total_time * n_dev * bw)) if total_time > 0 else 0.0

        resilience = None
        if faulted:
            from .faults import build_resilience
            # admission-rejected requests are accounted separately — they
            # are deliberate drops, not fault-induced ones
            resilience = build_resilience(
                faults, served, total_time,
                {"serve": scheme.model_dp}, engine.fault_requeues)

        return SimulationReport(
            plan_label=scheme.label(),
            e2e_latency=total_time,
            total_energy=total_energy,
            throughput_tok_s=gen_tokens / total_time if total_time else 0.0,
            mfu=min(mfu, 1.0), mbu=min(mbu, 1.0),
            iterations=sum(r.iterations for r in results),
            preemptions=sum(r.preemptions for r in results),
            peak_kv_tokens=max(r.peak_kv_tokens for r in results),
            peak_batch=max(r.peak_batch for r in results),
            feasible=True,
            records=records if keep_records else None,
            swap_outs=sum(r.swap_outs for r in results),
            swap_ins=sum(r.swap_ins for r in results),
            kv_swap_s=sum(r.kv_swap_s for r in results),
            kv_refetch_s=sum(r.kv_refetch_s for r in results),
            resilience=resilience,
            admission_rejected=sum(r.admission_rejected for r in results),
            admission_deferred=sum(r.admission_deferred for r in results),
            windows=(windowed_metrics(records, window_s=window_s,
                                      horizon=total_time)
                     if window_s is not None else None),
            **request_metrics(records, total_time))
