"""Epoch-gated dynamic re-planning (non-stationary serving).

A static parallel plan is tuned for ONE operating point; a non-stationary
trace (diurnal swings, bursts — core/trace.py's ``ArrivalProcess``) sweeps
through many.  This module asks the natural follow-up question: does
SWITCHING plans at epoch boundaries beat the best static plan once the
switch itself is priced honestly?

``DynamicPlanSimulator`` runs one ``EpochSchedule`` — a piecewise-constant
map from time to a plan index over a shared candidate list — and charges
every reconfiguration with modeled costs, never zero:

  * **weight re-shard**: the incoming plan's per-device weight bytes move
    over the cluster interconnect (``CollectiveModel.query("p2p", ...)``);
  * **KV hand-off**, one of two mechanisms:
      - ``"drain"``  — the outgoing plan keeps serving its admitted and
        queued requests to completion past the boundary; the new plan
        starts only after the drain finishes AND the re-shard lands
        (the cluster is shared, so late arrivals queue and eat the wait
        in their TTFT).  Works for every plan family, including
        disaggregated pools.
      - ``"migrate"`` — the outgoing engine stops AT the boundary;
        in-flight KV caches ship to the new plan's layout (priced per
        request through ``KVTransferModel``, blocking mode) and resume
        without recompute via the engine's swap-restore admission path.
        Colocated plans only (a mid-flight pool hand-off has no
        well-defined owner for a half-prefilled cache).

The per-switch bill lands in the report's ``reconfig``
(``ReconfigReport``) and the per-epoch timeline in ``windows``
(``metrics.windowed_metrics`` at the epoch boundaries), so a search over
{best static} ∪ {epoch schedules} compares like with like — and can
return an honest negative result when switching doesn't pay.

Schedule constructors cover the three controller policies:
``EpochSchedule.static`` / explicit epochs (oracle), ``reactive_schedule``
(trailing-epoch arrival rate with a causal lag), and ``fault_schedule``
(fall back to a degraded-mode plan inside fault windows,
``FaultSchedule.windows``).

The port's copy of ``repro/core/dynamic.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .batching import BatchingPolicy, RequestRecord
from .metrics import SimulationReport, request_metrics, windowed_metrics
from .trace import Request


# ---------------------------------------------------------------------------
# epoch schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpochSchedule:
    """A piecewise-constant plan timetable: ``epochs[k] = (start_s, plan)``
    activates candidate index ``plan`` from ``start_s`` until the next
    epoch's start (the last epoch runs to the end of the trace).  The
    first epoch must start at 0; consecutive epochs with the same plan
    are collapsed (a no-op switch costs nothing and is not a switch)."""

    epochs: Tuple[Tuple[float, int], ...]

    def __post_init__(self):
        eps = tuple((float(t), int(p)) for t, p in self.epochs)
        if not eps:
            raise ValueError("EpochSchedule needs at least one epoch")
        if eps[0][0] != 0.0:
            raise ValueError(
                f"first epoch must start at t=0, got {eps[0][0]}")
        for (a, _), (b, _) in zip(eps, eps[1:]):
            if b <= a:
                raise ValueError(
                    f"epoch starts must be strictly increasing "
                    f"({a} then {b})")
        for t, p in eps:
            if p < 0:
                raise ValueError(f"plan index must be >= 0, got {p}")
        # collapse consecutive same-plan epochs
        merged = [eps[0]]
        for t, p in eps[1:]:
            if p != merged[-1][1]:
                merged.append((t, p))
        object.__setattr__(self, "epochs", tuple(merged))

    @classmethod
    def static(cls, plan: int = 0) -> "EpochSchedule":
        """The degenerate one-epoch schedule: plan ``plan`` forever."""
        return cls(epochs=((0.0, plan),))

    @property
    def starts(self) -> List[float]:
        return [t for t, _ in self.epochs]

    @property
    def plans(self) -> List[int]:
        return [p for _, p in self.epochs]

    @property
    def num_switches(self) -> int:
        return len(self.epochs) - 1

    @property
    def is_static(self) -> bool:
        return len(self.epochs) == 1

    def plan_at(self, t: float) -> int:
        idx = bisect.bisect_right(self.starts, t) - 1
        return self.epochs[max(idx, 0)][1]

    def label(self) -> str:
        if self.is_static:
            return f"static(plan {self.epochs[0][1]})"
        return " | ".join(f"{t:g}s→p{p}" for t, p in self.epochs)


def reactive_schedule(requests: Sequence[Request], epoch_s: float,
                      horizon_s: float, lo_plan: int, hi_plan: int,
                      threshold_rps: Optional[float] = None,
                      lag: int = 1) -> EpochSchedule:
    """Load-watermark controller: epoch ``k`` runs ``hi_plan`` when the
    REALIZED arrival rate of epoch ``k - lag`` exceeded the threshold,
    ``lo_plan`` otherwise.  ``lag >= 1`` keeps the controller causal (it
    reacts to rates it has already observed — the first ``lag`` epochs
    default to ``lo_plan``); ``threshold_rps=None`` uses the trace's mean
    rate over the horizon."""
    if epoch_s <= 0:
        raise ValueError(f"epoch_s must be positive, got {epoch_s}")
    if horizon_s <= 0:
        raise ValueError(f"horizon_s must be positive, got {horizon_s}")
    if lag < 1:
        raise ValueError(f"lag must be >= 1 (causal), got {lag}")
    n = max(1, int(math.ceil(horizon_s / epoch_s)))
    counts = [0] * n
    for r in requests:
        k = min(int(r.arrival / epoch_s), n - 1)
        counts[k] += 1
    if threshold_rps is None:
        threshold_rps = len(requests) / horizon_s
    epochs = []
    for k in range(n):
        if k < lag:
            plan = lo_plan
        else:
            plan = hi_plan if counts[k - lag] / epoch_s > threshold_rps \
                else lo_plan
        epochs.append((k * epoch_s, plan))
    return EpochSchedule(epochs=tuple(epochs))


def fault_schedule(faults, horizon_s: float, primary: int,
                   fallback: int) -> EpochSchedule:
    """Fault-triggered controller: run ``fallback`` inside the schedule's
    merged degraded windows (``FaultSchedule.windows``), ``primary``
    everywhere else.  Window edges become the epoch boundaries."""
    if horizon_s <= 0:
        raise ValueError(f"horizon_s must be positive, got {horizon_s}")
    epochs: List[Tuple[float, int]] = [(0.0, primary)]
    for a, b in faults.windows(horizon_s):
        if a <= 0.0:
            epochs[0] = (0.0, fallback)
        else:
            epochs.append((a, fallback))
        if b < horizon_s:
            epochs.append((b, primary))
    return EpochSchedule(epochs=tuple(epochs))


# ---------------------------------------------------------------------------
# search integration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DynamicSpec:
    """What ``ApexSearch.search(dynamic=...)`` should try beyond the best
    static plan.  Plan indices in ``schedules`` are RANKS into the static
    search's top-``top_k`` plans (0 = static winner), not raw candidate
    indices — so a spec is portable across searches.  An empty spec (no
    ``schedules``, no ``epoch_s``) makes the search return the static
    result unchanged."""

    epoch_s: Optional[float] = None      # reactive controller's epoch grid
    top_k: int = 3                       # static finalists schedules draw on
    mechanism: str = "drain"             # "drain" | "migrate"
    schedules: Tuple[EpochSchedule, ...] = ()   # explicit (oracle) schedules
    threshold_rps: Optional[float] = None       # reactive watermark
    lag: int = 1                                # reactive causal lag (epochs)

    def __post_init__(self):
        object.__setattr__(self, "schedules", tuple(self.schedules))
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.mechanism not in ("drain", "migrate"):
            raise ValueError(f"unknown mechanism {self.mechanism!r}")
        if self.epoch_s is not None and self.epoch_s <= 0:
            raise ValueError(f"epoch_s must be positive, got {self.epoch_s}")

    @property
    def is_empty(self) -> bool:
        return not self.schedules and self.epoch_s is None


def build_schedules(spec: DynamicSpec, requests: Sequence[Request],
                    horizon_s: float, k: int) -> List[EpochSchedule]:
    """The schedules a search evaluates for ``spec`` over ``k`` available
    finalist plans: the explicit (oracle) ones, plus — when ``epoch_s``
    is set — one reactive load-watermark schedule per ordered (lo, hi)
    finalist pair.  Degenerate (static, no-switch) schedules are dropped:
    the static sweep already covers them."""
    out: List[EpochSchedule] = []
    seen = set()
    for s in spec.schedules:
        if max(s.plans) >= k:
            raise ValueError(
                f"schedule {s.label()!r} references rank {max(s.plans)} "
                f"but only {k} finalist plans are available")
        if not s.is_static and s.epochs not in seen:
            seen.add(s.epochs)
            out.append(s)
    if spec.epoch_s is not None and horizon_s > 0:
        for lo in range(k):
            for hi in range(k):
                if lo == hi:
                    continue
                s = reactive_schedule(
                    requests, spec.epoch_s, horizon_s, lo_plan=lo,
                    hi_plan=hi, threshold_rps=spec.threshold_rps,
                    lag=spec.lag)
                if not s.is_static and s.epochs not in seen:
                    seen.add(s.epochs)
                    out.append(s)
    return out


# ---------------------------------------------------------------------------
# reconfiguration accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SwitchCost:
    """The itemized bill for one plan switch."""

    at_s: float                  # epoch boundary
    from_plan: str               # outgoing plan label
    to_plan: str                 # incoming plan label
    reshard_s: float             # weight re-shard time
    reshard_bytes: float         # weight bytes moved
    migrate_s: float = 0.0       # in-flight KV migration time (migrate)
    migrate_bytes: float = 0.0   # KV bytes moved
    migrated: int = 0            # in-flight requests carried across
    drain_s: float = 0.0         # old-plan overrun past the boundary (drain)
    drained: int = 0             # requests the old plan finished late
    energy_j: float = 0.0        # re-shard + migration transfer energy

    @property
    def stall_s(self) -> float:
        """Time past the boundary before the new plan starts serving."""
        return self.drain_s + self.reshard_s + self.migrate_s


@dataclasses.dataclass
class ReconfigReport:
    """All of a dynamic run's switches plus mechanism-level totals."""

    mechanism: str                       # "drain" | "migrate"
    switches: List[SwitchCost] = dataclasses.field(default_factory=list)

    @property
    def num_switches(self) -> int:
        return len(self.switches)

    @property
    def total_stall_s(self) -> float:
        return sum(s.stall_s for s in self.switches)

    @property
    def total_reshard_s(self) -> float:
        return sum(s.reshard_s for s in self.switches)

    @property
    def total_migrate_bytes(self) -> float:
        return sum(s.migrate_bytes for s in self.switches)

    @property
    def total_energy_j(self) -> float:
        return sum(s.energy_j for s in self.switches)

    def summary(self) -> str:
        if not self.switches:
            return f"reconfig({self.mechanism}): no switches"
        moved = sum(s.migrated for s in self.switches)
        drained = sum(s.drained for s in self.switches)
        parts = [f"{self.num_switches} switches",
                 f"stall={self.total_stall_s:.2f}s",
                 f"reshard={self.total_reshard_s:.2f}s"]
        if moved:
            parts.append(f"migrated={moved} "
                         f"({self.total_migrate_bytes / 1e9:.2f} GB)")
        if drained:
            parts.append(f"drained={drained}")
        parts.append(f"energy={self.total_energy_j:.0f}J")
        return f"reconfig({self.mechanism}): " + ", ".join(parts)


# ---------------------------------------------------------------------------
# the dynamic simulator
# ---------------------------------------------------------------------------

class DynamicPlanSimulator:
    """Runs one ``EpochSchedule`` over a shared candidate list.

    ``search`` is an ``ApexSearch`` (cost models + plan mapping);
    ``candidates`` the ``(family, scheme, pools)`` tuples the schedule's
    plan indices select from (``ApexSearch.candidates()`` order, or any
    explicit list); ``kv_model`` prices disaggregated hand-off inside a
    segment (as in the static path) — migration across switches is always
    priced blocking (the whole cache ships before resumption).
    """

    def __init__(self, search, candidates: Sequence, schedule: EpochSchedule,
                 kv_model=None, mechanism: str = "drain"):
        if mechanism not in ("drain", "migrate"):
            raise ValueError(f"unknown mechanism {mechanism!r} "
                             f"(expected 'drain' or 'migrate')")
        if not candidates:
            raise ValueError("DynamicPlanSimulator needs candidates")
        for _, p in schedule.epochs:
            if p >= len(candidates):
                raise ValueError(
                    f"schedule references plan {p} but only "
                    f"{len(candidates)} candidates were given")
        if mechanism == "migrate":
            bad = [p for p in schedule.plans
                   if candidates[p][0] != "colocated"]
            if bad:
                raise ValueError(
                    "migrate mechanism requires colocated plans "
                    f"(schedule uses disaggregated plan(s) {sorted(set(bad))}"
                    "); use mechanism='drain'")
        self.search = search
        self.candidates = list(candidates)
        self.schedule = schedule
        self.kv_model = kv_model
        self.mechanism = mechanism
        from ..disagg.kv_transfer import KVTransferModel
        self._ktm = KVTransferModel(search.coll, mode="blocking")

    # -- pricing ------------------------------------------------------------

    def _scheme(self, idx: int):
        return self.candidates[idx][1]

    def _reshard_cost(self, idx: int) -> Tuple[float, float, float]:
        """(time_s, bytes, energy_j) to lay the incoming plan's weights
        out: every device pulls its shard over the cluster interconnect.
        Disaggregated plans re-shard both pools concurrently (max time,
        summed bytes/energy)."""
        family, scheme, _ = self.candidates[idx]
        coll = self.search.coll
        span = self.search.cluster.num_devices
        schemes = [scheme] if family == "colocated" \
            else [scheme.prefill, scheme.decode]
        t = b = e = 0.0
        for s in schemes:
            nbytes = s.weight_bytes_per_device()
            dt, de = coll.query("p2p", nbytes, span)
            t = max(t, dt)
            b += nbytes
            e += de
        return t, b, e

    def _migrate_cost(self, carry: dict, old_idx: int, new_idx: int
                      ) -> Tuple[float, float, float, int]:
        """(time_s, bytes, energy_j, n_moved) to ship every in-flight KV
        cache to the new layout.  Transfers share the wire (serial sum);
        each runs ``lanes`` parallel per-device streams — the narrower of
        the two replica widths bounds the pairing."""
        old = self._scheme(old_idx)
        new = self._scheme(new_idx)
        lanes = max(1, min(old.devices_per_replica, new.devices_per_replica))
        span = self.search.cluster.num_devices
        t = b = e = 0.0
        moved = 0
        for _, snap, _ in carry.values():
            if snap is None:
                continue
            kv_tokens = int(snap[0]) + int(snap[1])
            if kv_tokens <= 0:
                continue
            est = self._ktm.estimate(old.model, kv_tokens, old.quant,
                                     span, lanes=lanes)
            t += est.delay_s
            b += est.nbytes
            e += est.energy_j
            moved += 1
        return t, b, e, moved

    # -- record merge -------------------------------------------------------

    @staticmethod
    def _merge_into(merged: Dict[int, RequestRecord], rec, orig: Request
                    ) -> None:
        m = merged.get(rec.rid)
        if m is None:
            m = RequestRecord(rid=rec.rid, arrival=orig.arrival,
                              context_len=orig.context_len,
                              gen_len=orig.gen_len,
                              slo_class=rec.slo_class)
            merged[rec.rid] = m
        if m.first_token_time == 0.0 and rec.first_token_time > 0.0:
            m.first_token_time = rec.first_token_time
        if rec.finish_time > 0.0:
            m.finish_time = rec.finish_time
        m.preemptions += rec.preemptions
        m.refetch_s += rec.refetch_s
        m.swaps += rec.swaps
        m.swap_s += rec.swap_s

    # -- simulation ---------------------------------------------------------

    def simulate(self, requests: Sequence[Request],
                 policy: Optional[BatchingPolicy] = None,
                 keep_records: bool = False,
                 preemption=None,
                 slo_classes=None,
                 faults=None) -> SimulationReport:
        """Run the schedule over ``requests`` and return one merged
        ``SimulationReport``: whole-run aggregates, per-epoch ``windows``,
        and the itemized ``reconfig`` bill.  ``faults`` passes through to
        every drain-mode segment (absolute fault times line up with the
        shared clock); migrate mode rejects faults — stopping an engine
        inside a fault window would double-count the disruption."""
        sched = self.schedule
        if faults is not None and not faults.empty \
                and self.mechanism == "migrate":
            raise ValueError("faults are not supported with "
                             "mechanism='migrate'; use 'drain'")
        orig: Dict[int, Request] = {r.rid: r for r in requests}
        starts = sched.starts
        seg_reqs: List[List[Request]] = [[] for _ in sched.epochs]
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            k = bisect.bisect_right(starts, r.arrival) - 1
            seg_reqs[max(k, 0)].append(r)

        reconfig = ReconfigReport(mechanism=self.mechanism)
        merged: Dict[int, RequestRecord] = {}
        carry: dict = {}              # rid -> (req, snapshot, partial_record)
        ready = 0.0                   # when the active plan can serve
        prev_idx: Optional[int] = None
        prev_end = 0.0                # previous segment's absolute end time
        total_energy = 0.0
        iterations = preemptions = 0
        peak_kv = peak_batch = 0
        swap_outs = swap_ins = 0
        kv_swap_s = kv_refetch_s = 0.0
        adm_rej = adm_def = 0
        end_time = 0.0
        util = []                     # (weight_s, mfu, mbu) per segment
        labels = []

        for k, (start, pidx) in enumerate(sched.epochs):
            nxt = starts[k + 1] if k + 1 < len(sched.epochs) else None
            scheme = self._scheme(pidx)
            labels.append((start, scheme.label()))

            # -- reconfiguration bill at this boundary --
            if prev_idx is not None:
                rs_t, rs_b, rs_e = self._reshard_cost(pidx)
                mig_t = mig_b = mig_e = 0.0
                moved = 0
                drain_s = 0.0
                drained = 0
                if self.mechanism == "migrate":
                    mig_t, mig_b, mig_e, moved = self._migrate_cost(
                        carry, prev_idx, pidx)
                    ready = start + rs_t + mig_t
                else:
                    drain_s = max(0.0, prev_end - start)
                    drained = sum(
                        1 for m in merged.values()
                        if m.finish_time > start and m.arrival < start)
                    ready = max(start, prev_end) + rs_t
                reconfig.switches.append(SwitchCost(
                    at_s=start,
                    from_plan=self._scheme(prev_idx).label(),
                    to_plan=scheme.label(),
                    reshard_s=rs_t, reshard_bytes=rs_b,
                    migrate_s=mig_t, migrate_bytes=mig_b, migrated=moved,
                    drain_s=drain_s, drained=drained,
                    energy_j=rs_e + mig_e))
                total_energy += rs_e + mig_e

            # -- assemble the segment's request set --
            seg = list(seg_reqs[k])
            carry_in = None
            if carry:
                seg = [req for req, _, _ in carry.values()] + seg
                carry_in = {rid: snap for rid, (_, snap, _) in carry.items()
                            if snap is not None}
            if not seg:
                carry = {}
                prev_idx = pidx
                continue
            bumped = [dataclasses.replace(r, arrival=max(r.arrival, ready))
                      for r in seg]

            _, sim = self.search.make_simulator(self.candidates[pidx],
                                                self.kv_model)
            kwargs = dict(policy=policy, keep_records=True,
                          preemption=preemption, slo_classes=slo_classes)
            if self.mechanism == "migrate":
                rep = sim.simulate(bumped, stop_at=nxt,
                                   carry_in=carry_in or None, **kwargs)
                carry = dict(sim.carryover or {})
            else:
                rep = sim.simulate(bumped, faults=faults, **kwargs)
                carry = {}
            if not rep.feasible:
                return SimulationReport.infeasible(self._dyn_label(labels))

            # -- merge the segment into the whole-run view --
            for rec in rep.records or []:
                self._merge_into(merged, rec, orig[rec.rid])
            for rid, (_, _, prec) in carry.items():
                # partial progress of requests still in flight at the stop
                if prec is not None:
                    self._merge_into(merged, prec, orig[rid])
            total_energy += rep.total_energy
            iterations += rep.iterations
            preemptions += rep.preemptions
            peak_kv = max(peak_kv, rep.peak_kv_tokens)
            peak_batch = max(peak_batch, rep.peak_batch)
            swap_outs += rep.swap_outs
            swap_ins += rep.swap_ins
            kv_swap_s += rep.kv_swap_s
            kv_refetch_s += rep.kv_refetch_s
            adm_rej += rep.admission_rejected
            adm_def += rep.admission_deferred
            prev_end = rep.e2e_latency
            end_time = max(end_time, rep.e2e_latency)
            util.append((max(rep.e2e_latency - start, 0.0),
                         rep.mfu, rep.mbu))
            prev_idx = pidx

        # requests still unfinished after the final segment (migrate mode
        # never stops the last segment, so this is empty there; defensive)
        records = [m for m in merged.values() if m.finish_time > 0.0]
        records.sort(key=lambda r: r.rid)
        total_time = max([end_time] + [r.finish_time for r in records]) \
            if records or end_time else 0.0
        gen_tokens = sum(r.gen_len for r in records)
        wsum = sum(w for w, _, _ in util)
        mfu = sum(w * m for w, m, _ in util) / wsum if wsum > 0 else 0.0
        mbu = sum(w * b for w, _, b in util) / wsum if wsum > 0 else 0.0

        return SimulationReport(
            plan_label=self._dyn_label(labels),
            e2e_latency=total_time,
            total_energy=total_energy,
            throughput_tok_s=gen_tokens / total_time if total_time else 0.0,
            mfu=mfu, mbu=mbu,
            iterations=iterations,
            preemptions=preemptions,
            peak_kv_tokens=peak_kv,
            peak_batch=peak_batch,
            feasible=True,
            records=records if keep_records else None,
            swap_outs=swap_outs, swap_ins=swap_ins,
            kv_swap_s=kv_swap_s, kv_refetch_s=kv_refetch_s,
            admission_rejected=adm_rej,
            admission_deferred=adm_def,
            reconfig=reconfig,
            windows=windowed_metrics(records, boundaries=starts,
                                     horizon=total_time),
            **request_metrics(records, total_time))

    def _dyn_label(self, labels: List[Tuple[float, str]]) -> str:
        if len(labels) == 1:
            return f"dyn-{self.mechanism}[{labels[0][1]}]"
        return (f"dyn-{self.mechanism}["
                + " | ".join(f"{t:g}s:{lab}" for t, lab in labels) + "]")
