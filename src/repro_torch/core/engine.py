"""Event-driven simulation core — one engine for every serving topology.

The dynamism-aware simulation that used to live in three divergent
hand-rolled loops (``BatchingModule._run_continuous``, ``_run_static``,
and the disaggregated simulator's coupled two-pool dance) is expressed
here once, as a global-clock discrete-event machine:

  * a single event heap orders *deliveries* (a request arriving at a
    replica: a routed admission, a finished KV handoff, a re-fetch
    return) and *iteration ends* (a replica's batch completing) across
    every replica of every pool;
  * each replica is an actor whose batch-construction, admission and
    preemption logic comes from a ``SchedulerPolicy`` — continuous
    batching (with chunked prefill and the decode-only pool role) and
    static batching are policy variants of one actor lifecycle, not
    separate loops;
  * a ``SharedLink`` resource serializes cross-pool KV transfers through
    a FIFO wire so simultaneous prefill completions contend for the
    min-bandwidth link instead of transferring independently;
  * a ``StepCostCache`` memoizes the (workload -> time, energy) cost
    boundary per plan, so identical iterations recurring across the
    event stream are priced once.

Single-replica colocated simulation through the engine is numerically
identical to the deleted per-replica loops (frozen goldens in
tests/test_engine_golden.py): a replica's event chain performs exactly
the old loop's arithmetic; the heap only interleaves independent chains.

Extension points:

  * subclass ``SchedulerPolicy`` (``admit`` / ``build`` / ``apply``) to
    model a new batching discipline — priority scheduling, fairness
    quanta, speculative-decode steps — and pass it anywhere a
    ``BatchingPolicy`` config is accepted today;
  * subclass ``PreemptionPolicy`` (``select`` / ``evict``) to model a
    new KV-overflow response.  The built-in menu crosses two mechanisms
    — ``sacrifice`` (drop the victim's KV and recompute, the paper's
    default) and ``swap`` (park the KV on the host over a PCIe-class
    link and restore it later, progress preserved) — with two victim
    orders — ``recent-first`` (LIFO, the paper's rule) and
    ``lowest-priority-first`` (evict the cheapest SLO class first).
    Any scheduler composes with any preemption policy; in the disagg
    decode role the ``on_preempt`` re-prefill coupling fires only for
    sacrifice (a swapped victim's KV never left the node).

The port's copy of ``repro/core/engine.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .batching import (BatchingPolicy, BatchingResult, RefetchDelay,
                       RequestRecord, StepCost, SwapCost)
from .ir import Workload
from .trace import Request

# Event priority classes at equal timestamps: deliveries must land in a
# replica's pending queue before an iteration boundary at the same time
# inspects it (legacy semantics: admission admits ``arrival <= now``).
# Fault transitions (fail-stop / repair, core/faults.py) fire before
# both, so a delivery at the instant of a failure already sees the
# replica down and reroutes to a survivor.
_PRIO_FAULT = 0
_PRIO_EPOCH = 1
_PRIO_DELIVER = 2
_PRIO_ITER_END = 3


# ---------------------------------------------------------------------------
# step-cost memoization
# ---------------------------------------------------------------------------

# A day-long trace at ~10 req/s with per-request workload churn produces
# on the order of 10^5 distinct workload signatures per plan family; the
# default bound comfortably holds several searches' worth of tables while
# capping worst-case memory at a few hundred MB (entries are small
# tuples).  Override per cache/store when profiling long traces.
DEFAULT_COST_CACHE_SIZE = 200_000


class _CostTable(OrderedDict):
    """Bounded LRU map from ``Workload.signature()`` to cost entries.

    Plain ``OrderedDict`` with an eviction counter: lookups that hit
    refresh recency, inserts past ``maxsize`` evict the least recently
    used entry.  Shared by every ``StepCostCache`` view onto the same
    plan-fingerprint bucket of a ``SharedCostStore``.
    """

    def __init__(self, maxsize: int = DEFAULT_COST_CACHE_SIZE):
        super().__init__()
        self.maxsize = maxsize
        self.evictions = 0

    def lookup(self, key: tuple) -> Optional[tuple]:
        ent = self.get(key)
        if ent is not None:
            self.move_to_end(key)
        return ent

    def store(self, key: tuple, ent: tuple) -> None:
        self[key] = ent
        self.move_to_end(key)
        while len(self) > self.maxsize:
            self.popitem(last=False)
            self.evictions += 1


class StepCostCache:
    """Memoized (time, energy) lookups on the engine's cost boundary.

    Keyed by ``Workload.signature()``.  The wrapped callback may tally
    per-call FLOP/byte increments on its owner (``PlanSimulator``'s
    ``_last_inc``); the cache stores that increment with the hit entry so
    utilization accounting can be replayed in deterministic replica order
    after the run — identical whether or not a workload hit the cache.

    The backing ``table`` may be private (default) or a ``_CostTable``
    handed in by a ``SharedCostStore``, in which case entries priced by
    one simulator are visible to every later simulator with the same
    cost-model fingerprint.  Hit/miss counters are always per-view, so
    ``stats()`` still describes *this* run; ``entries``/``evictions``
    describe the backing table.
    """

    def __init__(self, step_cost: StepCost, owner=None,
                 maxsize: int = DEFAULT_COST_CACHE_SIZE,
                 table: Optional[_CostTable] = None):
        self.step_cost = step_cost
        self.owner = owner
        self.table: _CostTable = table if table is not None \
            else _CostTable(maxsize)
        self.hits = 0
        self.misses = 0

    def stats(self) -> Dict[str, int]:
        """Hit/miss counters for cost-reuse observability (reported by
        the search as per-plan aggregates and by bench_core.py)."""
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self.table),
                "evictions": self.table.evictions}

    def reset_stats(self) -> None:
        self.hits = 0
        self.misses = 0

    def cost(self, w: Workload) -> tuple:
        """(time_s, energy_j, (flops_inc, bytes_inc)) for one iteration."""
        key = w.signature()
        ent = self.table.lookup(key)
        if ent is None:
            t, e = self.step_cost(w)
            inc = getattr(self.owner, "_last_inc", (0.0, 0.0)) \
                if self.owner is not None else (0.0, 0.0)
            ent = (t, e, inc)
            self.table.store(key, ent)
            self.misses += 1
        else:
            self.hits += 1
        return ent


class SharedCostStore:
    """Cross-plan step-cost store, keyed by cost-model fingerprint.

    Candidate plans in a search overwhelmingly share per-stage schemes —
    e.g. every ``model_dp`` width of one layout prices iterations
    identically — so a search-scoped store lets the thousands of
    identical decode-step workloads recurring across sibling candidates
    be priced once per search instead of once per plan.  Two levels keep
    the hot path cheap: a simulator resolves its fingerprint to a
    ``_CostTable`` once, then per-step lookups hash only the workload
    signature.

    Fingerprints (``core.simulator.cost_fingerprint``) cover everything
    ``iteration_cost`` reads — scheme layout, quant format, cluster
    device/network specs, profile-backend knobs — so plans that differ
    in any cost-relevant way can never share a bucket (tested
    adversarially in tests/test_halving.py).

    With ``search(jobs=N)`` the store is pre-seeded in the parent (by
    fluid screening probes and any earlier runs) and each forked worker
    inherits that snapshot copy-on-write; entries priced inside a worker
    stay in the worker.  Costs are deterministic functions of the
    fingerprint+signature key, so sharing never changes results — only
    how often ``step_cost`` is re-run.
    """

    def __init__(self, maxsize: int = DEFAULT_COST_CACHE_SIZE):
        self.maxsize = maxsize
        self.tables: Dict[tuple, _CostTable] = {}

    def table(self, fingerprint: tuple) -> _CostTable:
        tab = self.tables.get(fingerprint)
        if tab is None:
            tab = self.tables[fingerprint] = _CostTable(self.maxsize)
        return tab

    def cache(self, fingerprint: tuple, step_cost: StepCost,
              owner=None) -> StepCostCache:
        """A per-run ``StepCostCache`` view onto this store's table for
        ``fingerprint`` (fresh hit/miss counters, shared entries)."""
        return StepCostCache(step_cost, owner=owner,
                             table=self.table(fingerprint))

    def stats(self) -> Dict[str, int]:
        return {"tables": len(self.tables),
                "entries": sum(len(t) for t in self.tables.values()),
                "evictions": sum(t.evictions for t in self.tables.values())}


# ---------------------------------------------------------------------------
# shared cross-pool wire
# ---------------------------------------------------------------------------

class SharedLink:
    """FIFO congestion model of the cross-pool KV wire.

    Transfers claim the wire in prefill-completion order.  A layerwise
    transfer streamed all but its last chunk behind the prefill, so its
    wire occupancy window *ends*, uncontended, at
    ``finish + delay_s`` — modeled as a contiguous ``wire_s`` window
    starting ``stream_lead_s`` before the prefill completed.  When the
    wire is still busy at that start time, the window (and the decode
    pool's admission) slides later: simultaneous completions queue.

    ``congestion=False`` reproduces the independent-per-request transfer
    model exactly (so does any link fast enough never to queue).

    ``degradation`` (optional, ``time -> factor >= 1``) models a
    fault-injected bandwidth drop: the wire/delay components of a
    transfer starting while the factor exceeds 1 stretch by it.  The
    default (None) is arithmetically identical to factor 1.0.
    """

    def __init__(self, congestion: bool = True,
                 degradation: Optional[Callable[[float], float]] = None):
        self.congestion = congestion
        self.degradation = degradation
        self.free_at = 0.0
        self.queued_s = 0.0          # total queuing delay added by contention
        self.degraded_s = 0.0        # extra wire time added by degradation

    def transfer(self, finish_time: float, est) -> float:
        """Completion time of a transfer whose prefill ended at
        ``finish_time``, with per-request costs ``est``
        (a ``TransferEstimate``)."""
        f = self.degradation(finish_time) if self.degradation else 1.0
        independent = finish_time + est.delay_s * f
        if not self.congestion:
            self.degraded_s += est.delay_s * (f - 1.0)
            return independent
        self.degraded_s += est.wire_s * (f - 1.0)
        start = max(finish_time - est.stream_lead_s * f, self.free_at)
        done = start + est.wire_s * f
        self.free_at = done
        self.queued_s += max(0.0, done - independent)
        return done


# ---------------------------------------------------------------------------
# active-request state (moved from the legacy BatchingModule)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Active:
    req: Request
    admitted_at: float
    order: int                    # admission order (for preemption LIFO)
    prefill_done: int = 0         # prompt tokens already processed
    generated: int = 0            # output tokens produced
    first_token_time: Optional[float] = None

    @property
    def kv_tokens(self) -> int:
        return self.prefill_done + self.generated

    @property
    def kv_reserved(self) -> int:
        """Admission-time reservation: an admitted request's prompt KV is
        committed even before its prefill runs (prevents admission storms
        that thrash prefill/evict cycles and starve decodes)."""
        return max(self.req.context_len, self.kv_tokens)

    @property
    def prefill_remaining(self) -> int:
        return self.req.context_len - self.prefill_done

    @property
    def done(self) -> bool:
        return self.generated >= self.req.gen_len

    def reset(self) -> None:
        self.prefill_done = 0
        self.generated = 0
        self.first_token_time = None


# ---------------------------------------------------------------------------
# preemption policies (victim selection x eviction mechanism)
# ---------------------------------------------------------------------------

class PreemptionPolicy:
    """What happens when a replica's KV memory overflows.

    Two orthogonal axes, each a subclass hook:

      * ``select(A)`` — WHICH active request to evict.  ``recent``
        (default) is the paper's LIFO rule: the most recently admitted
        request goes first.  ``priority`` evicts the lowest
        ``SLOClass.priority`` first (most-recent within a class), so a
        latency-sensitive tenant survives pressure from a batchy one.
      * ``evict(A, victim, now)`` — HOW to free the memory (the
        mechanism subclasses implement).

    ``overflow`` preserves the engine's two invariants verbatim: evict
    until KV fits, and never evict the last active request (a single
    sequence whose prompt+generation exceeds capacity must run to
    completion — evicting it would requeue-loop forever).
    """

    mechanism = "abstract"

    def __init__(self, victim: str = "recent"):
        victim = _VICTIM_ALIASES.get(victim, victim)
        if victim not in ("recent", "priority"):
            raise ValueError(
                f"unknown victim order {victim!r}; known: recent-first, "
                f"lowest-priority-first")
        self.victim = victim

    def select(self, A: "Replica") -> "_Active":
        if self.victim == "priority":
            return max(A.active,
                       key=lambda a: (-a.req.slo_class.priority, a.order))
        return max(A.active, key=lambda a: a.order)

    def evict(self, A: "Replica", victim: "_Active", now: float) -> None:
        raise NotImplementedError

    def overflow(self, A: "Replica", now: float) -> None:
        while A.kv_used() > A.capacity and len(A.active) > 1:
            victim = self.select(A)
            A.active.remove(victim)
            A.records[victim.req.rid].preemptions += 1
            A.preemptions += 1
            self.evict(A, victim, now)

    def label(self) -> str:
        return f"{self.mechanism}/{self.victim}"


class SacrificePolicy(PreemptionPolicy):
    """Drop the victim's KV and recompute from scratch (paper §3.3's
    only mode, and still the default).  In the disagg decode role the
    shipped prompt KV is gone, so the victim must re-fetch it — the
    ``on_preempt`` re-prefill coupling fires here and ONLY here."""

    mechanism = "sacrifice"

    def evict(self, A: "Replica", victim: "_Active", now: float) -> None:
        victim.reset()
        if A.role == "decode":
            # the shipped prompt KV was dropped; the victim only
            # becomes admissible again after re-fetching it
            A.refetch(victim.req, now)
        else:
            A.pending.insert(0, victim.req)


class SwapPolicy(PreemptionPolicy):
    """Move the victim's KV to host memory and bring it back later —
    progress preserved, no recompute.  The victim re-enters the pending
    queue ``delay`` seconds out, where ``delay`` is the host-link round
    trip (swap-out now + swap-in before resumption) priced by the pool's
    ``swap_cost`` callback over a PCIe-class ``NetworkLevel``; on
    re-admission its prefill/decode counters are restored from the
    parked snapshot.  Works identically in the decode role: the KV never
    left the node, so no re-prefill and no wire re-ship."""

    mechanism = "swap"

    def evict(self, A: "Replica", victim: "_Active", now: float) -> None:
        delay, energy = A.pool.swap_cost(victim.req, victim.kv_tokens)
        delay = max(0.0, delay)
        rec = A.records[victim.req.rid]
        rec.swaps += 1
        rec.swap_s += delay
        A.swap_outs += 1
        A.kv_swap_s += delay
        A.energy += energy
        A.swapped[victim.req.rid] = (victim.prefill_done, victim.generated,
                                     victim.first_token_time)
        ready = now + delay
        re_req = dataclasses.replace(victim.req, arrival=ready)
        idx = 0
        while (idx < len(A.pending)
               and A.pending[idx].arrival <= ready):
            idx += 1
        A.pending.insert(idx, re_req)


_VICTIM_ALIASES = {
    "recent-first": "recent", "lifo": "recent",
    "lowest-priority-first": "priority", "lowest-priority": "priority",
}
_MECHANISMS = {"sacrifice": SacrificePolicy, "swap": SwapPolicy}


def make_preemption(spec) -> PreemptionPolicy:
    """Resolve the ``preemption=`` plumbing: None (the default,
    sacrifice + recent-first), a ``PreemptionPolicy`` instance, or a
    menu string ``"<mechanism>[/<victim>]"`` — e.g. ``"swap"``,
    ``"sacrifice/lowest-priority-first"``."""
    if spec is None:
        return SacrificePolicy()
    if isinstance(spec, PreemptionPolicy):
        return spec
    mechanism, _, victim = str(spec).partition("/")
    if mechanism not in _MECHANISMS:
        raise ValueError(f"unknown preemption mechanism {mechanism!r}; "
                         f"known: {sorted(_MECHANISMS)}")
    return _MECHANISMS[mechanism](victim or "recent")


# ---------------------------------------------------------------------------
# scheduler policies
# ---------------------------------------------------------------------------

class SchedulerPolicy:
    """Batch construction + admission + preemption for one replica actor.

    Subclass hooks (all operate on a ``Replica``'s state):
      * ``admit(A)``  — move arrived pending requests into ``A.active``
                        (may advance ``A.now`` for clock-jumping modes);
      * ``build(A)``  — assemble one iteration's batch, returning
                        ``(iter_prefills, iter_decodes, workload)``;
      * ``apply(A, prefills, decodes, dur)`` — apply the iteration's
                        effects at ``A.now`` (completions, fast-forward,
                        preemption).
    """

    def __init__(self, cfg: BatchingPolicy):
        self.cfg = cfg

    def admit(self, A: "Replica") -> None:
        raise NotImplementedError

    def build(self, A: "Replica"):
        raise NotImplementedError

    def apply(self, A: "Replica", prefills, decodes, dur: float) -> None:
        raise NotImplementedError


class ContinuousScheduler(SchedulerPolicy):
    """Iteration-level continuous batching (paper §3.3): greedy
    memory-gated admission, contiguous or Sarathi-chunked prefill, LIFO
    preemption on KV overflow, fast-forward over uneventful decode runs.
    ``role="decode"`` models the decode pool of a disaggregated
    deployment (admission materializes the shipped prompt KV)."""

    # -- admission (greedy, memory-gated) --
    # headroom of one decode token per active sequence prevents the
    # admit -> prefill -> immediately-evict livelock
    def admit(self, A: "Replica") -> None:
        cfg = self.cfg
        while A.pending and A.pending[0].arrival <= A.now:
            # a swap-parked victim's demand is its full parked KV
            # (prompt + generated so far), not just its prompt
            saved = A.swapped.get(A.pending[0].rid) if A.swapped else None
            demand = (saved[0] + saved[1]) if saved is not None \
                else A.pending[0].context_len
            # memory-threshold admission control: when projected KV
            # occupancy would cross the watermark, defer (hold in queue)
            # or reject (drop, counted) the head instead of admitting
            # into near-certain preemption.  A busy watermark never
            # starves: the liveness rule below still admits onto an
            # idle replica, so every deferred request eventually runs.
            wm = cfg.admission_watermark
            if wm is not None and A.active:
                projected = A.kv_reserved() + demand
                if projected > wm * A.capacity:
                    req = A.pending[0]
                    if cfg.admission_mode == "reject":
                        A.pending.pop(0)
                        rec = A.records[req.rid]
                        rec.rejected = True
                        rec.finish_time = 0.0
                        A.admission_rejected += 1
                        continue
                    if req.rid not in A.deferred_rids:
                        A.deferred_rids.add(req.rid)
                        A.admission_deferred += 1
                    break
            headroom = len(A.active) + 1
            cap_ok = (A.kv_reserved() + demand
                      + headroom <= A.capacity)
            # liveness: an idle engine always admits its head request,
            # even one whose prompt alone exceeds KV capacity (it runs
            # solo and may overshoot — dual of never-evict-last)
            if not A.active:
                cap_ok = True
            seq_ok = len(A.active) < A.max_sequences
            bs_ok = (cfg.max_batch_size is None
                     or len(A.active) < cfg.max_batch_size)
            if not (cap_ok and seq_ok and bs_ok):
                break
            req = A.pending.pop(0)
            a = _Active(req=req, admitted_at=A.now, order=A.order)
            A.order += 1
            if saved is not None:
                # swap-in: restore the parked progress snapshot — no
                # recompute, no first-token re-stamp, and (enc-dec) no
                # re-run of the encoder
                del A.swapped[req.rid]
                a.prefill_done, a.generated, a.first_token_time = saved
                A.swap_ins += 1
                A.active.append(a)
                continue
            if A.role == "decode":
                # prompt KV arrived from the prefill pool; the first
                # token was already emitted there.  Standalone records
                # stamp first-token at FIRST admission only (a re-fetch
                # after preemption does not re-emit the first token); a
                # coupled simulation overwrites it with the prefill
                # pool's timestamp.
                a.prefill_done = req.context_len
                a.generated = 1
                a.first_token_time = A.now
                rec = A.records[req.rid]
                if rec.preemptions == 0:
                    rec.first_token_time = A.now
                if a.done:          # gen_len <= 1: nothing to decode
                    rec.finish_time = A.now
                    A.finish(req, rec, A.now)
                    continue
            A.active.append(a)
            A.new_admissions.append(a)

    def build(self, A: "Replica"):
        cfg = self.cfg
        prefills = [a for a in A.active if a.prefill_remaining > 0]
        decodes = [a for a in A.active if a.prefill_remaining == 0
                   and not a.done]
        chunk = cfg.chunked_prefill
        iter_prefills: List[Tuple[_Active, int]] = []
        budget = cfg.max_prefill_tokens
        for a in prefills:
            if budget <= 0:
                break
            take = min(a.prefill_remaining, budget)
            if chunk is not None:
                take = min(take, chunk)
            iter_prefills.append((a, take))
            budget -= take
            if chunk is None and budget <= 0:
                break
        # contiguous batching: prefill iterations exclude decodes;
        # chunked prefill mixes them (Sarathi-style).
        iter_decodes = decodes if (chunk is not None or not iter_prefills) \
            else []
        w = A.workload(iter_prefills, iter_decodes, A.new_admissions)
        A.new_admissions = []
        return iter_prefills, iter_decodes, w

    def apply(self, A: "Replica", iter_prefills, iter_decodes,
              dur: float) -> None:
        now = A.now
        notified = set()          # finish-callback dedup within this step
        for a, take in iter_prefills:
            a.prefill_done += take
            if a.prefill_remaining == 0:
                # prompt fully processed -> first token emitted
                a.generated = 1
                a.first_token_time = now
                rec = A.records[a.req.rid]
                rec.first_token_time = now
                if a.done:
                    rec.finish_time = now
                    notified.add(a.req.rid)
                    A.finish(a.req, rec, now)
        for a in iter_decodes:
            a.generated += 1
        # sample peak BEFORE completions release their KV: the true
        # peak includes each finishing request's final token
        A.peak_kv = max(A.peak_kv, A.kv_used())

        finished = [a for a in A.active if a.done]
        for a in finished:
            rec = A.records[a.req.rid]
            rec.finish_time = now
            if a.req.rid not in notified:
                A.finish(a.req, rec, now)
        A.active = [a for a in A.active if not a.done]

        # ---- fast-forward uneventful decode runs ----
        if (self.cfg.fast_forward and not iter_prefills and A.active
                and all(a.prefill_remaining == 0 for a in A.active)):
            steps = self._ff_steps(A, dur)
            if steps > 1:
                kv_lens = [a.kv_tokens for a in A.active]
                mid = [k + steps // 2 for k in kv_lens]
                w_mid = A.workload_decode(mid, len(A.active))
                d_mid, e_mid = A.cost(w_mid)
                scale = A.step_scale()
                if scale != 1.0:
                    # the whole run stays inside one straggler regime:
                    # _ff_steps is bounded by the next fault transition
                    d_mid *= scale
                    e_mid *= scale
                for a in A.active:
                    a.generated += steps
                # per-token times: uniform at d_mid
                A.now = now = now + d_mid * steps
                A.energy += e_mid * steps
                A.iters += steps
                # peak inside the run = KV total at the END of the run
                # (no arrival/completion/overflow can occur within it),
                # just before completions are removed
                A.peak_kv = max(A.peak_kv,
                                sum(kv_lens) + steps * len(A.active))
                finished = [a for a in A.active if a.done]
                for a in finished:
                    over = a.generated - a.req.gen_len
                    rec = A.records[a.req.rid]
                    rec.finish_time = now - d_mid * over
                    a.generated = a.req.gen_len
                    A.finish(a.req, rec, rec.finish_time)
                A.active = [a for a in A.active if not a.done]

        # ---- KV overflow -> the pool's PreemptionPolicy decides ----
        # (default: sacrifice + recent-first, the paper's §3.3 rule)
        A.pool.preemption.overflow(A, now)
        A.peak_kv = max(A.peak_kv, A.kv_used())

    def _ff_steps(self, A: "Replica", dur: float) -> int:
        """Max decode steps guaranteed uneventful (no completion,
        arrival — local pending OR in-flight engine delivery — or
        overflow)."""
        to_finish = min(a.req.gen_len - a.generated for a in A.active)
        kv = sum(a.kv_tokens for a in A.active)
        to_overflow = max(0, (A.capacity - kv)) // max(1, len(A.active))
        cap = self.cfg.fast_forward_cap
        steps = min(to_finish, to_overflow, cap)
        nxt = A.next_arrival_bound()
        if nxt is not None and dur > 0:
            to_arrival = int((nxt - A.now) / dur)
            steps = min(steps, max(0, to_arrival))
        return max(steps, 0)


class StaticScheduler(SchedulerPolicy):
    """Static batching (paper §2.3 strawman): admit a fixed batch, prefill
    it whole, decode until EVERY member finishes (the inefficiency the
    paper motivates against), only then admit the next batch.  Finished
    members keep their KV until the batch drains."""

    def admit(self, A: "Replica") -> None:
        if A.active or not A.pending:
            return
        bs = self.cfg.max_batch_size or 32
        batch: List[Request] = []
        kv = 0
        while (A.pending and len(batch) < bs
               and kv + A.pending[0].context_len <= A.capacity):
            r = A.pending.pop(0)
            batch.append(r)
            kv += r.context_len
        if not batch:
            # head prompt alone exceeds KV capacity: admit it solo and
            # let it overshoot (the continuous path's liveness rule —
            # refusing it would loop forever with no progress)
            batch.append(A.pending.pop(0))
        # static batching waits for the whole batch to assemble
        A.now = max(A.now, max(r.arrival for r in batch))
        acts = [_Active(req=r, admitted_at=A.now, order=j)
                for j, r in enumerate(batch)]
        A.active.extend(acts)
        A.new_admissions.extend(acts)
        A.peak_batch = max(A.peak_batch, len(batch))

    def build(self, A: "Replica"):
        prefills = [a for a in A.active if a.prefill_remaining > 0]
        if prefills:
            iter_prefills = [(a, a.prefill_remaining) for a in prefills]
            w = A.workload(iter_prefills, [], A.new_admissions)
            A.new_admissions = []
            return iter_prefills, [], w
        live = [a for a in A.active if not a.done]
        return [], live, A.workload_decode([a.kv_tokens for a in live],
                                           len(live))

    def apply(self, A: "Replica", iter_prefills, iter_decodes,
              dur: float) -> None:
        now = A.now
        if iter_prefills:
            for a, take in iter_prefills:
                a.prefill_done += take
                a.generated = 1
                rec = A.records[a.req.rid]
                rec.first_token_time = now
                if a.done:        # gen_len == 1: done at prefill end,
                    # not when the whole batch drains
                    rec.finish_time = now
                    A.finish(a.req, rec, now)
        else:
            for a in A.active:
                if not a.done:
                    a.generated += 1
                    if a.done:
                        rec = A.records[a.req.rid]
                        rec.finish_time = now
                        A.finish(a.req, rec, now)
        # finished members hold their KV until the batch drains
        A.peak_kv = max(A.peak_kv, sum(a.kv_tokens for a in A.active))
        if all(a.done for a in A.active):
            A.active = []


def make_policy(cfg: BatchingPolicy) -> SchedulerPolicy:
    if cfg.admission_watermark is not None:
        if not 0.0 < cfg.admission_watermark <= 1.0:
            raise ValueError(f"admission_watermark must be in (0, 1], "
                             f"got {cfg.admission_watermark}")
        if cfg.admission_mode not in ("defer", "reject"):
            raise ValueError(f"unknown admission_mode "
                             f"{cfg.admission_mode!r} (defer|reject)")
        if cfg.mode == "static":
            raise ValueError("admission_watermark requires continuous "
                             "batching (static admission is batch-gated)")
    if cfg.mode == "static":
        return StaticScheduler(cfg)
    if cfg.mode == "continuous":
        return ContinuousScheduler(cfg)
    raise ValueError(f"unknown batching mode {cfg.mode!r}")


# ---------------------------------------------------------------------------
# replica actor
# ---------------------------------------------------------------------------

class Replica:
    """One replica's batching state, advanced by engine events.

    The actor's lifecycle per iteration — admit, build, cost, schedule
    the iteration-end event, then (when it fires) apply effects and start
    the next iteration — performs exactly the arithmetic of the legacy
    per-replica loop; the policy object owns every mode-specific step.
    """

    def __init__(self, pool: "Pool", index: int,
                 requests: Sequence[Request]):
        self.pool = pool
        self.index = index
        self.pending: List[Request] = sorted(requests,
                                             key=lambda r: r.arrival)
        self.records: Dict[int, RequestRecord] = {
            r.rid: RequestRecord(r.rid, r.arrival, r.context_len, r.gen_len,
                                 slo_class=r.slo_class)
            for r in requests}
        self.shadow: set = set()      # rids of engine-internal jobs
        self.active: List[_Active] = []
        self.swapped: Dict[int, tuple] = {}   # rid -> parked progress
        self.new_admissions: List[_Active] = []
        self.now = 0.0
        self.busy = False
        self._busy_until: Optional[float] = None  # scheduled iteration end
        self._wake_at: Optional[float] = None   # pending idle-wake event
        self.failed = False           # fail-stopped (core/faults.py)
        self.fail_epoch = 0           # invalidates in-flight iteration ends
        self.order = 0
        self.iters = 0
        self.energy = 0.0
        self.preemptions = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.kv_swap_s = 0.0
        self.peak_kv = 0
        self.peak_batch = 0
        self.kv_refetch_s = 0.0
        self.admission_rejected = 0
        self.admission_deferred = 0
        self.deferred_rids: set = set()   # dedup for the deferred counter
        self.cost_calls: List[tuple] = []    # (flops_inc, bytes_inc)
        self._refetch_cache: Dict[int, float] = {}

    # -- config shortcuts --------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.pool.capacity

    @property
    def max_sequences(self) -> int:
        return self.pool.live_max_sequences()

    @property
    def role(self) -> str:
        return self.pool.role

    def kv_used(self) -> int:
        return sum(a.kv_tokens for a in self.active)

    def kv_reserved(self) -> int:
        return sum(a.kv_reserved for a in self.active)

    # -- cost boundary -----------------------------------------------------

    def cost(self, w: Workload) -> Tuple[float, float]:
        cache = self.pool.cache
        if cache is not None:
            t, e, inc = cache.cost(w)
            self.cost_calls.append(inc)
            return t, e
        return self.pool.step_cost(w)

    def step_scale(self) -> float:
        """Straggler slowdown factor at ``now`` — applied AFTER the cost
        lookup so degraded iterations never pollute the (fault-free)
        step-cost cache, and so fault-free runs stay bit-identical."""
        if not self.pool.stragglers:
            return 1.0
        return self.pool.slowdown(self, self.now)

    # -- event handlers ----------------------------------------------------

    def advance(self) -> None:
        """Run admissions and start the next iteration (or go idle)."""
        if self.busy or self.failed:
            return
        policy = self.pool.policy
        while True:
            policy.admit(self)
            if self.active:
                prefills, decodes, w = policy.build(self)
                dur, en = self.cost(w)
                scale = self.step_scale()
                if scale != 1.0:
                    dur *= scale
                    en *= scale
                self.energy += en
                self.iters += 1
                self.peak_batch = max(self.peak_batch,
                                      len(prefills) + len(decodes))
                self.busy = True
                self._busy_until = self.now + dur
                self.pool.engine.schedule(
                    self.now + dur, _PRIO_ITER_END, self.order,
                    lambda t, p=prefills, d=decodes, dd=dur,
                    ep=self.fail_epoch:
                    self.on_iter_end(t, p, d, dd, ep))
                return
            if self.pending:
                t = self.pending[0].arrival
                if t <= self.now:
                    # arrived but refused by the policy with an empty
                    # batch (no standard policy does this); jump to keep
                    # liveness rather than deadlock
                    self.now = t
                    continue
                # sleep until the next KNOWN arrival — committing the
                # iteration now would run past any delivery (a transfer,
                # a re-fetch return) landing in the skipped idle window,
                # so wake through the heap and let earlier events win
                if self._wake_at is None or self._wake_at > t:
                    self._wake_at = t
                    self.pool.engine.schedule(
                        t, _PRIO_ITER_END, self.order, self.on_wake)
                return
            return                      # idle; a delivery may wake us

    def on_wake(self, t: float) -> None:
        if self._wake_at is not None and self._wake_at <= t:
            self._wake_at = None
        if self.busy or self.failed:
            return                      # a delivery already woke us
        self.now = max(self.now, t)
        self.advance()

    def on_iter_end(self, now: float, prefills, decodes,
                    dur: float, epoch: Optional[int] = None) -> None:
        if epoch is not None and epoch != self.fail_epoch:
            return      # the iteration was aborted by a fail-stop
        self.busy = False
        self._busy_until = None
        self.now = now
        self.pool.policy.apply(self, prefills, decodes, dur)
        self.advance()

    # -- fault transitions (core/faults.py) --------------------------------

    def fail(self, now: float) -> None:
        """Fail-stop: the in-flight iteration and all KV (device AND
        host-parked) are lost.  Active and pending requests re-queue to
        surviving replicas through the pool's sacrifice/recompute path
        (graceful degradation); with no survivor they wait here for
        repair."""
        if self.failed:
            return
        self.failed = True
        self.fail_epoch += 1            # invalidates the in-flight step
        self.now = max(self.now, now)
        self.busy = False
        self._busy_until = None
        self._wake_at = None
        victims = self.active
        self.active = []
        self.swapped.clear()            # host-parked KV dies with the node
        pending = self.pending
        self.pending = []
        self.pool.on_replica_fail(self, victims, pending, now)

    def repair(self, now: float) -> None:
        """Return to service with an empty cache; any requests stranded
        here (no survivor existed at failure time) resume.  The clock
        only jumps to the repair time when there IS stranded work —
        an idle repaired replica must not inflate the run's makespan
        (later deliveries advance it through the heap as usual)."""
        if not self.failed:
            return
        self.failed = False
        self.pool.down -= 1
        if self.pending or self.active:
            self.now = max(self.now, now)
        self.advance()

    def deliver(self, req: Request, now: float) -> None:
        """A routed/transferred/re-fetched request becomes visible."""
        if self.failed:
            alt = self.pool.least_loaded_alive()
            if alt is not None:
                # reroute to a survivor, moving this request's record
                # (and shadow membership) so its history follows it
                rec = self.records.pop(req.rid, None)
                if rec is not None and req.rid not in alt.records:
                    alt.records[req.rid] = rec
                if req.rid in self.shadow:
                    self.shadow.discard(req.rid)
                    alt.shadow.add(req.rid)
                alt.deliver(req, now)
                return
            # no survivor: queue here and wait for repair
        if req.rid not in self.records:
            self.records[req.rid] = RequestRecord(
                req.rid, req.arrival, req.context_len, req.gen_len,
                slo_class=req.slo_class)
        idx = bisect.bisect_right([p.arrival for p in self.pending],
                                  req.arrival)
        self.pending.insert(idx, req)
        if not self.busy:
            self.advance()

    # -- coupling hooks ----------------------------------------------------

    def finish(self, req: Request, rec: RequestRecord, now: float) -> None:
        if self.pool.on_finish is not None:
            self.pool.on_finish(self, req, rec, now)

    def refetch(self, req: Request, now: float) -> None:
        """Decode-role preemption: the victim must re-materialize its
        prompt KV before re-admission."""
        if self.pool.on_preempt is not None:
            # engine-coupled: the prefill pool re-runs the prompt (real
            # occupancy) and the cache re-ships over the shared link;
            # the victim is parked until the engine re-delivers it
            self.pool.on_preempt(self, req, now)
            return
        # delay-mode: charge a per-request delay (the coupled KV-transfer
        # wire time, or a re-prefill estimate priced through step_cost)
        if req.rid not in self._refetch_cache:
            if self.pool.refetch_delay is not None:
                delay = max(0.0, self.pool.refetch_delay(req))
            else:
                w = Workload.from_batch(
                    [(req.context_len, req.context_len)], [],
                    self.pool.windows, batch_sequences=1)
                delay, _ = self.cost(w)
            self._refetch_cache[req.rid] = delay
        delay = self._refetch_cache[req.rid]
        self.records[req.rid].refetch_s += delay
        self.kv_refetch_s += delay
        ready = now + delay
        re_req = dataclasses.replace(req, arrival=ready)
        idx = 0
        while (idx < len(self.pending)
               and self.pending[idx].arrival <= ready):
            idx += 1
        self.pending.insert(idx, re_req)

    def next_arrival_bound(self) -> Optional[float]:
        """Earliest future work this replica could see — its own pending
        head, any in-flight engine delivery headed for this pool, or
        (in a coupled topology) the earliest upstream-pool event that
        could *spawn* a delivery (a transfer is only initiated when a
        prefill iteration ends, so no delivery can precede the upstream
        pool's next scheduled event).  ``now`` (disabling fast-forward)
        while a parked victim's return time is still unknown."""
        bounds = []
        if self.pending:
            bounds.append(self.pending[0].arrival)
        boundary_t = self.pool.engine.next_boundary(self.now)
        if boundary_t is not None:
            # never fast-forward across a world-change boundary: a fault
            # transition, straggler-window edge, or epoch re-planning
            # boundary changes this replica's world
            bounds.append(boundary_t)
        pool_bound = self.pool.incoming_bound()
        if pool_bound is not None:
            bounds.append(pool_bound)
        if self.pool.incoming_unknown > 0:
            bounds.append(self.now)
        up = self.pool.upstream
        if up is not None:
            up_bound = up.next_event_bound()
            if up_bound is not None:
                bounds.append(up_bound)
            if self.pool.on_preempt is not None:
                # a PEER replica's preemption can inject upstream work at
                # its own next iteration end
                peer = self.pool.next_event_bound(exclude=self)
                if peer is not None:
                    bounds.append(peer)
        return min(bounds) if bounds else None

    # -- workload builders (shared by every policy) ------------------------

    def workload(self, iter_prefills, iter_decodes,
                 newly_admitted) -> Workload:
        pool = self.pool
        chunks = [(take, a.prefill_done + take) for a, take in iter_prefills]
        kv_lens = [a.kv_tokens for a in iter_decodes]
        # decode role: the encoder already ran in the prefill pool — its
        # memory ships with the KV; only cross-attention reads remain here
        enc_tokens = sum(a.req.source_len for a in newly_admitted) \
            if pool.is_encdec and pool.role != "decode" else 0
        pre_src = [a.req.source_len for a, _ in iter_prefills] \
            if pool.is_encdec else ()
        dec_src = [a.req.source_len for a in iter_decodes] \
            if pool.is_encdec else ()
        n_seq = len(iter_prefills) + len(iter_decodes)
        return Workload.from_batch(chunks, kv_lens, pool.windows,
                                   batch_sequences=n_seq,
                                   encoder_tokens=enc_tokens,
                                   prefill_source=pre_src,
                                   decode_source=dec_src)

    def workload_decode(self, kv_lens: List[int], n_seq: int) -> Workload:
        return Workload.from_batch([], kv_lens, self.pool.windows,
                                   batch_sequences=n_seq)

    # -- result ------------------------------------------------------------

    @property
    def touched(self) -> bool:
        return bool(self.records) or self.iters > 0

    def result(self) -> BatchingResult:
        records = [rec for rid, rec in self.records.items()
                   if rid not in self.shadow]
        return BatchingResult(records=records, iterations=self.iters,
                              total_time=self.now,
                              total_energy=self.energy,
                              preemptions=self.preemptions,
                              peak_kv_tokens=self.peak_kv,
                              peak_batch=self.peak_batch,
                              kv_refetch_s=self.kv_refetch_s,
                              swap_outs=self.swap_outs,
                              swap_ins=self.swap_ins,
                              kv_swap_s=self.kv_swap_s,
                              admission_rejected=self.admission_rejected,
                              admission_deferred=self.admission_deferred)


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

class Pool:
    """A group of replicas sharing one scheduler policy, KV capacity and
    step-cost model (one pool for colocated serving; a prefill pool and a
    decode pool for disaggregated serving)."""

    def __init__(self, engine: "Engine", name: str,
                 buckets: Sequence[Sequence[Request]],
                 capacity: int, policy: BatchingPolicy,
                 cost, windows: Sequence = (None,),
                 max_sequences: int = 512, is_encdec: bool = False,
                 role: str = "both",
                 refetch_delay: Optional[RefetchDelay] = None,
                 on_finish: Optional[Callable] = None,
                 on_preempt: Optional[Callable] = None,
                 preemption=None,
                 swap_cost: Optional[SwapCost] = None):
        if capacity <= 0:
            raise ValueError("pool has no KV capacity — infeasible")
        if role not in ("both", "decode"):
            raise ValueError(f"unknown batching role {role!r}")
        if role == "decode" and policy.mode == "static":
            raise ValueError("decode role requires continuous batching")
        self.engine = engine
        self.name = name
        self.capacity = capacity
        self.policy = make_policy(policy)
        if isinstance(cost, StepCostCache):
            self.cache: Optional[StepCostCache] = cost
            self.step_cost: Optional[StepCost] = cost.step_cost
        else:
            self.cache = None
            self.step_cost = cost
        self.windows = tuple(windows)
        self.max_sequences = max_sequences
        self.is_encdec = is_encdec
        self.role = role
        self.refetch_delay = refetch_delay
        self.on_finish = on_finish
        self.on_preempt = on_preempt
        # KV-overflow policy: every replica of the pool shares one
        # PreemptionPolicy (menu string or instance; None = sacrifice +
        # recent-first, the legacy behaviour, bit-identical to goldens).
        self.preemption = make_preemption(preemption)
        # Prices one victim's host round trip: (req, kv_tokens) ->
        # (delay_s, energy_j).  Only the swap mechanism consults it.
        self.swap_cost: SwapCost = swap_cost or (lambda req, kv: (0.0, 0.0))
        self.incoming: List[float] = []      # scheduled delivery times
        self.incoming_unknown = 0            # parked, time not yet known
        # coupled topologies: the pool whose iteration-end events spawn
        # this pool's deliveries (bounds downstream fast-forward runs)
        self.upstream: Optional["Pool"] = None
        # fault-injection state (core/faults.py; inert by default)
        self.down = 0                        # currently failed replicas
        self.stragglers: List = []           # applied Straggler windows
        self.fault_throttle = 1.0            # admission scale while down
        self.replicas = [Replica(self, i, b) for i, b in enumerate(buckets)]

    # -- fault handling (core/faults.py) -----------------------------------

    def live_max_sequences(self) -> int:
        """Admission concurrency cap, throttled while the pool is
        degraded (graceful degradation: survivors admit less so queued
        work does not thrash their KV into preemption storms)."""
        if self.down and self.fault_throttle < 1.0:
            return max(1, int(self.max_sequences * self.fault_throttle))
        return self.max_sequences

    def slowdown(self, replica: "Replica", t: float) -> float:
        """Product of straggler factors active on ``replica`` at ``t``."""
        f = 1.0
        for s in self.stragglers:
            if s.replica == replica.index and s.start <= t < s.end:
                f *= s.slowdown
        return f

    def least_loaded_alive(self, exclude: Optional["Replica"] = None
                           ) -> Optional["Replica"]:
        alive = [r for r in self.replicas
                 if not r.failed and r is not exclude]
        if not alive:
            return None
        return min(alive, key=lambda r: (len(r.active) + len(r.pending),
                                         r.index))

    def on_replica_fail(self, rep: "Replica", victims, pending,
                        now: float) -> None:
        """Redistribute a failed replica's work to survivors.

        ``victims`` (its active set) lost their KV — each counts as a
        preemption and re-enters via the sacrifice/recompute path: in the
        disagg decode role that means a re-fetch through the prefill pool
        (engine-coupled re-prefill or delay model), elsewhere a plain
        re-queue.  ``pending`` re-queues as-is.  With no survivor,
        everything waits on ``rep`` for repair.
        """
        self.down += 1
        self.engine.fault_requeues += len(victims)
        for v in victims:
            rep.records[v.req.rid].preemptions += 1
            rep.preemptions += 1
            v.reset()
        if self.role == "decode" and victims:
            # shipped prompt KV is gone: victims re-materialize it like
            # sacrificed preemptees.  Engine-coupled refetch parks them
            # upstream (they return via deliver(), which reroutes off a
            # dead replica); delay-mode refetch re-inserts into
            # rep.pending, collected below for redistribution.
            for v in victims:
                rep.refetch(v.req, now)
            pending = pending + rep.pending
            rep.pending = []
        else:
            pending = [v.req for v in victims] + pending
        if not pending:
            return
        if all(r.failed for r in self.replicas):
            rep.pending = sorted(pending, key=lambda r: r.arrival)
            return                       # total outage: wait for repair
        for req in pending:
            target = self.least_loaded_alive()
            rec = rep.records.pop(req.rid, None)
            if rec is not None and req.rid not in target.records:
                target.records[req.rid] = rec
            if req.rid in rep.shadow:
                rep.shadow.discard(req.rid)
                target.shadow.add(req.rid)
            target.deliver(req, now)

    # -- in-flight delivery bookkeeping (fast-forward bounds) --------------

    def incoming_bound(self) -> Optional[float]:
        return self.incoming[0] if self.incoming else None

    def expect(self, time: float) -> None:
        bisect.insort(self.incoming, time)

    def arrived(self, time: float) -> None:
        idx = bisect.bisect_left(self.incoming, time)
        if idx < len(self.incoming) and self.incoming[idx] == time:
            self.incoming.pop(idx)

    def next_event_bound(self, exclude: Optional["Replica"] = None
                         ) -> Optional[float]:
        """Earliest scheduled event of this pool (a replica's iteration
        end or idle-wake, or an inbound delivery) — nothing this pool
        does can affect the rest of the system before that time."""
        bounds = [b for rep in self.replicas if rep is not exclude
                  for b in (rep._busy_until, rep._wake_at)
                  if b is not None]
        if self.incoming:
            bounds.append(self.incoming[0])
        return min(bounds) if bounds else None

    # -- results -----------------------------------------------------------

    def results(self) -> List[BatchingResult]:
        return [r.result() for r in self.replicas if r.touched]

    def replay_accumulators(self, owner) -> None:
        """Fold every replica's per-call FLOP/byte increments into the
        owner simulator's accumulators in replica order — the exact
        summation order of the legacy sequential loops."""
        for rep in self.replicas:
            for f, b in rep.cost_calls:
                owner._flops_accum += f
                owner._bytes_accum += b


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class Engine:
    """Global event heap driving every pool's replicas on one clock."""

    def __init__(self):
        self.heap: List[tuple] = []
        self.pools: Dict[str, Pool] = {}
        self._seq = 0
        # fault-injection state (inert unless install_faults ran)
        self.faults = None                  # the installed FaultSchedule
        self.fault_times: List[float] = []  # sorted transition times
        self.fault_requeues = 0             # requests re-queued by failures
        # epoch-gated re-planning state (inert unless install_epoch ran)
        self.epoch_times: List[float] = []  # sorted epoch boundaries
        self.stopped = False                # epoch handler halts run()
        self._boundary_times: List[float] = []  # faults | epochs, merged

    def add_pool(self, name: str, buckets, capacity: int,
                 policy: BatchingPolicy, cost, **kw) -> Pool:
        pool = Pool(self, name, buckets, capacity, policy, cost, **kw)
        self.pools[name] = pool
        return pool

    # -- world-change boundaries (faults + epoch re-planning) --------------

    def _rebuild_boundaries(self) -> None:
        self._boundary_times = sorted(set(self.fault_times)
                                      | set(self.epoch_times))

    def next_boundary(self, now: float) -> Optional[float]:
        """Earliest world-change boundary strictly after ``now`` — a
        fault transition or an epoch re-planning boundary.  Both bound
        fast-forward runs identically: past either, this replica's world
        may change, so uneventful-decode runs must not cross it.  One
        shared helper means faults + re-planning compose without
        double-bounding bugs.  None when neither is installed."""
        times = self._boundary_times
        if not times:
            return None
        i = bisect.bisect_right(times, now)
        return times[i] if i < len(times) else None

    def fault_bound(self, now: float) -> Optional[float]:
        """Earliest fault transition strictly after ``now``; kept as a
        delegating alias of ``next_boundary`` (which also folds in epoch
        boundaries) for callers of the PR-9 API."""
        return self.next_boundary(now)

    def install_epoch(self, time: float,
                      handler: Callable[[float], None]) -> None:
        """Push one epoch boundary onto the heap.  The handler fires at
        ``_PRIO_EPOCH`` — after fault transitions at the same instant,
        before deliveries and iteration ends — and typically freezes the
        engine via ``stop()`` so a plan controller can re-shard and
        resume on a new engine.  Must run after ``add_pool`` and before
        ``run()``."""
        self.epoch_times.append(time)
        self.epoch_times.sort()
        self._rebuild_boundaries()
        self.schedule(time, _PRIO_EPOCH, 0, handler)

    def stop(self) -> None:
        """Halt ``run()`` after the current event (epoch switching)."""
        self.stopped = True

    # -- fault injection (core/faults.py) ----------------------------------

    def install_faults(self, schedule) -> None:
        """Resolve a ``FaultSchedule`` against the registered pools and
        push its transitions onto the event heap.  Must run after every
        ``add_pool`` and before ``run()``.  Events aimed at replicas a
        pool does not have are inert; an empty schedule installs
        nothing (bit-identical to a fault-free run)."""
        if schedule is None or schedule.empty:
            return
        times = set()
        for f in schedule.replica_faults:
            for pool in self.pools.values():
                if f.pool not in ("*", pool.name):
                    continue
                if f.replica >= len(pool.replicas):
                    continue
                rep = pool.replicas[f.replica]
                times.add(f.start)
                self.schedule(f.start, _PRIO_FAULT, f.replica,
                              lambda t, r=rep: r.fail(t))
                if f.repair != float("inf"):
                    times.add(f.repair)
                    self.schedule(f.repair, _PRIO_FAULT, f.replica,
                                  lambda t, r=rep: r.repair(t))
        for s in schedule.stragglers:
            for pool in self.pools.values():
                if s.pool not in ("*", pool.name):
                    continue
                if s.replica >= len(pool.replicas):
                    continue
                pool.stragglers.append(s)
                times.add(s.start)
                times.add(s.end)
        for pool in self.pools.values():
            pool.fault_throttle = schedule.throttle
        self.fault_times = sorted(times)
        self.faults = schedule
        self._rebuild_boundaries()

    def schedule(self, time: float, prio: int, tie: int,
                 fn: Callable[[float], None]) -> None:
        self._seq += 1
        heapq.heappush(self.heap, (time, prio, tie, self._seq, fn))

    def deliver(self, pool: Pool, replica, req: Request,
                time: float) -> None:
        """Schedule a request delivery (a finished transfer, a re-fetch
        return) into a replica's pending queue at ``time``.

        ``replica`` may be a ``Replica`` or a callable
        ``(fire_time) -> Replica`` resolved when the event fires, so
        load-balancing routers observe deliveries in completion-time
        order (ties broken by rid)."""
        pool.expect(time)

        def fire(t: float, r=req) -> None:
            pool.arrived(t)
            target = replica(t) if callable(replica) else replica
            target.deliver(r, t)

        self.schedule(time, _PRIO_DELIVER, req.rid, fire)

    def run(self) -> None:
        for pool in self.pools.values():
            for rep in pool.replicas:
                rep.advance()
        heap = self.heap
        while heap and not self.stopped:
            time, _prio, _tie, _seq, fn = heapq.heappop(heap)
            fn(time)
