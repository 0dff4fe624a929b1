"""Continuous-batching serving engine (``repro/serving/engine.py``).

Iteration-level batching over a slot-based KV cache, with the reference's
policies unchanged:

  * ``max_batch`` slots share one cache; each active slot holds one
    request's KV rows and length counter;
  * admission is greedy on free slots AND free KV-token budget, and the
    most recently admitted request is preempted while the budget is
    overflowed;
  * each iteration runs ONE ``decode_step`` over all slots (inactive slots
    ride along and do not advance their length); prefill replays a
    request's prompt through the same step, and only that slot's length
    advances;
  * arrivals are honoured in VIRTUAL time: the clock advances by measured
    step wall-times, each ending in a device synchronisation.

SSM layers depart from the reference on purpose.  The reference's
prefill replays one slot's prompt over the whole batch and restores only
the other slots' lengths, so their SSM states and conv windows advance
for good, and a reused slot starts from the state its last request left:
a request's tokens depend on its neighbours.  Here an admitted slot's
``ssm``, ``conv_x`` and ``conv_bc`` rows are zeroed before its prefill,
and the other active slots' rows are put back after the replay.  The rows
of a batch never mix inside ``decode_step``, so putting them back once
after the replay gives what putting them back after every step would.
Each request's tokens are then those of the request served alone.
Attention caches behave as in the reference: the rows a replay writes
for another slot sit at its current length and are overwritten by its
next step before it attends to them.  The main loop needs no such care:
its active slots all advance, and an inactive slot is zeroed when it is
next admitted.  A hybrid cache (zamba2: 78 SSM layers' state beside the
shared attention block's 13 K/V caches, ``cache["shared"]``) is served
through one slot by the same two rules and adds no departure: its SSM
layers' state is that of ``cache["blocks"]`` (``_state``), and the
shared caches are attention caches.

Unlike the reference, a request's first token is stamped once the
prefills of the iteration that admitted it have run, not at the start of
that iteration: its TTFT counts its own prompt's replay steps and those
of requests admitted before it in the same iteration.  A stamp of 0.0
counts as set (the reference's ``first_token_t or now`` reads a request
first served at virtual time 0 as TTFT = e2e, TPOT = 0).  Tokens,
iterations and preemptions are unaffected.

Slot lengths live on the host as numpy and are uploaded before each step,
so bookkeeping costs no device-to-host copy; the one copy per step is the
sampled tokens.  ``snapshot()``/``restore()`` capture queued and in-flight
requests so a restarted replica replays its work.

On a CUDA device every decode step, prompt replay steps included, is
the replay of one CUDA graph (``models.transformer.CapturedStep``): the
step over the engine's fixed shapes, (max_batch, 1) tokens on its own
cache, captured at the engine's first step, while the cache holds no
request, and again at the first step after ``restore()``, which
allocates a new cache.  A replay runs the eager step's kernels with one
host launch where the eager step makes one per op.  Each step is still
one call of ``models.transformer.decode_step``, looked up on the module
at call time; ``EngineReport.graph_steps`` counts the replayed steps.
On a CPU nothing is captured.

A run counts the decode steps spent replaying prompts
(``EngineReport.replay_steps``) and stamps, on the engine's clock, each
request's first leaving the queue (``RequestResult.queue_wait``, from its
arrival) and each of its tokens (``RequestResult.token_times``: the first
token's stamp, then the end of the iteration that produced each later
one, so that TPOT is the mean of their gaps).  While a ``torch.profiler``
profile records, its iterations, admissions, replay steps, uploads,
readbacks and retirements are ``repro_torch.tracing`` spans.

An encoder-decoder config raises ``ValueError`` before anything is
allocated, with the reference's ``prefill`` error: its requests prefill
through ``models.encdec.encdec_prefill``, which the engine does not run,
as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.tracing import span

# the cache entries of an SSM layer that carry a request's recurrent state
SSM_STATE = ("ssm", "conv_x", "conv_bc")
# device types on which the engine replays its decode step as a CUDA graph
GRAPH_DEVICES = ("cuda",)


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    prompt: Optional[np.ndarray] = None
    gen_len: int = 0
    generated: int = 0
    order: int = -1
    arrival: float = 0.0
    # engine-clock stamp of the request's first admission
    admitted: float = 0.0
    first_token_t: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def active(self) -> bool:
        return self.rid >= 0

    @property
    def kv_tokens(self) -> int:
        if not self.active:
            return 0
        return len(self.prompt) + self.generated


@dataclasses.dataclass
class RequestResult:
    rid: int
    arrival: float
    ttft: float
    tpot: float
    e2e: float
    tokens: List[int]
    preemptions: int = 0
    # first admission minus arrival, on the engine's clock
    queue_wait: float = 0.0
    # engine-clock stamp of each token: the first token's, then the end
    # of the iteration that produced each later one
    token_times: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EngineReport:
    results: List[RequestResult]
    total_time: float
    iterations: int
    preemptions: int
    # decode steps spent replaying prompts (re-admissions included);
    # ``iterations`` counts the main loop's steps
    replay_steps: int = 0
    # decode steps of either kind served by replaying the captured graph
    graph_steps: int = 0

    @property
    def ttft_mean(self) -> float:
        return float(np.mean([r.ttft for r in self.results]))

    @property
    def tpot_mean(self) -> float:
        ts = [r.tpot for r in self.results if r.tpot > 0]
        return float(np.mean(ts)) if ts else 0.0

    @property
    def throughput(self) -> float:
        toks = sum(len(r.tokens) for r in self.results)
        return toks / self.total_time if self.total_time else 0.0


class ServingEngine:
    """Serve requests with ``params`` (a ``models.transformer``
    parameter tree already on ``device``).

    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` for the plain path.  ``dtype`` (default
    ``cfg.dtype``) is the dtype served in: the parameters must be in it
    and the cache is allocated in it.
    """

    def __init__(self, cfg: ModelConfig, params: T.Transformer, *,
                 max_batch: int = 4, max_len: int = 512,
                 kv_token_budget: Optional[int] = None, device=None,
                 dtype=None):
        if cfg.cross_attn:
            raise ValueError(T.ENCDEC_PREFILL)
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype if dtype is not None else cfg.dtype)
        embed = params.embed
        if embed.device.type != self.device.type or embed.dtype != self.dtype:
            raise ValueError(f"params are {embed.dtype} on {embed.device}; "
                             f"the engine serves {self.dtype} on "
                             f"{self.device}")
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv_budget = kv_token_budget or (max_batch * max_len)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.cache = self._new_cache()
        self.lens = np.zeros(max_batch, np.int32)
        self.queue: List[dict] = []
        self._order = 0
        self.preemptions = 0
        self.replay_steps = 0
        self.graph_steps = 0
        self._graph: Optional[T.CapturedStep] = None

    def _new_cache(self) -> dict:
        return T.init_cache(self.cfg, self.max_batch, self.max_len,
                            device=self.device, cache_dtype=self.dtype)

    def _state(self) -> List[torch.Tensor]:
        """The recurrent state of the cache, (R, B, ...) each: every SSM
        layer's ``ssm``, ``conv_x`` and ``conv_bc``."""
        return [lc[name] for lc in self.cache["blocks"].values()
                for name in SSM_STATE if name in lc]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode(self, toks: np.ndarray) -> torch.Tensor:
        """One decode step over all slots at the host lengths; returns the
        greedy (first-max) next token of every slot, still on device."""
        with span("engine.upload"):
            self.cache["len"] = torch.from_numpy(self.lens).to(self.device)
            toks = torch.from_numpy(toks).to(self.device)
        if self._graph is None and self.device.type in GRAPH_DEVICES:
            self._graph = T.CapturedStep(self.params, self.cfg, self.cache,
                                         toks)
        logits, self.cache = T.decode_step(self.params, self.cfg, toks,
                                           self.cache, graph=self._graph)
        self.graph_steps += self._graph is not None
        with span("engine.readback"):
            return torch.argmax(logits, dim=-1)

    # -- fault tolerance -------------------------------------------------------

    def snapshot(self) -> dict:
        """Scheduler state for checkpoint/restart: queued + in-flight
        requests (in-flight ones will re-prefill after restore)."""
        inflight = [dict(rid=s.rid, prompt=s.prompt, gen_len=s.gen_len,
                         arrival=s.arrival)
                    for s in self.slots if s.active]
        return {"queue": list(self.queue), "inflight": inflight}

    def restore(self, snap: dict) -> None:
        self.queue = list(snap["queue"]) + list(snap["inflight"])
        self.queue.sort(key=lambda r: r["arrival"])
        self.slots = [_Slot() for _ in range(self.max_batch)]
        self.cache = self._new_cache()
        self._graph = None
        self.lens = np.zeros(self.max_batch, np.int32)

    # -- scheduling ------------------------------------------------------------

    def _kv_used(self) -> int:
        return sum(s.kv_tokens for s in self.slots)

    def _admit(self, now: float, t0: Optional[float] = None) -> None:
        """Admit queued requests that have arrived by ``now`` while slots
        and budget allow; ``t0``, the host clock at the start of the
        iteration at ``now``, dates their leaving the queue."""
        while self.queue and self.queue[0]["arrival"] <= now:
            req = self.queue[0]
            free = [i for i, s in enumerate(self.slots) if not s.active]
            if not free:
                break
            if self._kv_used() + len(req["prompt"]) > self.kv_budget:
                break
            self.queue.pop(0)
            left = now if t0 is None else now + (time.perf_counter() - t0)
            with span("engine.admit", rid=req["rid"]):
                i = free[0]
                self.slots[i] = _Slot(rid=req["rid"],
                                      prompt=np.asarray(req["prompt"]),
                                      gen_len=req["gen_len"],
                                      order=self._order,
                                      arrival=req["arrival"],
                                      admitted=req.get("admitted", left))
                self._order += 1
                for t in self._state():
                    t[:, i].zero_()
                self._prefill_slot(i)

    def _prefill_slot(self, i: int) -> None:
        """Replay the prompt through the decode step (the whole batch's
        other slots ride along; only slot i's length advances, and the
        other active slots' recurrent state is put back afterwards)."""
        s = self.slots[i]
        self.lens[i] = 0
        others = [j for j, o in enumerate(self.slots) if o.active and j != i]
        state = self._state() if others else []
        kept = [t[:, others] for t in state]
        for t in range(len(s.prompt)):
            with span("engine.replay_step", rid=s.rid):
                toks = np.zeros((self.max_batch, 1), np.int32)
                toks[i, 0] = s.prompt[t]
                nxt = self._decode(toks)
                self.lens[i] += 1
                self.replay_steps += 1
        for t, rows in zip(state, kept):
            t[:, others] = rows
        s.generated = 1
        s.tokens.append(int(nxt[i]))

    def _evict_most_recent(self) -> None:
        cand = [s for s in self.slots if s.active]
        if not cand:
            return
        victim = max(cand, key=lambda s: s.order)
        idx = self.slots.index(victim)
        self.queue.insert(0, dict(rid=victim.rid, prompt=victim.prompt,
                                  gen_len=victim.gen_len,
                                  arrival=victim.arrival,
                                  admitted=victim.admitted))
        self.preemptions += 1
        self.slots[idx] = _Slot()

    # -- main loop -------------------------------------------------------------

    def run(self, requests: List[dict],
            time_scale: float = 1.0) -> EngineReport:
        """Serve ``requests`` (dicts: rid, arrival, prompt, gen_len).

        ``time_scale`` compresses arrival stamps (0.0: all arrive at once,
        so admission does not depend on wall time).
        """
        self.queue = sorted(
            (dict(r, arrival=r["arrival"] * time_scale) for r in requests),
            key=lambda r: r["arrival"])
        records: Dict[int, RequestResult] = {}
        now = 0.0
        iters = 0
        self.replay_steps = 0
        self.graph_steps = 0
        while self.queue or any(s.active for s in self.slots):
            t0 = time.perf_counter()
            with span("engine.iteration", step=iters):
                self._admit(now, t0)
                active = [i for i, s in enumerate(self.slots) if s.active]
                if not active:
                    if self.queue:
                        now = max(now, self.queue[0]["arrival"])
                        continue
                    break
                # requests prefilled in this iteration have their first
                # token now
                fresh = [i for i in active
                         if self.slots[i].first_token_t is None]
                if fresh:
                    self._sync()
                    t_first = now + (time.perf_counter() - t0)
                    for i in fresh:
                        self.slots[i].first_token_t = t_first
                        self.slots[i].token_times.append(t_first)

                toks = np.zeros((self.max_batch, 1), np.int32)
                for i in active:
                    toks[i, 0] = self.slots[i].tokens[-1]
                nxt = self._decode(toks)
                with span("engine.readback"):
                    nxt = nxt.cpu().numpy()
                # inactive slots must not advance their length counters
                self.lens[active] += 1
                self._sync()
                step_t = time.perf_counter() - t0
                now += step_t
                iters += 1

                with span("engine.retire"):
                    self._retire(active, nxt, now, records)

        return EngineReport(results=list(records.values()), total_time=now,
                            iterations=iters, preemptions=self.preemptions,
                            replay_steps=self.replay_steps,
                            graph_steps=self.graph_steps)

    def _retire(self, active: List[int], nxt: np.ndarray, now: float,
                records: Dict[int, RequestResult]) -> None:
        """Append each active slot's token, record and free the finished
        ones, and evict while the KV budget is overflowed."""
        for i in active:
            s = self.slots[i]
            s.tokens.append(int(nxt[i]))
            s.token_times.append(now)
            s.generated += 1
            if s.generated >= s.gen_len or s.kv_tokens >= self.max_len - 1:
                denom = max(s.generated - 1, 1)
                records[s.rid] = RequestResult(
                    rid=s.rid, arrival=s.arrival,
                    ttft=s.first_token_t - s.arrival,
                    tpot=(now - s.first_token_t) / denom,
                    e2e=now - s.arrival, tokens=list(s.tokens),
                    queue_wait=s.admitted - s.arrival,
                    token_times=list(s.token_times))
                self.slots[i] = _Slot()
        # KV budget enforcement (greedy batching can overshoot)
        while self._kv_used() > self.kv_budget:
            self._evict_most_recent()
