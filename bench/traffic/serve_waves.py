"""The ``serve_waves`` kind: offline waves of requests, served by the
program's ``ServingEngine``, and checked against the plain reference.

Traffic.  A mix (``bench/traffic/<name>.json``) gives a trace's
log-normal prompt and output lengths (mean and standard deviation, in
tokens), their clamps, the requests a wave and the engine's slots.  A
wave of n requests, all due at t=0, takes the stratified lengths of the
trace: its i-th prompt is the (i + 0.5) / n quantile of the prompt
log-normal, its outputs the same quantiles of the output log-normal,
each rounded and clamped to [1, max].  The pairing of prompt and output
lengths and the order of the requests are one fixed shuffle
(``order_seed``), so every seed serves the same lengths in the same
order: the engine's schedule, its batches and its step count do not
depend on the seed.  The seed draws the prompts' token ids, anew for
every wave.  (The log-normal parameters are those of the paper's
Table 1, as ``repro_torch.data.requests`` derives them.)

Driver.  Set-up draws the weights, builds the engine and serves one
short request, which runs every kernel of a decode step at the cell's
shapes.  The window is a run of whole waves, each one
``ServingEngine.run`` at ``time_scale=0`` that ends synchronised: at
least one wave, and another while the waves so far and one more of the
last one's length fit in ``--seconds``.  After it, a ``--trace 1`` run
times a decode-step probe and profiles a stretch of one more wave of the
same traffic.

Check.  Once the window has closed, one wave of it, drawn from the seed,
every request of it: the reference reads each prompt followed by its
served tokens, and at each served position takes the gap by which the
served token's logit lies below the reference's best.  ``mean_gap`` is
their mean over the wave.  Greedy serving puts the best token first, so
a sound program's gaps come from rounding alone: in bf16 they are mostly
0, with a tenth or so of tokens off by near-ties (an expert route that
rounding flips).  The widest gap is one such flip and is not compared:
the control flips as far (PERF.md).  The control is the reference in the
program's place in the precision below the configuration's
(``check.CONTROL``), read at the same positions: the gap of the token it
puts first.
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import time
from statistics import NormalDist
from types import SimpleNamespace
from typing import Dict, List, Tuple
from unittest import mock

import numpy as np
import torch

from bench.harness import check, model, spec
from bench.harness.trace import Capture


# -- traffic ---------------------------------------------------------------------

def lognormal_params(mean: float, std: float) -> Tuple[float, float]:
    """(mu, sigma) of the log-normal with this mean and standard
    deviation."""
    sigma2 = math.log(1.0 + (std * std) / (mean * mean))
    return math.log(mean) - sigma2 / 2.0, math.sqrt(sigma2)


def stratified(n: int, mean: float, std: float, cap: int) -> List[int]:
    """The (i + 0.5) / n quantiles of the log-normal, i = 0 .. n-1,
    rounded and clamped to [1, cap]."""
    mu, sigma = lognormal_params(mean, std)
    unit = NormalDist()
    return [max(1, min(cap, int(round(math.exp(
        mu + sigma * unit.inv_cdf((i + 0.5) / n)))))) for i in range(n)]


def wave_lengths(mix: dict) -> List[Tuple[int, int]]:
    """(prompt, output) lengths of one wave's requests, in serving order."""
    n = mix["wave_requests"]
    prompts = stratified(n, mix["prompt_mean"], mix["prompt_std"],
                         mix["prompt_max"])
    outputs = stratified(n, mix["output_mean"], mix["output_std"],
                         mix["output_max"])
    rng = random.Random(mix["order_seed"])
    pairing = list(range(n))
    rng.shuffle(pairing)
    order = list(range(n))
    rng.shuffle(order)
    return [(prompts[i], outputs[pairing[i]]) for i in order]


def wave(mix: dict, vocab_size: int, seed: int, index: int) -> List[dict]:
    """Wave ``index`` of the mix: requests {rid, arrival 0, prompt (int32
    token ids in [1, vocab)), gen_len}."""
    rng = np.random.default_rng((seed, index))
    return [{"rid": r, "arrival": 0.0,
             "prompt": rng.integers(1, vocab_size, size=p).astype(np.int32),
             "gen_len": g}
            for r, (p, g) in enumerate(wave_lengths(mix))]


# -- driver ----------------------------------------------------------------------

# the wave indices of the warm-up request and of the profiled wave, apart
# from the window's 0, 1, ...
WARM_WAVE = 10 ** 9
PROFILE_WAVE = 10 ** 9 + 1


class _Stop(Exception):
    """Ends the profiled wave once its stretch is captured."""


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(ctx):
    from repro_torch.serving.engine import ServingEngine
    mix, conf, dev = ctx.mix, ctx.conf, ctx.device
    weights = model.draw(conf, ctx.seed, dev)
    cfg, params = model.port_model(conf, weights)
    engine = ServingEngine(cfg, params, max_batch=mix["slots"],
                           max_len=mix["max_len"], device=dev)
    warm = [{"rid": 0, "arrival": 0.0,
             "prompt": wave(mix, conf["vocab_size"], ctx.seed,
                            WARM_WAVE)[0]["prompt"][:2],
             "gen_len": 2}]
    engine.run(warm, time_scale=0.0)
    _sync(dev)
    return SimpleNamespace(weights=weights, cfg=cfg, params=params,
                           engine=engine)


def window(ctx, st) -> dict:
    mix, dev = ctx.mix, ctx.device
    waves, total, i = [], 0.0, 0
    while True:
        reqs = wave(mix, ctx.conf["vocab_size"], ctx.seed, i)
        t0 = time.perf_counter()
        rep = st.engine.run(reqs, time_scale=0.0)
        _sync(dev)
        dt = time.perf_counter() - t0
        waves.append({"requests": reqs, "report": rep, "seconds": dt})
        total += dt
        i += 1
        if total + dt > ctx.seconds:
            break
    return {"waves": waves, "seconds": total}


def end_to_end(win: dict) -> dict:
    results = [r for w in win["waves"] for r in w["report"].results]
    tokens = sum(len(r.tokens) for r in results)
    return {
        "serve_tokens_per_s": tokens / win["seconds"],
        "ttft_ms_p50": statistics.median(r.ttft for r in results) * 1e3,
        "tpot_ms_p50": statistics.median(r.tpot for r in results) * 1e3,
    }


def counts(win: dict) -> dict:
    """Requests attempted, and failed: not finished, or with another
    number of tokens than asked for."""
    attempted = failed = 0
    for w in win["waves"]:
        done = {r.rid: r for r in w["report"].results}
        for q in w["requests"]:
            attempted += 1
            r = done.get(q["rid"])
            if r is None or len(r.tokens) != q["gen_len"]:
                failed += 1
    return {"attempted": attempted, "failed": failed}


def probe(ctx, st) -> dict:
    """Decode steps over ``slots`` slots, each at ``context`` cached
    tokens, called directly: synchronised wall ms a step over ``steps``
    steps after one warm step, then a profile of ``profiled_steps``
    steps with each MoE FFN in a ``moe_forward`` range."""
    from repro_torch.launch.fig6 import expert_range
    from repro_torch.models import transformer as T
    p, dev, cfg = ctx.mix["probe"], ctx.device, st.cfg
    cache = T.init_cache(cfg, p["slots"], ctx.mix["max_len"], device=dev,
                         cache_dtype=st.params.embed.dtype)
    cache["len"] = torch.full((p["slots"],), p["context"],
                              dtype=torch.int32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(ctx.seed)
    toks = torch.randint(1, cfg.vocab_size, (p["slots"], 1),
                         generator=gen).to(dev)
    T.decode_step(st.params, cfg, toks, cache)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(p["steps"]):
        T.decode_step(st.params, cfg, toks, cache)
    _sync(dev)
    wall_ms = (time.perf_counter() - t0) / p["steps"] * 1e3
    cap = Capture(dev, host=True)
    with expert_range():
        cap.start()
        for _ in range(p["profiled_steps"]):
            T.decode_step(st.params, cfg, toks, cache)
        trace = cap.stop(steps=p["profiled_steps"])
    del cache
    return {"wall_ms": wall_ms, "steps": p["steps"], "trace": trace,
            "slots": p["slots"], "context": p["context"]}


def engine_profile(ctx, st):
    """A profile of ``steps`` engine steps of one more wave, after its
    first ``skip_steps``; the wave is cut off once they are captured."""
    from repro_torch.models import transformer as T
    p = ctx.mix["engine_profile"]
    step = T.decode_step
    cap = Capture(ctx.device)
    calls = [0]

    def counted(*args, **kwargs):
        if calls[0] == p["skip_steps"]:
            cap.start()
        if calls[0] == p["skip_steps"] + p["steps"]:
            cap.stop(steps=p["steps"])
            raise _Stop
        calls[0] += 1
        return step(*args, **kwargs)

    reqs = wave(ctx.mix, ctx.conf["vocab_size"], ctx.seed, PROFILE_WAVE)
    with mock.patch.object(T, "decode_step", counted):
        try:
            st.engine.run(reqs, time_scale=0.0)
        except _Stop:
            pass
    if cap.trace is None:
        raise RuntimeError(f"the profiled wave ran {calls[0]} steps, fewer "
                           f"than {p['skip_steps'] + p['steps']}")
    return cap.trace


# -- check -----------------------------------------------------------------------

def checked_wave(seed: int, n_waves: int) -> int:
    return random.Random(seed).randrange(n_waves)


def served_sequences(served_wave: dict, device):
    """(sequences fed to the reference, rows of the served positions,
    served tokens) of the finished requests of ``served_wave``."""
    done = {r.rid: r for r in served_wave["report"].results}
    seqs, rows, served = [], [], []
    for q in served_wave["requests"]:
        r = done.get(q["rid"])
        if r is None or not r.tokens:
            continue
        P, G = len(q["prompt"]), len(r.tokens)
        seqs.append(torch.as_tensor(np.concatenate(
            [q["prompt"], np.asarray(r.tokens[:-1], np.int64)]).astype(
                np.int64), device=device))
        rows.append(slice(P - 1, P - 1 + G))
        served.append(torch.as_tensor(r.tokens, device=device))
    return seqs, rows, served


def gap_stats(gaps: torch.Tensor) -> dict:
    """The mean gap (the number compared), the widest, and the share of
    served tokens that are not the reference's best."""
    g = gaps.double()
    return {"mean_gap": float(g.mean()), "widest_gap": float(g.max()),
            "off_best_share": float((g > 0).double().mean())}


def numbers(conf: dict, weights: Dict[str, torch.Tensor], served_wave: dict,
            device, control: bool = False) -> dict:
    """Statistics of the gaps of the program's served tokens
    (``gap_stats``); with ``control`` also those of the tokens that the
    control puts first at the same positions, each named ``control_...``.
    """
    ref = spec.reference(conf["family"])
    ref.exact_float32()
    seqs, rows, served = served_sequences(served_wave, device)
    fetch = lambda n: weights[n].float()   # noqa: E731
    exact = ref.logits(conf, fetch, weights, seqs, rows=rows)
    best = [lg.max(-1).values for lg in exact]
    gaps = [b - lg.gather(1, s[:, None])[:, 0]
            for b, lg, s in zip(best, exact, served)]
    out = {**gap_stats(torch.cat(gaps)),
           "served_tokens": int(sum(len(s) for s in served))}
    if control:
        low = ref.logits(conf, fetch, weights, seqs, rows=rows,
                         low=check.CONTROL[conf["torch_dtype"]])
        cg = [b - lg.gather(1, lo.argmax(-1)[:, None])[:, 0]
              for b, lg, lo in zip(best, exact, low)]
        out.update({"control_" + k: v
                    for k, v in gap_stats(torch.cat(cg)).items()})
    return out


def check_window(ctx, weights, win: dict) -> dict:
    picked = win["waves"][checked_wave(ctx.seed, len(win["waves"]))]
    nums = numbers(ctx.conf, weights, picked, ctx.device)
    ctx.log(f"check: {nums['served_tokens']} served tokens of one wave "
            f"against the reference; widest gap {nums['widest_gap']!r}, "
            f"{nums['off_best_share']:.4f} of them off the reference's "
            f"best")
    return check.held(nums, ctx.cell["limits"])


# -- a run, and the readings the limits are set from ----------------------------

def run(ctx) -> dict:
    st = setup(ctx)
    ctx.setup_done()
    # what set-up made stays alive: keep the collector off it in the window
    gc.collect()
    gc.freeze()
    win = window(ctx, st)
    ctx.log(f"window: {len(win['waves'])} wave(s), "
            f"{sum(len(w['requests']) for w in win['waves'])} requests, "
            f"{sum(w['report'].iterations for w in win['waves'])} engine "
            f"iterations, {win['seconds']:.3f} s")
    out = {"window": win, "e2e": end_to_end(win), **counts(win)}
    if ctx.trace:
        out["probe"] = probe(ctx, st)
        out["device_trace"] = engine_profile(ctx, st)
    out["memory_peak_bytes"] = ctx.memory_peak()
    # the program's state goes; the weights are the benchmark's input
    weights = st.weights
    del st
    ctx.free()
    out["checks"] = check_window(ctx, weights, win)
    return out


def readings(ctx, control: bool) -> dict:
    """The numbers the check compares, for one wave of the cell's timed
    path (no window's length), and with ``control`` the control's."""
    st = setup(ctx)
    ctx.seconds = 0.0
    win = window(ctx, st)
    weights = st.weights
    del st
    ctx.free()
    nums = numbers(ctx.conf, weights, win["waves"][0], ctx.device,
                   control=control)
    nums["failed"] = counts(win)["failed"]
    nums["wave_s"] = win["seconds"]
    return nums
