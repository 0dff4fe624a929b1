"""Serving-request synthesis for the engine (``repro/data/requests.py``).

Keeps its own copy of the trace statistics and the constant-rate Poisson
synthesis of ``repro/core/trace.py`` (``TRACE_SPECS``,
``_lognormal_params``, ``synthesize_trace``), drawing from
``random.Random(seed)`` in the same order, so the same arguments give the
same requests as the reference.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

import numpy as np

# (ctx mean, ctx std, gen mean, gen std) of the paper's Table 1 traces
TRACE_SPECS: Dict[str, Tuple[float, float, float, float]] = {
    "summarization": (2742.11, 944.33, 172.22, 73.17),
    "creation": (306.82, 81.03, 1128.34, 419.64),
    "chat": (73.32, 148.65, 189.47, 174.18),
}


def _lognormal_params(mean: float, std: float) -> Tuple[float, float]:
    """(mu, sigma) of a log-normal with the given mean/std."""
    var = std * std
    sigma2 = math.log(1.0 + var / (mean * mean))
    mu = math.log(mean) - sigma2 / 2.0
    return mu, math.sqrt(sigma2)


def _synthesize(trace: str, arrival_rate: float, n: int, seed: int,
                max_len: int) -> List[Tuple[float, int, int]]:
    """(arrival, context_len, gen_len) of n Poisson arrivals with
    log-normal lengths clamped to [1, max_len]."""
    if arrival_rate <= 0:
        raise ValueError(f"arrival_rate must be positive, got "
                         f"{arrival_rate}")
    if n <= 0:
        raise ValueError(f"num_requests must be positive, got {n}")
    ctx_mean, ctx_std, gen_mean, gen_std = TRACE_SPECS[trace]
    rng = random.Random(seed)
    cmu, csig = _lognormal_params(ctx_mean, ctx_std)
    gmu, gsig = _lognormal_params(gen_mean, gen_std)
    out = []
    t = 0.0
    for _ in range(n):
        t += rng.expovariate(arrival_rate)
        ctx = max(1, min(max_len, int(round(rng.lognormvariate(cmu, csig)))))
        gen = max(1, min(max_len, int(round(rng.lognormvariate(gmu, gsig)))))
        out.append((t, ctx, gen))
    return out


def make_serving_requests(trace: str, arrival_rate: float, n: int,
                          vocab_size: int, seed: int = 0,
                          max_len: int = 2048) -> List[dict]:
    """Concrete requests (rid, arrival, prompt token ids, gen_len)."""
    rng = np.random.RandomState(seed + 1)
    out = []
    for rid, (arrival, ctx, gen) in enumerate(
            _synthesize(trace, arrival_rate, n, seed, max_len)):
        out.append({
            "rid": rid,
            "arrival": arrival,
            "prompt": rng.randint(1, vocab_size,
                                  size=(ctx,)).astype(np.int32),
            "gen_len": gen,
        })
    return out
