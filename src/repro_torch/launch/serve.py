"""Serving entry point of the port: APEX plan search, then the real engine
on one card (the twin of ``repro/launch/serve.py``).

Given (arch, trace, cluster), ``plan`` runs ``ApexSearch`` for the FULL
model on the named cluster preset (the port's simulator on analytic
tables) and logs the heuristic baseline beside the best plan; then
``serve`` serves synthetic requests of the same trace on one card.
``plan_and_serve`` (the command line) runs both in turn.

The search covers every plan, cell-level data parallelism included, as
``repro/launch/serve.py`` does, where there are at most
``MAX_SEARCH_PLANS``; a block of many cells has more (gemma3-12b's 12
cells: over 100,000 on h100x8, hours of simulation), and is searched
over the plans current systems run (``feasible_only``: 10 for gemma3).
It runs in this process (``jobs=1``): no worker is forked after the
engine has touched CUDA.

``serve`` builds a config (default qwen2-0.5b at its FULL published
size, or at the first ``depth`` blocks of it, as mixtral-8x7b needs on
one H100; deepseek-v2-lite-16b fits whole, 31.4 GB in bf16, and so does
zamba2-7b, whose ``depth`` counts its 6-layer repeats), draws random
weights from a seeded ``torch.Generator``, serves
chat-trace requests through ``ServingEngine`` and prints TTFT, TPOT and
throughput.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --requests 8

Stub-frontend archs (qwen2-vl-7b, fed patch embeddings; the
encoder-decoder seamless-m4t-large-v2, fed frame embeddings) get the
search and no engine run: ``serve`` raises ``ValueError`` for them, as
the reference skips its engine demo, since the engine serves token
prompts.  seamless serves through ``models.encdec.encdec_prefill`` and
``encdec_decode_step``.  An arch the port has no config for raises
``KeyError`` before the search.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import torch

from repro_torch import configs as C
from repro_torch.core import ApexSearch, get_cluster, get_trace
from repro_torch.core.planner import generate_schemes
from repro_torch.data.requests import make_serving_requests
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import EngineReport, ServingEngine

# the simulator's trace for the plan search (as in repro/launch/serve.py)
SEARCH_RATE = 0.5
SEARCH_REQUESTS = 64
MAX_SEARCH_PLANS = 1000


def stub_frontend(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s inputs come from a stubbed modality frontend (an
    encoder over frames, or patch embeddings), which the reference's
    serve skips the engine for."""
    return cfg.encoder is not None or cfg.embeds_input


def serve(arch: str = "qwen2-0.5b", size: str = "full",
          trace: str = "chat", requests: int = 8, max_batch: int = 4,
          max_len: int = 512, prompt_cap: int = 128, gen_cap: int = 64,
          seed: int = 0, device=None, log=print,
          depth: Optional[int] = None) -> Tuple[EngineReport, List[dict]]:
    """Serve ``requests`` synthetic requests, all arriving at t=0; returns
    the engine's report and the requests as served (prompts cut to
    ``prompt_cap`` tokens, ``gen_len`` to ``gen_cap``).  ``depth`` cuts
    the model to that many blocks at full width, prefix blocks
    (deepseek's dense first layer) included, so it must exceed their
    number."""
    if size not in ("full", "reduced"):
        raise ValueError(f"size must be 'full' or 'reduced', got {size!r}")
    cfg = C.get_config(arch) if size == "full" else C.get_reduced(arch)
    if stub_frontend(cfg):
        raise ValueError(f"{cfg.name}: stub-frontend arch, no engine demo "
                         f"(as in repro/launch/serve.py); an "
                         f"encoder-decoder serves through "
                         f"models.encdec.encdec_prefill")
    dev = resolve_device(device)
    cfg = C.at_depth(cfg, depth)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(gen, cfg, device=dev)
    # the engine runs at time_scale=0.0, which moves every arrival to t=0,
    # so the rate is a placeholder: prompts and gen_len do not depend on it
    reqs = make_serving_requests(trace, 1.0, requests, cfg.vocab_size,
                                 seed=seed, max_len=prompt_cap)
    for r in reqs:
        r["gen_len"] = min(r["gen_len"], gen_cap)
    engine = ServingEngine(cfg, params, max_batch=max_batch,
                           max_len=max_len, device=dev)
    report = engine.run(reqs, time_scale=0.0)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"engine [{cfg.name} {cfg.dtype} on {name}]: "
        f"{len(report.results)} requests in {report.total_time:.3f}s, "
        f"{report.iterations} iterations, "
        f"TTFT {report.ttft_mean * 1e3:.1f}ms "
        f"TPOT {report.tpot_mean * 1e3:.2f}ms "
        f"throughput {report.throughput:.1f} tok/s")
    return report, reqs


def plan(arch: str = "qwen2-0.5b", trace: str = "chat",
         cluster: str = "h100x8", log=print):
    """APEX plan search for ``arch`` FULL on ``cluster``: returns the
    baseline report and the search result, and logs both."""
    model = C.get_config(arch).to_ir()
    clu = get_cluster(cluster)
    reqs = get_trace(trace, arrival_rate=SEARCH_RATE,
                     num_requests=SEARCH_REQUESTS)
    search = ApexSearch(model, clu)
    base = search.evaluate_baseline(reqs)
    feasible_only = len(generate_schemes(
        model, clu.num_devices,
        max_schemes=MAX_SEARCH_PLANS + 1)) > MAX_SEARCH_PLANS
    best = search.search(reqs, feasible_only=feasible_only)
    log(f"APEX: baseline {base.plan_label} e2e={base.e2e_latency:.1f}s")
    log(f"APEX: optimal  {best.best.plan_label} "
        f"e2e={best.best.e2e_latency:.1f}s "
        f"({base.e2e_latency / best.best.e2e_latency:.2f}x) "
        f"[{best.num_schemes} plans in {best.search_seconds:.1f}s"
        f"{', the plans current systems run' if feasible_only else ''}]")
    return base, best


def plan_and_serve(arch: str = "qwen2-0.5b", trace: str = "chat",
                   requests: int = 8, cluster: str = "h100x8",
                   size: str = "full", device=None, log=print,
                   depth: Optional[int] = None, **engine):
    """Plan search for ``arch`` FULL on ``cluster``, then the engine on
    ``arch`` at ``size`` (``engine``: ``serve``'s other arguments, its
    defaults otherwise), at ``depth`` blocks if given (the search prices
    every block); returns (baseline report, search result, engine report,
    requests as served), the last two None and [] for a stub-frontend
    arch, whose engine run is skipped."""
    base, best = plan(arch, trace, cluster, log)
    cfg = (C.get_config if size == "full" else C.get_reduced)(arch)
    if stub_frontend(cfg):
        log(f"({size} engine demo skipped: stub-frontend arch)")
        return base, best, None, []
    report, reqs = serve(arch, size, trace, requests, device=device,
                         log=log, depth=depth, **engine)
    return base, best, report, reqs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=sorted(C.ALIASES))
    ap.add_argument("--size", default="full", choices=("full", "reduced"))
    ap.add_argument("--trace", default="chat")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--cluster", default="h100x8",
                    help="the cluster preset the plan search is for")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--prompt-cap", type=int, default=128)
    ap.add_argument("--gen-cap", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card)")
    ap.add_argument("--depth", type=int, default=None,
                    help="blocks kept (default: all)")
    args = ap.parse_args(argv)
    plan_and_serve(args.arch, args.trace, args.requests, args.cluster,
                   args.size, args.device, depth=args.depth,
                   max_batch=args.max_batch, max_len=args.max_len,
                   prompt_cap=args.prompt_cap, gen_cap=args.gen_cap,
                   seed=args.seed)


if __name__ == "__main__":
    main()
