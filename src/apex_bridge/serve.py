"""Serving entry point: APEX plan search, then the port's engine on one card
(the twin of ``repro/launch/serve.py``).

Given (arch, trace, cluster), ``ApexSearch`` finds the best parallel plan
for the FULL model on the named cluster preset (analytic tables) and logs
it beside the heuristic baseline; then ``repro_torch.launch.serve.serve``
serves synthetic requests of the same trace on one card (CUDA unless
``device="cpu"``).  An arch the port has no config for raises
(``KeyError``) before the search.  ``depth`` serves the first blocks of
the model at full width: mixtral-8x7b FULL is 93.4 GB in bf16, and one
80 GB H100 holds 16 of its 32 layers (``--depth 16``); gemma3-12b FULL
(23.5 GB) serves all 48 layers.

As in ``repro/launch/serve.py``, a stub-frontend arch (qwen2-vl-7b's
patch embeddings, seamless-m4t-large-v2's encoder over frame
embeddings) gets the search and no engine run: the engine serves token
prompts only, and ``repro_torch.launch.serve`` refuses such an arch.

The search covers every plan, cell-level data parallelism included, as
``repro/launch/serve.py`` does, where there are at most
``MAX_SEARCH_PLANS``; a block of many cells has more (gemma3-12b's 12
cells: over 100,000 on h100x8, hours of simulation), and is searched
over the plans current systems run (``feasible_only``: 10 for gemma3).

    PYTHONPATH=src python -m apex_bridge.serve --arch qwen2-0.5b \\
        --trace chat --requests 8
"""

from __future__ import annotations

import argparse

from repro.core import ApexSearch, get_cluster, get_trace
from repro.core.planner import generate_schemes

from repro_torch import configs as C
from repro_torch.launch import serve as port_serve

from .ir import model_ir

# the simulator's trace for the plan search (as in repro/launch/serve.py)
SEARCH_RATE = 0.5
SEARCH_REQUESTS = 64
MAX_SEARCH_PLANS = 1000


def serve(arch: str = "qwen2-0.5b", trace: str = "chat", requests: int = 8,
          cluster: str = "h100x8", size: str = "full", device=None,
          log=print, depth=None):
    """Plan search for ``arch`` FULL on ``cluster``, then the engine on
    ``arch`` at ``size`` with the port entry point's defaults (4 slots of
    512, prompts cut to 128 tokens, outputs to 64, seed 0), at ``depth``
    blocks if given (the search prices every block); returns (baseline
    report, search result, engine report), the last None for a
    stub-frontend arch, whose engine run is skipped."""
    model = model_ir(C.get_config(arch))
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
    cfg = (C.get_config if size == "full" else C.get_reduced)(arch)
    if port_serve.stub_frontend(cfg):
        log(f"({size} engine demo skipped: stub-frontend arch)")
        return base, best, None
    report, _ = port_serve.serve(arch, size, trace, requests,
                                 device=device, log=log, depth=depth)
    return base, best, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--trace", default="chat")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--cluster", default="h100x8")
    ap.add_argument("--size", default="full", choices=("full", "reduced"))
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card)")
    ap.add_argument("--depth", type=int, default=None,
                    help="blocks the engine keeps (default: all)")
    args = ap.parse_args(argv)
    serve(args.arch, args.trace, args.requests, args.cluster, args.size,
          args.device, depth=args.depth)


if __name__ == "__main__":
    main()
