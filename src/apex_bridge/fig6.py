"""Fig. 6 on one card: the simulator's predicted serving time against the
port's real engine (the twin of ``benchmarks/fig6_fidelity.py``).

The paper scores APEX's predicted speedups against real serving runs on
GPUs (mean relative error 10.7%).  Here the real engine is the port's
``ServingEngine`` serving qwen2-0.5b on seeded random weights in bf16, and
the simulator is ``ApexSearch`` on the same model's IR for one H100
(``h100_node(1)``), the heuristic plan in bf16 and
``BatchingPolicy(max_batch_size=cap, fast_forward=False)``, as in the
reference.  The variants are batch-size caps.  For each cap the engine's
total time is the actual, and three backends predict it:

  * ``wall``     -- tables the port's profiler measured on the card, host
                    clock around each synchronised op (the reference's
                    clock);
  * ``device``   -- the same samples read on CUDA events;
  * ``analytic`` -- ``AnalyticBackend(h100_node(1))``, the roofline model
                    every H100 plan search rests on.

Reported per cap: actual and predicted seconds, each one's ratio to the
largest cap's, and each backend's relative error on that ratio; then each
backend's mean relative error.  TTFT and TPOT means are reported apart,
predicted against actual, and are not mixed into the ratios: the engine
replays a prompt through one decode step per token, the simulator prices
it as one token-parallel prefill.  Last, for every ``(op, axes)`` table
the search filled, measured over analytic time at a few grid points.

The tables and the engine runs come from one process on one card (host
clocks differ between hosts).  Before the timed runs an untimed engine
run builds the kernels and warms the card.

    PYTHONPATH=src python -m apex_bridge.fig6 --size full
    PYTHONPATH=src python -m apex_bridge.fig6 --size reduced --device cpu
"""

from __future__ import annotations

import argparse
import shutil
import statistics
import subprocess
from typing import Dict, List, Optional, Sequence

import torch

from repro.core import (AnalyticBackend, ApexSearch, BatchingPolicy,
                        Request, h100_node)
from repro.core.planner import heuristic_scheme

from repro_torch import configs as C
from repro_torch.data.requests import make_serving_requests
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServingEngine

from .ir import model_ir
from .profiles import TorchMeasuredBackend

ARCH = "qwen2-0.5b"
# size -> (requests, prompt tokens at most, tokens generated, caps,
# engine max_len)
CASES = {
    "reduced": dict(requests=6, ctx=12, gen=8, caps=(1, 2, 4), max_len=64),
    "full": dict(requests=8, ctx=128, gen=64, caps=(1, 2, 4, 8),
                 max_len=512),
}
BACKENDS = ("wall", "device", "analytic")
X_MAX = 4096
REPEATS = 3
PAPER_MEAN_ERR = 0.107
OPTABLE_X = (1, 16, 256, 4096)


def card_text(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if dev.type != "cuda":
        return "cpu"
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return f"{torch.cuda.get_device_name(dev)} (nvidia-smi not found)"
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def make_requests(vocab_size: int, requests: int, ctx: int, gen: int,
                  seed: int) -> List[dict]:
    """Chat-trace requests, all at t=0: prompts of at most ``ctx`` tokens,
    ``gen`` tokens each (the reference's mix)."""
    reqs = make_serving_requests("chat", 1000.0, requests, vocab_size,
                                 seed=seed, max_len=ctx)
    for r in reqs:
        r["gen_len"] = gen
        r["prompt"] = r["prompt"][:ctx]
    return reqs


def engine_runs(cfg, reqs: List[dict], caps: Sequence[int], max_len: int,
                dev: torch.device, seed: int) -> Dict[int, object]:
    """The engine's report for each cap, on one set of seeded weights;
    after one untimed warm-up run."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(gen, cfg, device=dev)
    warm = [dict(reqs[0], gen_len=2)]
    ServingEngine(cfg, params, max_batch=1, max_len=max_len,
                  device=dev).run(warm, time_scale=0.0)
    return {cap: ServingEngine(cfg, params, max_batch=cap, max_len=max_len,
                               device=dev).run([dict(r) for r in reqs],
                                               time_scale=0.0)
            for cap in caps}


def predictions(model, backend, reqs: List[dict], caps: Sequence[int],
                x_max: Optional[float]) -> Dict[int, object]:
    """The simulator's report for each cap on ``backend``'s tables."""
    cluster = h100_node(1)
    search = ApexSearch(model, cluster, backend=backend)
    search.store.x_max = x_max
    scheme = heuristic_scheme(model, 1, cluster, quant="bf16")
    sim_reqs = [Request(rid=r["rid"], arrival=0.0,
                        context_len=len(r["prompt"]), gen_len=r["gen_len"])
                for r in reqs]
    return {cap: search.evaluate(
        scheme, sim_reqs, policy=BatchingPolicy(max_batch_size=cap,
                                                fast_forward=False))
        for cap in caps}


def op_table(measured: TorchMeasuredBackend) -> List[dict]:
    """Measured (wall, device) over analytic time for every ``(op, axes)``
    table the profiler filled, at those of ``OPTABLE_X`` it sampled."""
    analytic = AnalyticBackend(h100_node(1))
    keys = sorted({(op, axes) for op, axes, _ in measured.samples},
                  key=str)
    rows = []
    for op, axes in keys:
        for x in OPTABLE_X:
            sample = measured.samples.get((op, axes, float(x)))
            if sample is None:
                continue
            t_an = analytic.measure(op, axes, float(x))[0]
            rows.append(dict(op=op, axes=axes, x=x, wall_s=sample[0],
                             device_s=sample[1], analytic_s=t_an))
    return rows


def run(size: str = "reduced", device=None,
        caps: Optional[Sequence[int]] = None, x_max: Optional[float] = X_MAX,
        seed: int = 0, log=print) -> dict:
    """Fig. 6 for qwen2-0.5b at ``size`` ("reduced": the reference's own
    case; "full": the published width), at the case's caps unless
    ``caps`` is given, profiling x up to ``x_max``.  Returns the per-cap
    rows, each backend's mean relative error, the TTFT/TPOT means and the
    op-table comparison."""
    if size not in CASES:
        raise ValueError(f"size must be one of {sorted(CASES)}, got "
                         f"{size!r}")
    case = CASES[size]
    caps = tuple(caps or case["caps"])
    dev = resolve_device(device)
    cfg = (C.get_config if size == "full" else C.get_reduced)(ARCH)
    model = model_ir(cfg)
    card = card_text(dev)
    reqs = make_requests(cfg.vocab_size, case["requests"], case["ctx"],
                         case["gen"], seed)
    log(f"fig6 [{cfg.name} {cfg.dtype} on {card}]: {len(reqs)} chat "
        f"requests at t=0, prompts {[len(r['prompt']) for r in reqs]}, "
        f"{case['gen']} tokens each, caps {list(caps)}")

    actual = engine_runs(cfg, reqs, caps, case["max_len"], dev, seed)
    measured = TorchMeasuredBackend("wall", device=dev, repeats=REPEATS)
    backends = {"wall": measured, "device": measured.sibling("device"),
                "analytic": AnalyticBackend(h100_node(1))}
    predicted = {name: predictions(model, b, reqs, caps,
                                   None if name == "analytic" else x_max)
                 for name, b in backends.items()}

    ref = max(caps)
    prompt_steps = sum(len(r["prompt"]) for r in reqs)
    rows = []
    for cap in caps:
        act = actual[cap]
        row = dict(cap=cap, actual_s=act.total_time,
                   actual_ratio=act.total_time / actual[ref].total_time,
                   engine_iterations=act.iterations,
                   engine_steps=act.iterations + prompt_steps)
        for name in BACKENDS:
            rep = predicted[name][cap]
            ratio = rep.e2e_latency / predicted[name][ref].e2e_latency
            row[f"{name}_s"] = rep.e2e_latency
            row[f"{name}_ratio"] = ratio
            row[f"{name}_err"] = abs(ratio - row["actual_ratio"]) / \
                row["actual_ratio"]
            row[f"{name}_iterations"] = rep.iterations
        rows.append(row)
        log(f"fig6 cap {cap}: actual {act.total_time:.4f} s "
            f"({row['engine_steps']} engine steps: {act.iterations} "
            f"iterations + {prompt_steps} prompt-replay steps, "
            f"{act.total_time / row['engine_steps'] * 1e3:.3f} ms/step) | "
            + " | ".join(
                f"{name} {row[f'{name}_s']:.4f} s "
                f"({row[f'{name}_iterations']} iterations)"
                for name in BACKENDS)
            + f" | ratio to cap {ref}: actual {row['actual_ratio']:.3f}, "
            + ", ".join(f"{name} {row[f'{name}_ratio']:.3f} (err "
                        f"{row[f'{name}_err']:.1%})" for name in BACKENDS))
    mean_err = {name: statistics.mean(r[f"{name}_err"] for r in rows)
                for name in BACKENDS}
    log("fig6 mean relative error: " + ", ".join(
        f"{name} {mean_err[name]:.1%}" for name in BACKENDS)
        + f" (paper: {PAPER_MEAN_ERR:.1%})")

    latency = {}
    for metric in ("ttft_mean", "tpot_mean"):
        latency[metric] = {cap: dict(
            actual_s=getattr(actual[cap], metric),
            **{f"{name}_s": getattr(predicted[name][cap], metric)
               for name in BACKENDS}) for cap in caps}
        log(f"fig6 {metric.split('_')[0].upper()} mean, actual / "
            f"{' / '.join(BACKENDS)} (ms): " + "; ".join(
                f"cap {cap} {v['actual_s'] * 1e3:.2f} / "
                + " / ".join(f"{v[f'{name}_s'] * 1e3:.3f}"
                             for name in BACKENDS)
                for cap, v in latency[metric].items()))

    table = op_table(measured)
    for r in table:
        log(f"fig6 op table {r['op']} {r['axes']} x {r['x']}: wall "
            f"{r['wall_s'] * 1e3:.4f} ms, device {r['device_s'] * 1e3:.4f} "
            f"ms, analytic {r['analytic_s'] * 1e3:.4f} ms | measured / "
            f"analytic: wall {r['wall_s'] / r['analytic_s']:.2f}, device "
            f"{r['device_s'] / r['analytic_s']:.2f}")
    return dict(size=size, card=card, rows=rows, mean_err=mean_err,
                latency=latency, op_table=table)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="full", choices=sorted(CASES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    run(args.size, args.device, seed=args.seed)


if __name__ == "__main__":
    main()
