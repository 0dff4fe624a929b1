"""One run of one cell: find its pieces, run its kind's driver
(``bench/traffic/<kind>.py``), read its metrics, and print the result
line.

The result is the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with its value and limit, which also end standard
error.  A run with no CUDA card, fewer cards than the cell asks for, or
the JAX package loaded once the window has closed prints no result and
exits non-zero.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from types import SimpleNamespace
from typing import Callable, Optional

from . import check, flops, spec

# whole top-level module names that the benchmark's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context(SimpleNamespace):
    """What a driver is given: the cell's pieces and the run's arguments,
    and the hooks it calls."""

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t0

    def log(self, msg: str) -> None:
        log(msg)

    def memory_peak(self) -> Optional[int]:
        import torch
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _merge(base: dict, over: Optional[dict]) -> dict:
    return {**base, **(over or {})}


def build_context(workload: str, seed: int, seconds: float, trace: bool,
                  t0: float, device=None, overrides: Optional[dict] = None
                  ) -> Context:
    """The cell's pieces by name; without ``device``, the first CUDA card,
    after checking that the cell's cards are there."""
    import torch
    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device is visible")
        have = torch.cuda.device_count()
        if have < wl["chips"]:
            raise NoDevice(f"{workload} needs {wl['chips']} CUDA devices, "
                           f"{have} are visible")
        device = "cuda:0"
    device = torch.device(device)
    over = overrides or {}
    return Context(
        bench=bench, workload=wl, name=workload, seed=seed,
        seconds=seconds, trace=trace, t0=t0, device=device,
        conf=_merge(spec.config(bench, wl["config"]), over.get("conf")),
        mix=_merge(spec.traffic(wl["traffic"]), over.get("mix")),
        cell=_merge(spec.cell(workload), over.get("cell")),
        setup_s=None)


def device_info(ctx: Context, out: dict) -> dict:
    import torch
    cuda = ctx.device.type == "cuda"
    info = {"platform": "gpu" if cuda else ctx.device.type,
            "kind": torch.cuda.get_device_name(ctx.device) if cuda
            else ctx.device.type,
            "count": ctx.workload["chips"] if cuda else 1,
            "memory_peak_bytes": out.get("memory_peak_bytes")}
    tr = out.get("device_trace")
    if ctx.trace and tr is not None:
        info["busy_s"] = tr.busy_ns() / 1e9
        info["window_s"] = tr.window_ns() / 1e9
    return info


def read_metrics(ctx: Context, out: dict, dev: dict) -> dict:
    run = SimpleNamespace(conf=ctx.conf, mix=ctx.mix, out=out,
                          flops=flops, peaks=flops.peaks(dev["kind"]))
    metrics = {}
    for m in spec.metrics(ctx.bench, ctx.name, ctx.trace):
        if ctx.trace:
            value = spec.reader(m["name"])(run)
        elif m["name"] == "setup_s":
            value = ctx.setup_s
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float, device=None, overrides: Optional[dict] = None,
             emit: Callable[[str], None] = print) -> dict:
    """Run the cell once and emit its result line; returns the result."""
    ctx = build_context(workload, seed, seconds, trace, t0, device,
                        overrides)
    out = spec.kind(ctx.mix["kind"]).run(ctx)
    bad = forbidden_modules()
    if bad:
        raise Forbidden(f"the process holds {bad} after the window")
    dev = device_info(ctx, out)
    result = {"correct": out["failed"] == 0 and check.passed(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": read_metrics(ctx, out, dev), "device": dev}
    if trace and out.get("device_trace") is not None:
        tr = out["device_trace"]
        result["breakdown"] = {"device_ops": tr.top_kernels(10),
                               "idle_gaps": tr.top_gaps(10)}
    result["checks"] = out["checks"]
    log(f"attempted {result['attempted']} failed {result['failed']} "
        f"correct {result['correct']}")
    for k, c in out["checks"].items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    emit(json.dumps(result))
    return result
