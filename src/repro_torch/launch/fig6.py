"""Fig. 6 on one card: the simulator's predicted serving time against the
port's real engine, for any arch the engine serves (the twin of
``benchmarks/fig6_fidelity.py``, whose ``run(arch=...)`` this follows).

The paper scores APEX's predicted speedups against real serving runs on
GPUs (mean relative error 10.7%).  Here the real engine is the port's
``ServingEngine`` serving ``arch`` (default qwen2-0.5b) on seeded random
weights in bf16, and the simulator is ``ApexSearch`` on the same model's
IR for one H100 (``h100_node(1)``), the heuristic plan in bf16 and
``BatchingPolicy(max_batch_size=cap, fast_forward=False)``, as in the
reference.  The variants are batch-size caps.  For each cap the engine's
total time is the actual, and three backends predict it:

  * ``wall``     -- tables the port's profiler measured on the card, host
                    clock around each synchronised op (the reference's
                    clock);
  * ``device``   -- the same samples read on CUDA events;
  * ``analytic`` -- ``AnalyticBackend(h100_node(1))``, the roofline model
                    every H100 plan search rests on.

``depth`` keeps the first ``depth`` blocks of the model at full width
(``configs.at_depth``): mixtral-8x7b FULL is 93.4 GB in bf16 and one
80 GB card holds 16 of its 32 layers.  The engine serves that cut and the
simulator prices the same cut (``to_ir`` of the cut config): the
simulator is scored on the model that ran, not scaled to the whole one.

Each FULL arch has its own case (``FULL_CASES``: requests, prompt cap,
output length, caps, depth), sized so that one run, the kernels' build
included, ends well inside 900 s on one H100: the engine replays every
prompt one decode step per token, so a run takes about ``len(caps) *
sum(prompts) + sum(outputs) * sum(1 / cap)`` decode steps.  Where the
simulator's memory model refuses the whole model on one H100
(qwen1.5-32b; mamba2-2.7b and zamba2-7b, whose SSM state it reserves for
512 sequences), the case's depth is the largest cut it admits; a run the
simulator finds infeasible raises ``ValueError``.
qwen2-vl-7b and seamless-m4t-large-v2 raise ``ValueError`` before any
engine run: their inputs come from stubbed frontends (patch and frame
embeddings), the engine serves token prompts only, and the reference
skips its engine demo for them too.

Reported per cap: actual and predicted seconds, each one's ratio to the
largest cap's, and each backend's relative error on that ratio; then each
backend's mean relative error.  TTFT and TPOT means are reported apart,
predicted against actual, and are not mixed into the ratios.  The
``fig6 departure`` lines name where the simulator prices something other
than what the engine runs (printed, not tuned away): the prompt replay
against one token-parallel prefill, the IR's weight bytes against the
engine's parameters, deepseek's dense first layer (the IR prices every
layer as MoE), MLA's absorbed decode against the expanded one the engine
runs, the SSD-scan table that prices SSM decode against the recurrence
the engine runs, the profiler's SSD head dim, the SSM state reserved for
512 sequences, zamba2's shared block counted once a block, and the
expected-activated expert products against the engine's dense dispatch.  ``fig6 step``
breaks one decode step at the largest cap, every slot at the case's mean
context, into the engine's (wall, CUDA events, device kernels by family,
launches) and the simulator's (each backend's iteration by op family).
Last, for every ``(op, axes)`` table the search filled, measured over
analytic time at a few grid points.

On a card the run fails unless every engine step launched the RMSNorm
kernel, and the decode-attention kernel where the arch has attention,
and unless every profiled sample is finite and at or above the time the
H100 needs for the work the simulator charges it.  The tables and the
engine runs come from one process on one card (host clocks differ
between hosts).  Before the timed runs an untimed engine run builds the
kernels and warms the card.

    PYTHONPATH=src python -m repro_torch.launch.fig6 --arch mixtral-8x7b --size full
    PYTHONPATH=src python -m repro_torch.launch.fig6 --arch gemma3-12b --size full \\
        --depth 4
    PYTHONPATH=src python -m repro_torch.launch.fig6 --size reduced --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import math
import shutil
import statistics
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import configs as C
from repro_torch.core import (AnalyticBackend, ApexSearch, BatchingPolicy,
                              Request, h100_node)
from repro_torch.core.ir import Workload
from repro_torch.core.mapper import map_scheme
from repro_torch.core.planner import ParallelScheme, heuristic_scheme
from repro_torch.core.profiles import (SSD_HEAD_DIM, TorchMeasuredBackend,
                                       _op_work)
from repro_torch.core.quant import get_format
from repro_torch.core.simulator import PlanSimulator
from repro_torch.core.templates import expected_activated
from repro_torch.data.requests import make_serving_requests
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.launch.serve import stub_frontend
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServingEngine

ARCH = "qwen2-0.5b"
# size -> (requests, prompt tokens at most, tokens generated, caps,
# engine max_len)
CASES = {
    "reduced": dict(requests=6, ctx=12, gen=8, caps=(1, 2, 4), max_len=64),
    "full": dict(requests=8, ctx=128, gen=64, caps=(1, 2, 4, 8),
                 max_len=512),
}
# arch -> the fields of CASES["full"] it replaces; "depth" is the blocks
# the engine serves and the simulator prices (default all)
FULL_CASES = {
    "qwen2-0.5b": {},
    "internlm2-1.8b": {},
    # the largest cut the simulator's memory model admits on one H100
    # (61 blocks are 67.2 GB of IR weights; 62 are refused)
    "qwen1.5-32b": dict(ctx=64, gen=32, depth=61),
    "mixtral-8x7b": dict(ctx=64, gen=32, depth=16),
    "gemma3-12b": dict(ctx=64, gen=32),
    "deepseek-v2-lite-16b": dict(requests=4, ctx=32, gen=16,
                                 caps=(1, 2, 4)),
    # the simulator reserves SSM state for 512 sequences whatever the cap:
    # the largest cuts it admits on one H100 (47 and 10 are refused)
    "mamba2-2.7b": dict(requests=4, ctx=64, gen=16, caps=(1, 2, 4),
                        depth=46),
    "zamba2-7b": dict(requests=4, ctx=32, gen=16, caps=(1, 2, 4), depth=9),
}
BACKENDS = ("wall", "device", "analytic")
X_MAX = 4096
REPEATS = 3
PAPER_MEAN_ERR = 0.107
OPTABLE_X = (1, 16, 256, 4096)
# decode steps the step breakdown times (after one untimed step)
STEP_REPEATS = {"cuda": 8, "cpu": 2}
# the simulator's op families in the step breakdown; "moe gemm" is the
# part of "gemm" inside MoE cells (router, routed and shared experts)
SIM_FAMILIES = ("gemm", "attn_decode", "ssd_scan", "lm_head", "moe gemm")
# kernel-name fragments of cuBLAS / CUTLASS matrix products
GEMM_WORDS = ("gemm", "gemv", "cutlass", "nvjet", "xmma", "splitk")
EXPERT_RANGE = "moe_forward"
# the sequences whose SSM state the simulator's memory model reserves
STATE_SEQUENCES = inspect.signature(
    ParallelScheme.kv_token_capacity).parameters["max_sequences"].default


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


def case_of(arch: str, size: str) -> dict:
    """The request case of ``arch`` at ``size``: ``CASES[size]``, at FULL
    with the arch's ``FULL_CASES`` fields."""
    if size not in CASES:
        raise ValueError(f"size must be one of {sorted(CASES)}, got "
                         f"{size!r}")
    case = dict(CASES[size], depth=None)
    if size == "full":
        case.update(FULL_CASES.get(arch, {}))
    return case


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


def launches() -> Dict[str, int]:
    """The RMSNorm and decode-attention kernels' launches so far in this
    process (their wrappers count a launch on CUDA tensors only)."""
    return {"rmsnorm": _rmsnorm.launches,
            "decode_attention": _decode.launches}


def has_attention(cfg) -> bool:
    return cfg.shared_attn or any(s.kind != "ssm"
                                  for s in cfg.block_pattern)


@contextlib.contextmanager
def expert_range():
    """Kept for callers that enter it: each MoE FFN is already a
    ``moe_forward`` range of its own (``repro_torch.tracing``) while a
    profile records, so this adds nothing."""
    yield


def device_families(prof, steps: int) -> dict:
    """Device ms a step of the profile's kernels by family (from
    ``key_averages``, which also holds the kernels the wrappers launch
    through ctypes); ``moe gemm`` is the matrix products launched inside
    an MoE FFN (also counted in ``gemm``: each kernel attributed through
    the PyTorch op that launched it and that op's enclosing ranges),
    ``kernels`` the kernels a step."""
    fam = dict.fromkeys(("gemm", "decode_attention", "rmsnorm", "other",
                         "moe gemm"), 0.0)
    n = 0
    for e in prof.key_averages():
        if "cuda" not in str(e.device_type).lower() or e.key == EXPERT_RANGE:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        n += e.count
        name = e.key.lower()
        kind = ("decode_attention" if "decode_attention" in name else
                "rmsnorm" if "rmsnorm" in name else
                "gemm" if any(w in name for w in GEMM_WORDS) else "other")
        fam[kind] += us / 1e3
    for e in prof.events():
        names, p = set(), e
        while p is not None:
            names.add(p.name)
            p = p.cpu_parent
        if EXPERT_RANGE not in names:
            continue
        for k in getattr(e, "kernels", None) or ():
            if any(w in k.name.lower() for w in GEMM_WORDS):
                fam["moe gemm"] += k.duration / 1e3
    out = {k: v / steps for k, v in fam.items()}
    out["kernels"] = n / steps
    return out


def engine_step(cfg, params, cap: int, ctx: int, max_len: int,
                dev: torch.device) -> dict:
    """One decode step over ``cap`` slots, each at ``ctx`` cached tokens,
    run through ``decode_step`` directly: wall ms and CUDA-event ms a
    step, the kernels' launches a step, and (on a card) the device ms a
    step of its kernels by family under torch.profiler."""
    steps = STEP_REPEATS[dev.type]
    cache = T.init_cache(cfg, cap, max_len, device=dev,
                         cache_dtype=params.embed.dtype)
    cache["len"] = torch.full((cap,), ctx, dtype=torch.int32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (cap, 1), generator=gen
                         ).to(dev)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    T.decode_step(params, cfg, toks, cache)
    sync()
    before = launches()
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        T.decode_step(params, cfg, toks, cache)
    if cuda:
        end.record()
    sync()
    out = dict(wall_ms=(time.perf_counter() - t0) / steps * 1e3,
               events_ms=start.elapsed_time(end) / steps if cuda else None,
               launches={k: (v - before[k]) // steps
                         for k, v in launches().items()},
               device=None)
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                T.decode_step(params, cfg, toks, cache)
            sync()
        out["device"] = device_families(prof, steps)
    return out


def engine_runs(cfg, reqs: List[dict], caps: Sequence[int], max_len: int,
                ctx: int, dev: torch.device, seed: int) -> dict:
    """On one set of seeded weights, after one untimed warm-up run: the
    step breakdown at the largest cap, then the engine's report and
    decode steps for each cap, and the parameter count.  On a card, every
    step must launch the RMSNorm kernel, and the decode kernel where the
    arch has attention, as often as the direct step did."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(gen, cfg, device=dev)
    warm = [dict(reqs[0], gen_len=2)]
    ServingEngine(cfg, params, max_batch=1, max_len=max_len,
                  device=dev).run(warm, time_scale=0.0)
    step = engine_step(cfg, params, max(caps), ctx, max_len, dev)
    before = launches()
    reports, steps = {}, {}
    for cap in caps:
        engine = ServingEngine(cfg, params, max_batch=cap, max_len=max_len,
                               device=dev)
        rep = engine.run([dict(r) for r in reqs], time_scale=0.0)
        reports[cap] = rep
        steps[cap] = rep.replay_steps + rep.iterations
    launched = {k: v - before[k] for k, v in launches().items()}
    if dev.type == "cuda":
        want = {"rmsnorm": True, "decode_attention": has_attention(cfg)}
        total = sum(steps.values())
        for name, needed in want.items():
            per = step["launches"][name]
            if (needed and per <= 0) or launched[name] != total * per:
                raise RuntimeError(
                    f"fig6 {cfg.name}: {launched[name]} {name} launches in "
                    f"{total} engine steps, {per} a step in a direct "
                    f"decode_step: not every step ran the kernel")
    param_bytes = T.param_count(params) * params.embed.element_size()
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(reports=reports, steps=steps, step=step, launched=launched,
                param_bytes=param_bytes)


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


def simulated_step(model, backend, cap: int, ctx: int,
                   x_max: Optional[float]) -> dict:
    """The simulator's time for one decode iteration of ``cap`` sequences,
    each at ``ctx`` cached tokens, on ``backend``'s tables: ``total`` is
    ``PlanSimulator.iteration_cost``, the rest its op calls' times by
    family (``rest``: what no op call accounts for, collectives)."""
    cluster = h100_node(1)
    search = ApexSearch(model, cluster, backend=backend)
    search.store.x_max = x_max
    scheme = heuristic_scheme(model, 1, cluster, quant="bf16")
    sim = PlanSimulator(map_scheme(scheme, cluster), search.store,
                        search.coll)
    w = Workload.from_batch([], [ctx] * cap, sim.windows,
                            batch_sequences=cap)
    parts = dict.fromkeys(SIM_FAMILIES, 0.0)
    bps = sim.scheme.blocks_per_stage
    for cs in sim.scheme.cell_schemes:
        for op in cs.compute_ops(w, sim.q):
            t = search.store.time(op.op, op.axes, op.x) * op.count * bps
            parts[op.op] += t
            if cs.cell.kind == "moe":
                parts["moe gemm"] += t
    head = model.lm_head_opcall(cap, sim.q)
    parts["lm_head"] = search.store.time(
        head.op, (head.axes[0] // sim.scheme.stage_devices,
                  *head.axes[1:]), head.x)
    parts["total"] = sim.iteration_cost(w)[0]
    parts["rest"] = parts["total"] - sum(
        v for k, v in parts.items() if k not in ("moe gemm", "total"))
    return parts


def op_table(measured) -> List[dict]:
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


def check_samples(measured, cuda: bool) -> int:
    """Raise unless every profiled sample is finite and, on a card, at or
    above the H100's time for the work the simulator charges it (bytes at
    HBM bandwidth, FLOPs at the dtype's peak); returns the samples."""
    dev = h100_node(1).device
    for (op, axes, x), (wall, device) in measured.samples.items():
        flops, nbytes, dtype = _op_work(op, axes, x)
        bound = max(nbytes / dev.hbm_bw, flops / dev.flops(dtype))
        if not (math.isfinite(wall) and math.isfinite(device)) or (
                cuda and min(wall, device) < bound):
            raise RuntimeError(
                f"fig6 op table {op} {axes} x {x:g}: wall {wall:.3e} s, "
                f"device {device:.3e} s against the bound {bound:.3e} s: "
                f"not finite or below it")
    return len(measured.samples)


def departures(cfg, model, reqs: List[dict], param_bytes: int,
               steps: Dict[int, int], reports: dict) -> List[str]:
    """Where the simulator prices something other than what the engine
    runs, one line each (the expert products' line comes with the step
    breakdown, ``expert_departure``)."""
    prompts = sum(len(r["prompt"]) for r in reqs)
    ir_bytes = model.weight_bytes(get_format("bf16"))
    lines = [
        "prefill: the engine replays each prompt through one decode step "
        f"a token, {prompts} replay steps a cap ("
        + ", ".join(f"cap {c}: {steps[c]} steps = {reports[c].iterations} "
                    f"iterations + {steps[c] - reports[c].iterations}"
                    for c in steps)
        + "); the simulator prices one token-parallel prefill a request",
        f"weights: the IR's {ir_bytes / 1e9:.4g} GB (ModelIR.weight_bytes, "
        f"bf16) against the engine's {param_bytes / 1e9:.4g} GB "
        f"(param_count x the dtype's bytes), "
        f"{(ir_bytes - param_bytes) / 1e9:+.4g} GB"]
    if cfg.first_k_dense:
        k, n = cfg.first_k_dense, cfg.block_repeat
        lines.append(
            f"dense prefix: the IR prices {n} MoE layers (to_ir ignores "
            f"first_k_dense); the engine runs {k} dense and {n - k} MoE "
            f"layers")
    if cfg.attn_kind == "mla":
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        lines.append(
            f"MLA decode: the simulator prices the absorbed decode, "
            f"attn_decode ({cfg.n_heads}, {cfg.kv_lora_rank}) over the "
            f"latent; the engine runs the expanded form through the decode "
            f"kernel, q/k {qk} and v {cfg.v_head_dim} padded to "
            f"{_decode.padded_head_dim(qk)}")
    if any(s.kind == "ssm" for s in cfg.block_pattern):
        p = cfg.d_inner // cfg.n_ssd_heads
        per_seq = model.state_bytes_per_seq(get_format("bf16"))
        cap = max(steps)
        lines += [
            f"SSM decode: decode tokens are priced on the ssd_scan "
            f"({cfg.d_inner}, {cfg.d_state}) table at x = decode tokens, "
            f"the chunked scan kernel over x tokens; the engine's decode "
            f"runs mamba2_decode_step's recurrence, which launches no SSD "
            f"kernel",
            f"SSD head dim: the profiler's samples use heads of P "
            f"{SSD_HEAD_DIM}; the model runs P {p}"
            + (" (the same)" if p == SSD_HEAD_DIM else
               f", as {-(-p // SSD_HEAD_DIM)} panels of {SSD_HEAD_DIM}"
               if p > SSD_HEAD_DIM else ""),
            f"SSM state reserve: the simulator's memory model reserves the "
            f"state of {STATE_SEQUENCES} sequences whatever the cap, "
            f"{per_seq * STATE_SEQUENCES / 1e9:.4g} GB at "
            f"{cfg.block_repeat} blocks, against the {cap} sequences' "
            f"{per_seq * cap / 1e9:.4g} GB the engine holds at cap {cap}; "
            f"so a deep SSM model is refused on one H100 and Fig. 6 runs "
            f"the largest cut the simulator admits"]
    if cfg.shared_attn:
        lines.append(
            f"shared block: the IR's block holds the shared attention and "
            f"MLP cells, so their weights count {cfg.block_repeat} times; "
            f"the engine holds one set and applies it after each of the "
            f"{cfg.block_repeat} blocks (the compute is priced alike)")
    return lines


def expert_departure(cfg, cap: int, sim: dict, engine: dict) -> str:
    """The simulator's expert products for one decode iteration of ``cap``
    tokens (expected-activated experts, each over assignments / e_act
    rows) against the engine's, which dense dispatch runs over every
    expert."""
    e_act = max(1.0, expected_activated(cfg.n_routed, cfg.n_routed,
                                        float(cap * cfg.top_k)))
    dev = engine["device"]
    return (
        f"expert products: the simulator prices {e_act:.2f} "
        f"expected-activated of {cfg.n_routed} experts a layer, each over "
        f"{cap * cfg.top_k / e_act:.2f} rows"
        + (f", and {cfg.n_shared} shared" if cfg.n_shared else "")
        + f", at cap {cap}: MoE products "
        + ", ".join(f"{name} {sim[name]['moe gemm'] * 1e3:.3f} ms"
                    for name in BACKENDS)
        + "; the engine's dense dispatch runs all experts over every row: "
        + ("not measured (no card)" if dev is None else
           f"{dev['moe gemm']:.3f} ms of device time"))


def step_line(cap: int, ctx: int, engine: dict, sim: dict) -> str:
    """One decode step, the engine's against the simulator's."""
    dev = engine["device"]
    text = (f"[cap {cap}, context {ctx}]: engine wall "
            f"{engine['wall_ms']:.3f} ms, CUDA events "
            + ("not measured" if engine["events_ms"] is None else
               f"{engine['events_ms']:.3f} ms")
            + ", device kernels ")
    if dev is None:
        text += "not measured"
    else:
        busy = sum(dev[k] for k in ("gemm", "decode_attention", "rmsnorm",
                                    "other"))
        text += (f"{busy:.3f} ms (" + ", ".join(
            f"{k} {dev[k]:.3f}" for k in ("gemm", "moe gemm",
                                          "decode_attention", "rmsnorm",
                                          "other"))
            + f"; {dev['kernels']:.0f} kernels)")
    text += " | launches a step " + ", ".join(
        f"{k} {v}" for k, v in engine["launches"].items())
    text += " | simulator (ms): " + "; ".join(
        f"{name} " + ", ".join(f"{k} {sim[name][k] * 1e3:.3f}"
                               for k in (*SIM_FAMILIES, "rest", "total"))
        for name in BACKENDS)
    return text


def run(size: str = "reduced", device=None,
        caps: Optional[Sequence[int]] = None, x_max: Optional[float] = X_MAX,
        seed: int = 0, log=print, arch: str = ARCH,
        depth: Optional[int] = None) -> dict:
    """Fig. 6 for ``arch`` at ``size`` ("reduced": the reference's own
    case; "full": the published width, at the arch's ``FULL_CASES``
    case), cut to ``depth`` blocks (default: the case's), at the case's
    caps unless ``caps`` is given, profiling x up to ``x_max``.  Returns
    the per-cap rows, each backend's mean relative error, the TTFT/TPOT
    means, the departures, the step breakdown and the op-table
    comparison.  A stub-frontend arch raises ``ValueError``."""
    case = case_of(arch, size)
    caps = tuple(caps or case["caps"])
    depth = case["depth"] if depth is None else depth
    base = (C.get_config if size == "full" else C.get_reduced)(arch)
    if stub_frontend(base):
        raise ValueError(
            f"{arch}: its inputs come from a stubbed frontend (patch or "
            f"frame embeddings) and the engine serves token prompts only; "
            f"the reference skips its engine demo for it too")
    dev = resolve_device(device)
    cfg = C.at_depth(base, depth)
    model = cfg.to_ir()
    card = card_text(dev)
    reqs = make_requests(cfg.vocab_size, case["requests"], case["ctx"],
                         case["gen"], seed)
    ctx = round(statistics.mean(len(r["prompt"]) for r in reqs)
                + case["gen"] / 2)
    log(f"fig6 [{cfg.name} {cfg.dtype}, {cfg.block_repeat} of "
        f"{base.block_repeat} blocks, on {card}]: {len(reqs)} chat "
        f"requests at t=0, prompts {[len(r['prompt']) for r in reqs]}, "
        f"{case['gen']} tokens each, caps {list(caps)}; the simulator "
        f"prices the same {cfg.block_repeat} blocks (the cut is priced, "
        f"not scaled)")

    eng = engine_runs(cfg, reqs, caps, case["max_len"], ctx, dev, seed)
    actual = eng["reports"]
    measured = TorchMeasuredBackend("wall", device=dev, repeats=REPEATS)
    backends = {"wall": measured, "device": measured.sibling("device"),
                "analytic": AnalyticBackend(h100_node(1))}
    predicted = {name: predictions(model, b, reqs, caps,
                                   None if name == "analytic" else x_max)
                 for name, b in backends.items()}
    if not all(rep.feasible for p in predicted.values()
               for rep in p.values()):
        raise ValueError(f"fig6 {cfg.name}: the simulator finds "
                         f"{cfg.block_repeat} blocks infeasible on one H100; "
                         f"cut the model with depth")

    ref = max(caps)
    rows = []
    for cap in caps:
        act = actual[cap]
        steps = eng["steps"][cap]
        row = dict(cap=cap, actual_s=act.total_time,
                   actual_ratio=act.total_time / actual[ref].total_time,
                   engine_iterations=act.iterations, engine_steps=steps)
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
            f"({steps} engine steps: {act.iterations} iterations + "
            f"{steps - act.iterations} prompt-replay steps, "
            f"{act.total_time / steps * 1e3:.3f} ms/step) | "
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

    sim_step = {name: simulated_step(model, b, ref, ctx,
                                     None if name == "analytic" else x_max)
                for name, b in backends.items()}
    lines = departures(cfg, model, reqs, eng["param_bytes"], eng["steps"],
                       actual)
    if cfg.ffn_kind == "moe":
        lines.append(expert_departure(cfg, ref, sim_step, eng["step"]))
    for line in lines:
        log(f"fig6 departure {line}")
    log(f"fig6 step {step_line(ref, ctx, eng['step'], sim_step)}")

    samples = check_samples(measured, dev.type == "cuda")
    table = op_table(measured)
    for r in table:
        log(f"fig6 op table {r['op']} {r['axes']} x {r['x']}: wall "
            f"{r['wall_s'] * 1e3:.4f} ms, device {r['device_s'] * 1e3:.4f} "
            f"ms, analytic {r['analytic_s'] * 1e3:.4f} ms | measured / "
            f"analytic: wall {r['wall_s'] / r['analytic_s']:.2f}, device "
            f"{r['device_s'] / r['analytic_s']:.2f}")
    log(f"fig6 checks: {samples} op-table samples finite"
        + (" and at or above their bound" if dev.type == "cuda" else "")
        + "; engine launches " + ", ".join(
            f"{k} {v}" for k, v in eng["launched"].items())
        + f" in {sum(eng['steps'].values())} steps")
    return dict(arch=arch, size=size, depth=cfg.block_repeat, card=card,
                rows=rows, mean_err=mean_err, latency=latency,
                departures=lines, step=dict(engine=eng["step"],
                                            simulator=sim_step),
                launched=eng["launched"], samples=samples, op_table=table)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH, choices=sorted(C.ALIASES))
    ap.add_argument("--size", default="full", choices=sorted(CASES))
    ap.add_argument("--depth", type=int, default=None,
                    help="blocks the engine serves and the simulator "
                         "prices (default: the arch's case)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    run(args.size, args.device, seed=args.seed, arch=args.arch,
        depth=args.depth)


if __name__ == "__main__":
    main()
