"""Multi-pod dry-run (``repro/launch/dryrun.py``): trace every (architecture
x input-shape x mesh) cell on a fake process group and record per-rank
FLOPs, collective traffic and memory.

The reference lowers and compiles each cell for 256 (512) host devices.
The port runs it: ``main`` starts a fake process group of ``prod(mesh)``
ranks (``torch.testing._internal.distributed.fake_pg``: collectives
return at once and move nothing), as the reference sets ``XLA_FLAGS``
before importing JAX, and ``lower_cell`` runs one step of the cell on
rank 0 with parameters, optimiser state, batch and cache as meta
DTensors, placed by ``parallel.sharding``'s rules.  Meta tensors hold no
data: every kernel wrapper takes its plain version on them, and
``launch.op_counts`` counts the rank's local operations.  A sharding
mismatch or an unsupported layout fails the cell.  Importing this module
touches no process group.

Usage (without a card ``--device-bytes`` is required: the memory each
rank has, against which ``fits`` is judged):
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen2-0.5b --shape decode_32k --device-bytes 80e9
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch import configs as C
from repro_torch.convert import map_tree
from repro_torch.launch import op_counts
from repro_torch.launch.mesh import make_production_mesh, mesh_context
from repro_torch.launch.shapes import SHAPES, ShapeCell, input_specs
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.layers.hints import axis_sizes, data_axes
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (cache_pspecs, distribute_params,
                                           param_pspecs, spec_to_placements)
from repro_torch.training.optimizer import adamw_init

# fp8 KV-cache overrides: cells whose bf16 KV cache cannot fit the pod
CACHE_DTYPE_OVERRIDES = {
    ("qwen1_5_32b", "decode_32k"): torch.float8_e4m3fn,
}

# q-head counts that don't divide the 16-wide model axis train without
# microbatching so the batch itself can reshard over ("data","model")
# around attention (see parallel/sharding.py head-alignment note).
_MB1_ARCHS = {"qwen2_0_5b", "qwen1_5_32b", "qwen2_vl_7b"}


def _norm(arch: str) -> str:
    return C.ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")


def _analytic_workspace(cfg: ModelConfig, cell, mesh,
                        microbatches: int) -> float:
    """Per-device activation-workspace estimate (bytes) from the config +
    sharding layout.  Conservative (x2 live-set factor); validated against
    cells free of CPU dtype-normalization artifacts."""
    shape = axis_sizes(mesh)
    m = shape.get("model", 1)
    n_data = 1
    for a in ("pod", "data"):
        n_data *= shape.get(a, 1)
    B, S = cell.global_batch, cell.seq_len
    d = cfg.d_model
    dt = 2.0                                     # bf16
    v_loc = -(-cfg.vocab_size // m)
    hq = cfg.n_heads
    hd = cfg.resolved_head_dim

    def ceil_div(a, b):
        return -(-a // b)

    if cell.kind == "train":
        b_loc = ceil_div(ceil_div(B, microbatches), n_data)
        toks = b_loc * S
        ws = 16 * toks * d * dt                  # one live layer fwd+bwd
        ws += 2 * b_loc * 512 * v_loc * 4        # loss chunk logits (f32)
        if cfg.ffn_kind == "moe":
            # EP-sharded: e_loc experts at full width; else one expert at
            # a time with the d_ff dim TP-sharded (layers/moe.py layouts)
            if cfg.n_routed % m == 0:
                ws += 3 * ceil_div(cfg.n_routed, m) * toks \
                    * cfg.d_ff_expert * dt
            else:
                ws += 3 * toks * ceil_div(cfg.d_ff_expert, m) * dt
        elif cfg.d_ff:
            ws += 3 * toks * ceil_div(cfg.d_ff, m) * dt
        if any(s.kind == "ssm" for s in cfg.block_pattern):
            q = 128
            nC = ceil_div(S, q)
            ws += nC * b_loc * cfg.n_ssd_heads * \
                (cfg.d_inner // max(cfg.n_ssd_heads, 1)) * cfg.d_state * 4
        ws += 2 * b_loc * hq * 512 * 1024 * 4    # attention tiles (f32)
        return 2.0 * ws
    if cell.kind == "prefill":
        b_loc = ceil_div(B, n_data)
        toks = b_loc * S
        ws = 8 * toks * d * dt
        ws += 2 * b_loc * hq * 512 * 1024 * 4
        if cfg.ffn_kind == "moe":
            if cfg.n_routed % m == 0:
                ws += 3 * ceil_div(cfg.n_routed, m) * toks \
                    * cfg.d_ff_expert * dt
            else:
                ws += 3 * toks * ceil_div(cfg.d_ff_expert, m) * dt
        return 2.0 * ws
    # decode: per-layer KV repeat + scores + head logits
    b_loc = ceil_div(B, n_data)
    s_loc = S // m if S % m == 0 else S
    ws = 2 * b_loc * s_loc * hq * hd * dt        # kr/vr transient
    ws += b_loc * hq * s_loc * 4                 # scores f32
    ws += b_loc * v_loc * 4                      # logits
    ws += 8 * b_loc * d * dt * 64
    return 2.0 * ws


def _local_bytes(tree) -> int:
    """Bytes of one rank's shards of every tensor of a tree (a DTensor's
    local tensor; a plain tensor whole)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    return sum(_local_bytes(x) for x in tree)


def _distribute(tree, spec_tree, mesh):
    from torch.distributed.tensor import distribute_tensor
    return map_tree(lambda x, s: distribute_tensor(
        x, mesh, spec_to_placements(s, mesh)), tree, spec_tree)


def _batch_specs(specs: dict, dax) -> dict:
    """The leading batch dim of every input over the data axes."""
    return {k: (dax,) + (None,) * (x.dim() - 1) for k, x in specs.items()}


def _prefill_fn(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_fn(p, batch):
        head = p.embed.T if cfg.tie_embeddings else p.head
        if cfg.encoder is not None:
            memory = ED.encode(p, cfg, batch["frames"])
            hidden = T.forward(p, cfg, batch["tokens"], enc_memory=memory,
                               return_hidden=True)
        elif cfg.embeds_input:
            hidden = T.forward(p, cfg, embeds=batch["embeds"],
                               return_hidden=True)
        else:
            hidden = T.forward(p, cfg, batch["tokens"], return_hidden=True)
        # serving prefill emits logits for the LAST position only
        return hidden[:, -1, :] @ head
    return prefill_fn


def card_bytes() -> Optional[int]:
    """Memory of CUDA card 0, or None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


def lower_cell(arch: str, shape_name: str, mesh, *, microbatches: int = 4,
               cfg_override: Optional[ModelConfig] = None,
               cell: Optional[ShapeCell] = None,
               device_bytes: Optional[float] = None) -> dict:
    """Trace one (arch x shape) cell on ``mesh`` (a ``DeviceMesh`` over
    the current process group, which may be a fake one) and count rank
    0's share.

    ``cfg_override``: a substitute config (a REDUCED one, a head-padded
    deployment); ``cell``: a substitute ``ShapeCell`` for ``shape_name``
    (tests run small ones).  ``device_bytes``: the memory ``fits`` is
    judged against, default the card's; without a card it is required."""
    if device_bytes is None:
        device_bytes = card_bytes()
        if device_bytes is None:
            raise ValueError("no CUDA card: pass device_bytes "
                             "(--device-bytes)")
    cfg = cfg_override or C.get_config(arch)
    cell = cell or SHAPES[shape_name]
    if _norm(arch) in _MB1_ARCHS and cfg_override is None:
        microbatches = 1
    cache_dtype = CACHE_DTYPE_OVERRIDES.get((_norm(arch), shape_name))
    specs = input_specs(cfg, cell, cache_dtype=cache_dtype)
    init = ED.init_encdec_params if cfg.encoder is not None \
        else T.init_params
    params = init(None, cfg, device="meta")
    daxes = data_axes(mesh)
    dax = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)

    with mesh_context(mesh):
        t0 = time.perf_counter()
        if cell.kind == "train":
            distribute_params(params, param_pspecs(params, cfg, mesh,
                                                   fsdp=True), mesh)
            opt = adamw_init(params)
            batch = _distribute(specs, _batch_specs(specs, dax), mesh)
            step_fn = make_train_step(cfg, microbatches=microbatches,
                                      remat=True)
            args = (params, opt, batch)
            _, counts = op_counts.count(step_fn, *args)
        elif cell.kind == "prefill":
            distribute_params(params, param_pspecs(params, cfg, mesh),
                              mesh)
            batch = _distribute(specs, _batch_specs(specs, dax), mesh)
            args = (params, batch)
            _, counts = op_counts.count(_prefill_fn(cfg), *args)
        else:  # decode
            distribute_params(params, param_pspecs(params, cfg, mesh),
                              mesh)
            cache = _distribute(specs["cache"],
                                cache_pspecs(specs["cache"], cfg, mesh),
                                mesh)
            n_data = math.prod(axis_sizes(mesh)[a] for a in daxes)
            bdax = dax if specs["tokens"].shape[0] % n_data == 0 else None
            tokens = _distribute(specs["tokens"], (bdax, None), mesh)
            args = (params, tokens, cache)
            _, counts = op_counts.count(make_serve_step(cfg), *args)
        trace_s = time.perf_counter() - t0

    # jit drops the arguments a computation never reads from XLA's
    # argument size: a decode step reads neither the encoder nor the
    # cross-attention's K/V projections (the cross K/V are in the cache)
    unread = ("encoder.", "xattn.wk", "xattn.wv")
    read = {n: p for n, p in params.named_parameters()
            if not (cell.kind == "decode"
                    and any(u in n for u in unread))}
    arg_bytes = _local_bytes([read] + list(args[1:]))
    ws = _analytic_workspace(cfg, cell, mesh, microbatches)
    per_dev = arg_bytes + ws
    sizes = axis_sizes(mesh)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in sizes.values()),
        "devices": math.prod(sizes.values()),
        "kind": cell.kind,
        "trace_s": round(trace_s, 2),
        "dot_flops": counts["dot_flops"],
        "collective_bytes": counts["collective_bytes"],
        "argument_bytes": arg_bytes,
        "workspace_model": ws,
        "per_device_bytes": per_dev,
        "device_bytes": device_bytes,
        "fits": bool(per_dev <= device_bytes),
        "status": "ok",
    }


def init_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0:
    its collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="single arch id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="single shape id (default: all applicable)")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--device-bytes", type=float, default=None,
                    help="memory of one rank in bytes (default: the "
                         "card's; required without a card)")
    args = ap.parse_args(argv)
    device_bytes = args.device_bytes or card_bytes()
    if device_bytes is None:
        ap.error("no CUDA card is visible: pass --device-bytes")

    pods = {"off": [False], "on": [True], "both": [False, True]}
    multi = pods[args.multi_pod]
    init_fake_group(512 if any(multi) else 256)
    meshes = [make_production_mesh(multi_pod=mp, device="cpu")
              for mp in multi]
    archs = [args.arch] if args.arch else list(C.ARCHS)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "ok"}
    failed = []
    for mesh in meshes:
        mesh_name = "x".join(str(s) for s in mesh.shape)
        for arch in archs:
            skips = C.shape_skips(arch)
            shapes = [args.shape] if args.shape else list(SHAPES)
            for shape in shapes:
                if shape in skips:
                    print(f"SKIP {arch} x {shape}: {skips[shape]}")
                    continue
                if (arch, shape, mesh_name) in done:
                    print(f"done {arch} x {shape} x {mesh_name} (cached)")
                    continue
                print(f"=== {arch} x {shape} x mesh {mesh_name} ===",
                      flush=True)
                try:
                    rec = lower_cell(arch, shape, mesh,
                                     microbatches=args.microbatches,
                                     device_bytes=device_bytes)
                    cb = sum(rec["collective_bytes"].values())
                    print(f"  ok: trace {rec['trace_s']}s dot_flops "
                          f"{rec['dot_flops']:.3e} coll {cb / 1e9:.2f}GB "
                          f"per-dev {rec['per_device_bytes'] / 1e9:.2f}GB "
                          f"fits={rec['fits']}", flush=True)
                except Exception as e:  # noqa: BLE001 -- record, go on
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": f"error: {type(e).__name__}: {e}"}
                    failed.append((arch, shape, mesh_name))
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"])
                           != (arch, shape, mesh_name)]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{ok}/{len(results)} cells ok -> {args.out}")
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
