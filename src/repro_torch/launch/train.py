"""Training entry point of the port: a runnable loop with checkpoints and
crash-resume (``repro/launch/train.py``).

Data pipeline -> microbatched AdamW step (through the flash-attention
or SSD-scan kernel and the RMSNorm kernel on a card) -> atomic
checkpoints -> resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --full --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
        --full --steps 5 --seq 1024 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-12b \\
        --full --depth 1 --steps 5 --seq 2048 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-7b \\
        --full --depth 4 --steps 5 --seq 1024 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-large-v2 --full --steps 5 --seq 1024 \\
        --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
        --full --depth 2 --steps 5 --seq 1024 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --full --depth 2 --steps 5 \\
        --seq 1024 --microbatches 2

``--depth`` keeps that many blocks at full width: gemma3-12b trains one
block (six layers) on one H100, as its 48 layers' AdamW state alone
passes 80 GB; qwen2-vl-7b trains 4 of its 28 layers; zamba2-7b 2 of its
13 repeats (12 Mamba2 layers, and the shared block applied twice, so
its gradient sums over both); deepseek-v2-lite-16b 2 of 27 layers, the
dense prefix layer and one MoE layer (the depth counts the prefix
blocks and must exceed their number).  The stub-frontend
archs take inputs the token pipeline does not make: qwen2-vl-7b's patch
embeddings and seamless-m4t-large-v2's frame embeddings, (B, seq,
d_model), are drawn anew each step (``stub_inputs``), as the reference
draws them.

Without ``--device cpu`` it needs a CUDA card; ``--device cpu`` runs the
plain PyTorch versions of the kernels (sensible with the reduced configs).
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import configs as C
from repro_torch.convert import (from_jax_layout, load_jax_layout,
                                 to_jax_layout)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamWState, adamw_init


def train_state(params: T.Transformer, opt: AdamWState) -> tuple:
    """``(params, opt)`` in the reference's layout, as its trainer saves
    them, so a checkpoint of it reads back in either package."""
    return (to_jax_layout(dict(params.named_parameters())),
            AdamWState(to_jax_layout(opt.master), to_jax_layout(opt.m),
                       to_jax_layout(opt.v), opt.step))


@torch.no_grad()
def load_train_state(params: T.Transformer, opt: AdamWState,
                     state: tuple) -> AdamWState:
    """Copy a restored ``train_state`` into ``params`` and ``opt`` in
    place; returns the optimizer state at the restored step."""
    tree, saved = state
    load_jax_layout(params, tree)
    for mine, theirs in ((opt.master, saved.master), (opt.m, saved.m),
                         (opt.v, saved.v)):
        for name, t in from_jax_layout(theirs, mine).items():
            mine[name].copy_(t)
    return opt._replace(step=saved.step.to(torch.int32))


def stub_inputs(cfg: ModelConfig, batch: int, seq: int, step: int,
                seed: int, device) -> dict:
    """A stub frontend's inputs for train step ``step``: ``frames`` for an
    encoder-decoder, ``embeds`` for an arch fed embeddings, each (batch,
    seq, d_model) fp32 N(0, 1) from a generator seeded by ``(seed,
    step)``, so a resumed run draws what an unbroken one does; ``{}``
    for other archs."""
    name = ("frames" if cfg.encoder is not None
            else "embeds" if cfg.embeds_input else None)
    if name is None:
        return {}
    gen = torch.Generator(device=device).manual_seed((seed << 32) + step)
    return {name: torch.randn(batch, seq, cfg.d_model, generator=gen,
                              device=device)}


def train(arch: str = "internlm2-1.8b", steps: int = 20, batch: int = 8,
          seq: int = 64, microbatches: int = 1,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
          reduced: bool = True, seed: int = 0, device=None, log=print,
          history: Optional[List[dict]] = None,
          depth: Optional[int] = None):
    """Train ``arch`` for ``steps`` steps from random weights drawn from
    ``seed``, resuming from the newest checkpoint in ``ckpt_dir``;
    ``depth`` cuts the model to that many blocks (``configs.at_depth``).
    Returns ``(params, opt, losses)``.  Each step's ``{"step", "loss",
    "grad_norm", "seconds"}`` is appended to ``history`` when given; the
    seconds are read after ``torch.cuda.synchronize()`` on a card.
    An encoder-decoder arch trains on ``{"frames", "tokens", "labels"}``,
    an arch fed embeddings on ``{"embeds", "labels"}`` (``stub_inputs``)."""
    cfg = C.get_reduced(arch) if reduced else C.get_config(arch)
    dev = resolve_device(device)
    cfg = C.at_depth(cfg, depth)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.encoder is not None:
        params = ED.init_encdec_params(gen, cfg, device=dev)
    else:
        params = T.init_params(gen, cfg, device=dev)
    opt = adamw_init(params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=seed)
    step_fn = make_train_step(cfg, microbatches=microbatches, remat=True)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and mgr.list_checkpoints():
        start_step, state, _ = mgr.restore(train_state(params, opt))
        opt = load_train_state(params, opt, state)
        log(f"resumed from step {start_step}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses = []
    for step in range(start_step, steps):
        data = pipe.global_batch_at(step)
        batch_in = {k: t.to(dev) for k, t in data.items()}
        batch_in.update(stub_inputs(cfg, batch, seq, step, seed, dev))
        sync()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch_in)
        sync()
        secs = time.perf_counter() - t0
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        losses.append(loss)
        if history is not None:
            history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                            "seconds": secs})
        log(f"step {step}: loss {loss:.4f} gnorm {gnorm:.3f} "
            f"[{secs:.2f}s]")
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, train_state(params, opt))
    if mgr:
        mgr.save(steps, train_state(params, opt))
    return params, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=sorted(C.ALIASES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="full (published) config instead of reduced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card)")
    ap.add_argument("--depth", type=int, default=None,
                    help="blocks kept (default: all)")
    args = ap.parse_args(argv)
    train(args.arch, args.steps, args.batch, args.seq, args.microbatches,
          args.ckpt_dir, reduced=not args.full, seed=args.seed,
          device=args.device, depth=args.depth)


if __name__ == "__main__":
    main()
