#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # the smoke
    python3 chip_smoke.py --limits   # readings behind LOGIT_TOL for mixtral
    python3 chip_smoke.py --limits gemma3-12b   # and for gemma3-12b
    python3 chip_smoke.py --limits deepseek-v2-lite-16b   # and deepseek
    python3 chip_smoke.py --limits qwen2-vl-7b   # and the two
    python3 chip_smoke.py --limits seamless-m4t-large-v2   # stub frontends
    python3 chip_smoke.py --limits zamba2-7b   # and zamba2
    python3 chip_smoke.py --limits parallel    # the parallel phase's bf16

``--limits`` with gemma3-12b, seamless-m4t-large-v2, qwen2-vl-7b or
zamba2-7b also prints, for each bf16 run at the whole depth, its fp32
anchor's readings behind ANCHOR_RATIO (and zamba2-7b's bf16 train
parity steps theirs, behind ZAMBA_UNHELD).

Phases, one line each (the kernels phases print one line per case):

  1. probe   -- nvidia-smi name and power limit, torch, CUDA and nvcc
               versions.
  2. build   -- seconds to build the kernels' shared library from
               ``src/repro_torch/kernels/csrc`` (plus ptxas register use
               and spills), and the library's SASS (``cuobjdump -sass``):
               the 5 instances of the bf16 flash kernel (D 16 to 256) and
               the 8 of the bf16 SSD-scan kernel must each issue HGMMA
               (Hopper's wgmma), or the run fails.
  3. kernels -- the RMSNorm and decode-attention kernels against their
               plain PyTorch versions on the card, fp32 and bf16, at the
               main paths' shapes (RMSNorm beside ``F.rms_norm``, with the
               kernel its wrapper picks) and an untimed RMSNorm sweep of
               widths and alignments over both of its kernels; for decode
               attention a long cache (qwen2-0.5b heads at Smax 32768,
               and gemma3-12b heads (D 256) at Smax 32768, lengths 1 /
               4096 / 16384 / 32768, read cold), an untimed sweep of
               groups 1-8 at head dims 64 / 128 / 256 (group 1 at 512)
               and lengths on, one
               past and between span boundaries, and the head dims the
               wrapper zero-pads (8, 16, 24, 32, 112, 200): max error against
               tolerance, kernel / plain / library ms, and the launch
               grid the wrapper reports.
  4. model   -- qwen2-0.5b at FULL width and depth: ``decode_step``
               through the kernels and through the plain versions on the
               same seeded weights and cache; logits compared, launches
               counted per step.
  5. serve   -- the port's search-then-serve entry point
               (``launch.serve.plan_and_serve``): APEX's plan search for
               qwen2-0.5b FULL on ``h100x8`` on the port's simulator
               (analytic tables; the baseline and best plan labels, their
               end-to-end seconds, the plans priced and the search's
               seconds; at least one plan priced and a finite best time
               above 0), then ``ServingEngine`` on qwen2-0.5b FULL in
               bf16 serves 8 chat-trace requests; every request must
               finish with its token count, and every decode step must
               have launched both decode kernels.
     reduced -- qwen2-0.5b REDUCED (head dim 8, which both attention
               wrappers zero-pad) and mixtral-8x7b REDUCED (head dim 16,
               window 16: rings of 32 slots, which the served prompts
               wrap): ``decode_step`` logits kernels vs plain, 8 requests
               served in bf16 as in phase 5, and one train step kernels
               vs plain (fp32 and bf16) held to TRAIN_TOL; deepseek
               REDUCED (MLA, q/k 24 and v 16 padded to 64): logits and
               serve.
     profile -- the port's op profiler (``repro_torch.core.profiles``,
               which times the tables of the simulator's measured
               backends) over every (op, axes) table the simulator prices
               qwen2-0.5b FULL with, at x = 1, 2, 4 ... 4096: the GEMMs
               (n, k) (1152, 896), (896, 896), (9728, 896), (896, 4864)
               and the LM head (151936, 896); decode attention (2, 64);
               prefill attention (14, 64); mamba2-2.7b's SSD scan
               (5120, 128) and deepseek-v2-lite-16b's MLA decode (16,
               512, on the decode kernel's D 512 instance) at x 128, 1024
               and 4096.  One line per table: wall and device ms of each
               sample beside the bound of the work the simulator charges
               it.  Fails on a time that is not finite or below its
               bound, or unless the decode, flash and SSD kernels
               launched exactly once per profiled call.  Then the same
               for every other table the simulator prices the engine's
               other archs with at FULL (``arch_tables``: internlm2,
               qwen1.5-32b, mixtral's expert and router GEMMs and its
               attention (8, 128) / (32, 128), gemma3's D 256, deepseek's
               MLA projections, experts and prefill (16, 192), mamba2,
               zamba2's SSD scan (7168, 64) and shared block) at x = 1,
               16, 256 and 4096, each table once, with its own launch
               count.  Then those three kernels against their plain
               versions at the profile's largest shapes (decode also at
               (16, 512)) and at the largest shapes of the other archs'
               tables.
     predict -- the serve phase's engine run as the port's
               ``PlanSimulator`` predicts it on ``h100_node(1)`` at its 4
               slots (``launch.fig6.predictions``), on the profile phase's
               tables (wall and device clock, nothing timed again) and on
               the analytic tables: total, TTFT and TPOT means beside the
               engine's.  Printed, not held.
  plan-modes -- the simulator's search modes on the H100's own op tables:
               qwen2-0.5b FULL on ``h100_node(2)``, priced by a
               ``TorchMeasuredBackend`` on the device clock seeded with the
               profile phase's samples (x up to 4096), over
               ``launch.serve``'s search trace (chat, 0.5 req/s, 64
               requests), in this process (``jobs=1``): the joint
               colocated + disaggregated search (plans of each family,
               the best plan, the best disaggregated plan and its
               objective), ``MultiFidelitySearch`` on the same trace (its
               rungs, frontier and winner, and whether the winner is the
               exact search's) and ``search(dynamic=...)`` over two
               switching timetables on chat at 30 then 60 req/s (each
               timetable's goodput, and whether one won).  At TP 2 the
               ops take keys the profile phase did not sample (decode
               attention (1, 64), prefill (7, 64), the sharded GEMMs):
               one line per table of those samples, timed here, each held
               to its bound; the decode and flash kernels must launch once
               per profiled call.  Fails on a best plan that is
               infeasible or not finite, or a search that raises.  Then
               both kernels against their plain versions at the new
               tables' largest shapes (decode (1, 1, 1, 64, 4096), flash
               causal S 90 x 7 heads x D 64) and the phase's seconds.
  6. flash   -- the flash-attention kernel's ``out`` and ``lse`` against
               ``flash_attention_plain`` on the card, fp32 and bf16: the
               training shape of qwen2-0.5b, internlm2-1.8b's heads, a
               ragged length, a sliding window, a prefix offset,
               gemma3-12b's training shape at D 256 (window 1024 and
               global), an untimed sweep of head dims (16 to 256) and
               groups and one of the head dims the wrapper zero-pads (8,
               24, 112, 200); per timed case the
               max errors against tolerance, kernel / plain / SDPA /
               bound ms, and the launch grid the wrapper reports.
  7. train   -- ``launch.train.train`` trains qwen2-0.5b FULL in bf16 for
               5 steps (global batch 8 x 1024 tokens, 2 microbatches,
               remat) through the port's training entry point: loss and
               grad norm per step, ms per step, tokens/s and peak memory;
               every loss and norm finite, and exactly the flash and
               RMSNorm launches the step implies.  Then train parity: one
               step from the same weights and batch through the kernels
               and through the plain versions, fp32 and bf16, comparing
               loss, grad norm and the updated fp32 masters; and a
               profiled bf16 step.
  8. ssd     -- the SSD-scan kernels against ``ssd_scan_plain`` on the
               card, fp32 and bf16, at mamba2-2.7b's training shape (x
               4 x 1024 x 80 x 64, N 128, chunk 128; kernel / plain /
               bound ms; in bf16 the tensor-core kernel the wrapper picks
               and the CUDA-core kernel timed in turns in the same call)
               and over an untimed sweep of head dim, state dim, length
               and chunk that runs every case on each kernel that takes
               it; once in fp32 against the sequential recurrence
               ``ssd_scan_sequential``.
  9. mamba2  -- ``launch.train.train`` trains mamba2-2.7b FULL (64
               layers, d_model 2560) in bf16 for 5 steps (global batch 8
               x 1024 tokens, 2 microbatches, remat) after the qwen2-0.5b
               phases' memory is freed: loss and grad norm per step, ms
               per step, tokens/s and peak memory; every loss and norm
               finite, and exactly 256 SSD scans (all on the tensor-core
               kernel) and 514 RMSNorms per step.  Then train parity at
               full width and depth 8 (two fp32 copies of 2.7B
               parameters and their optimizer state do not fit the
               card): one step through the kernels and
               one through the plain versions, fp32 and bf16; and a
               profiled bf16 step at that depth.
 10. mixtral -- mixtral-8x7b (MoE, 8 experts top-2, sliding window 4096)
               at full width on seeded random weights: ``decode_step``
               logits kernels vs plain in bf16 at depth 16 of 32 (47 GB)
               and fp32 at depth 4, the kernel run taking the plain run's
               MoE routes, held to LOGIT_TOL and ARGMAX_FLOOR, with the
               share of routes the kernel run would have picked alike; a
               profiled bf16 step (device ms by family beside the 14 ms
               it takes to read the weights once); 4 chat requests
               (prompts cut to 32, outputs to 16) served at depth 16 as
               in phase 5; and a ring check at depth 2,
               ``max_len`` 4608 (rings of 4112 slots), lengths 100 / 4111
               / 4112 / 9000, one step kernels vs plain in fp32 and bf16.
 11. ssm-serve -- ``ServingEngine`` serves mamba2-2.7b FULL (64 layers):
               4 chat requests, prompts cut to 32, outputs to 8, 4 slots,
               the last request admitted into a reused slot; in bf16
               every request finishes with its token count and every step
               launches its RMSNorms; in fp32 each prefilled slot's SSM
               state and conv windows equal a batch-1 ``prefill`` of the
               prompt within SSM_STATE_TOL, and the other active slots'
               are unchanged.
 12. gemma3  -- gemma3-12b (blocks of five sliding-window layers, window
               1024, and one global layer; head dim 256) at full width on
               seeded random weights: ``decode_step`` logits kernels vs
               plain in fp32 at 2 blocks and bf16 at 4 (24 layers), held
               to LOGIT_TOL and ARGMAX_FLOOR, and in bf16 at all 48
               layers, held to ARGMAX_FLOOR and, against its fp32 anchor,
               to ANCHOR_RATIO (LOGIT_TOL does not hold there: PERF.md);
               a profiled bf16 step beside
               the 7.02 ms it takes to read the 23.5 GB of weights once;
               a ring check at one block (rings of 1040 slots beside a
               global cache of 4096, lengths 100 / 1039 / 1040 / 3000);
               4 chat requests (prompts cut to 32, outputs to 16) served
               at all 48 layers (rings of 1040, global caches of 2048)
               with 97 RMSNorms and 48 decode
               attentions a step; one block trained for 5 steps (8 x
               2048 tokens, 2 microbatches, remat nested per layer) with
               exactly the flash and RMSNorm launches that implies, and
               one step kernels vs plain held to TRAIN_TOL.
 13. deepseek -- deepseek-v2-lite-16b (MLA over latent caches, q/k 192
               and v 128 wide; a dense first layer, then 26 MoE layers of
               64 experts, top-6, 2 shared) at full width on seeded random
               weights: decode attention and flash at MLA's head dims
               (the wrappers pad v to the width of q and k) against the
               plain versions, decode at the serve shape timed with the
               padding copies apart; ``decode_step`` logits kernels vs
               plain in fp32 at 4 layers and bf16 at all 27, held to
               LOGIT_TOL and ARGMAX_FLOOR (MoE routes replayed); a
               profiled bf16 step (device ms by family, the MoE FFNs'
               products and the padding copies apart, beside the weights'
               read-once bound); ``forward`` in bf16 at 2 layers, B 2 x S
               256, kernels vs plain; 4 chat requests (prompts cut to 16,
               outputs to 8) served at all 27 layers in 4 slots of 512,
               with 55 RMSNorms and 27 decode attentions a step, all on
               the D 256, group 1 instance.
  14. qwen2-vl -- qwen2-vl-7b (M-RoPE, fed patch embeddings) at full
               width: logits kernels vs plain through an embeddings
               prefill and decode steps, fp32 at 4 layers and bf16 at all
               28 (also against its fp32 anchor, held to ANCHOR_RATIO),
               with 57 RMSNorms and 28 decode attentions a step on
               the D 128, group 7 instance; ``forward`` at (t, h, w) ids
               through the flash kernel at 2 layers; 4 layers trained 5
               steps and one step kernels vs plain.
  15. seamless -- seamless-m4t-large-v2 at full width and all 24 + 24
               layers: 4 requests of 1024 frames encoded through the
               flash kernel without the causal mask (24 launches, 49
               RMSNorms), then 16 greedy decode steps with self- and
               cross-attention through the decode kernel (48 a step, 73
               RMSNorms), logits kernels vs plain in fp32 and bf16 (bf16
               also against its fp32 anchor, held to ANCHOR_RATIO); 5
               train steps on the frames batch and one step kernels vs
               plain.
 16. zamba2  -- zamba2-7b (78 Mamba2 layers with SSD head dim 112, and
               one shared attention + MLP block applied after every six,
               head dim 112) at full width: logits kernels vs plain, fp32
               at 2 repeats and bf16 at all 13 (also against its fp32
               anchor, held to ANCHOR_RATIO; 183 RMSNorms and 13
               decode attentions a step on the (128, 1) instance), a
               profiled bf16 step; ``forward`` at 2 repeats through the
               SSD kernel at P 112 (two panels of 64) and the flash
               kernel at D 112; 4 chat requests served at all 13 repeats
               as in phase 11 (the fp32 run also holds the shared
               block's K/V rows); two repeats trained 5 steps (every SSD
               launch on the tensor-core kernel) and one step kernels vs
               plain.  The flash and ssd phases time zamba2's shapes
               (the wrappers' padding copies apart), the ssd phase also
               against the sequential recurrence.
 17. deepseek-train -- deepseek-v2-lite-16b trained at full width and
               depth 2 (the dense prefix layer and one MoE layer; MLA's
               flash with v padded to the width of q and k) for 5 steps,
               and one step kernels vs plain with the plain run's MoE
               routes replayed.
 18. parallel -- the parallel layer (``repro_torch.parallel``,
               ``training.compress`` and ``elastic``) at world size 1
               through NCCL, fp32 and bf16: ``moe_ep_forward`` on one
               mixtral-8x7b and one deepseek-v2-lite-16b FFN at full
               width (x 4 x 512) against the dense ``moe_forward`` at
               capacity factor 8 (no drops), its drop fraction at 1.25
               equal to the CPU's bucketing of the same routes, EP and
               dense timed; ``sp_decode_attention`` at qwen1.5-32b's
               decode heads over a 32768-slot cache against the plain
               version and the decode kernel (one decode-kernel launch,
               its log-sum-exp against the plain version's);
               ``pipeline_forward`` with
               qwen2-0.5b FULL's 24 layers as one stage over 4
               microbatches of (2, 1024) against the layers run over each
               microbatch in turn and over the whole batch (192 RMSNorm
               and 96 flash launches); qwen1.5-32b at full width and
               depth 2 with its 40 heads padded to 48
               (``pad_attention_heads``), prefill and decode logits
               against the unpadded model through the kernels, held to
               LOGIT_TOL and ARGMAX_FLOOR; a full-width gradient tree
               (494 M values) through int8 compression (error within the
               scale, unbiased over 64 draws, bytes); a world-size-1 plan
               (an 8-device plan refused) and qwen2-0.5b FULL's
               parameters through ``reshard_state`` and back, bit-exact.
               Limits: PARALLEL_FP32 and PARALLEL_BF16.
 19. fp8     -- the decode kernel's e4m3 instance (q and output bf16,
               k/v float8_e4m3fn, head dim 128) against its plain version
               on the same e4m3 bits (bf16 TOL): groups 1/5/8 at Smax
               4096 and cold at 32768, timed beside the bf16 instance on
               the exact upcast and, as context, SDPA on that upcast;
               the split grid's edges (run in the kernels phase).  Then
               ``fp8-serve``: qwen1.5-32b at full width (40 / 40 heads of
               128, group 1) and depth 8 with an e4m3 cache of batch 8 x
               Smax 32768 (21.5 GB): 4 ``decode_step``s kernels vs plain
               held to LOGIT_TOL and ARGMAX_FLOOR, every decode launch on
               the (128, 1, e4m3) instance; the step's device ms beside a
               bf16 cache's (43 GB) and the fp8-vs-bf16 logits difference
               printed, not held.
 20. dryrun  -- ``launch.dryrun.lower_cell`` for qwen2-0.5b FULL training
               (batch 8 x 2048) on a (1, 1) NCCL mesh, then that step run
               for real through the kernels as DTensors on the mesh: the
               dry-run's per-device bytes beside max_memory_allocated
               (printed), its dot FLOPs over the step's device time
               against the bf16 peak, and the step's launches equal to the
               wrapper calls of the trace.

The bf16 full-depth logits checks of gemma3-12b (48 layers),
qwen2-vl-7b (28), seamless-m4t-large-v2 (24 + 24) and zamba2-7b (13
repeats) also run once more through the plain versions in fp32 on the
same weights and cache upcast (the fp32 anchor), and hold the kernel
run's distance from it to ANCHOR_RATIO times the plain bf16 run's.

Then, each on a line of its own: the seconds by phase, the
``{"kernels": [...]}`` record (one
entry per kernel and path: ``rmsnorm/serve``, ``decode_attention/serve``,
``rmsnorm/train``, ``flash_attention/train``, ``rmsnorm/mamba2_train``,
``ssd_scan/mamba2_train``, ``decode_attention/profile``,
``flash_attention/profile``, ``ssd_scan/profile``,
``decode_attention/profile-archs``, ``flash_attention/profile-archs``,
``ssd_scan/profile-archs``, ``rmsnorm/mixtral-serve``, ``decode_attention/mixtral-serve``,
``rmsnorm/ssm-serve``, ``rmsnorm/gemma3-serve``,
``decode_attention/gemma3-serve``, ``rmsnorm/gemma3-train``,
``flash_attention/gemma3-train``, ``rmsnorm/deepseek-serve``,
``decode_attention/deepseek-serve``, ``decode_attention/profile-mla``,
``rmsnorm/qwen2-vl-7b``, ``decode_attention/qwen2-vl-7b``,
``rmsnorm/qwen2-vl-train``, ``flash_attention/qwen2-vl-train``,
``flash_attention/seamless-encode``, ``rmsnorm/seamless-serve``,
``decode_attention/seamless-serve``, ``rmsnorm/seamless-train``,
``flash_attention/seamless-train``, ``rmsnorm/zamba2-serve``,
``decode_attention/zamba2-serve``, ``rmsnorm/zamba2-train``,
``flash_attention/zamba2-train``, ``ssd_scan/zamba2-train``,
``rmsnorm/deepseek-train``, ``flash_attention/deepseek-train``,
``rmsnorm/parallel-pipeline``, ``flash_attention/parallel-pipeline``,
``rmsnorm/parallel-padding``, ``decode_attention/parallel-padding``,
``decode_attention/parallel-sp`` (SP decode's kernel call, which returns
the log-sum-exp too), ``rmsnorm/fp8-serve``,
``decode_attention/fp8-serve`` (the e4m3 instance; its library time is
none), ``rmsnorm/dryrun-train``,
``flash_attention/dryrun-train``, ``decode_attention/plan-modes``,
``flash_attention/plan-modes``, each with that path's
launches and the kernel's numbers at that path's bf16 shape), the
card's name and power limit as nvidia-smi prints them, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the last line; without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, the script exits 1 at once.

The serve, profile, predict and plan-modes phases run APEX's loop on the
port alone: the simulator is the port's copy (``repro_torch.core``), and
this script imports nothing of ``repro``.  The whole fidelity experiment
(Fig. 6 over batch-size caps) and the search-then-serve entry point run on
the card, or on the CPU with ``--device cpu``::

    PYTHONPATH=src python3 -m repro_torch.launch.fig6 --arch mixtral-8x7b --size full
    PYTHONPATH=src python3 -m repro_torch.launch.fig6 --size reduced --device cpu
    PYTHONPATH=src python3 -m repro_torch.launch.serve --arch qwen2-0.5b
    PYTHONPATH=src python3 -m repro_torch.launch.serve --size reduced --device cpu
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
# kernel vs plain version on the same inputs.  fp32: summation order
# only (tests/test_kernels.py).  bf16: both sides compute in fp32 and round
# once, so an element may differ by one rounding flip, at most one bf16
# ulp <= 2^-7 |value|; atol covers the fp32 differences under a rounding
# step near 0.  A flip is rare (an H100 read at most 4.9e-4 of bf16
# elements not bit-equal), so DIFFER_MAX also holds the share of
# elements that differ: a kernel that rounds bf16 another way stays
# within one ulp but differs in about half of them (PERF.md, PR 11).
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=1e-5)}
DIFFER_MAX = {"float32": 1.0, "bfloat16": 1e-2}
# logits after 24 layers, kernels vs plain versions on the same card:
# the largest abs difference, and the least share of rows whose argmax
# agrees.  Read on an H100 over seeds 0-5 (PERF.md, PR 11): bf16 0.141 to
# 0.172 with 22-24 of 24 argmaxes agreeing, fp32 1.8e-5 to 2.5e-5 with
# all agreeing; a decode-attention kernel that drops the last tile of
# long rows read 5.7 (17/24) and one that swaps bf16 pairs 6.9 (1/24).
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.25}
ARGMAX_FLOOR = {"float32": 0.95, "bfloat16": 0.8}
# A MoE model is held to the same limits: its kernel run takes the plain
# run's routes (``replayed_routes``), so a near-tie of router logits
# cannot send the two runs to different experts.  Read on an H100 for
# mixtral-8x7b at full width over seeds 0-5 (PERF.md; ``python3
# chip_smoke.py --limits``): fp32 (depth 4) 1.4e-5 to 2.0e-5 with every
# argmax agreeing, bf16 (depth 16) 0.164 to 0.188 with 21-24 of 24; a
# decode kernel that drops the last tile read 4.45 fp32 / 5.78 bf16
# (6/24), one that swaps pairs 7.28 / 6.94 (0/24), one that rounds
# toward zero 3.6e-2 / 0.305 (23/24).
# one train step of qwen2-0.5b FULL (batch 8 x 1024, 2 microbatches,
# remat) through the kernels vs the plain versions, from the same weights
# and batch: |loss difference|, relative grad-norm difference, and the
# L2 norm of the updated fp32 masters' difference over that of the
# update.  Read on an H100 over seeds 0-2 (PERF.md): fp32 loss 0, grad
# norm 6.9e-8 to 7.8e-8, masters 2.5e-5 to 3.0e-5; bf16 loss 2.2e-5 to
# 2.3e-4, grad norm 1.0e-4 to 2.4e-4, masters 0.037 to 0.044 (a first
# Adam update is +-lr per element, and bf16 gradients near 0 flip its
# sign).  Controls, fp32 / bf16: a flash kernel that drops the last KV
# tile read loss 8.2e-3 / 8.8e-3, grad norm 0.31, masters 0.54 / 0.54;
# one whose lse is 0.01 high (the backward only) loss 0 / 2.3e-4, grad
# norm 2.1e-2, masters 0.065 / 0.073.  In bf16 the masters limit
# catches the first control only; the grad norm catches both.
TRAIN_TOL = {"float32": dict(loss=1e-5, gnorm=1e-5, master=3e-4),
             "bfloat16": dict(loss=2e-3, gnorm=2e-3, master=0.1)}
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
# The SSD-scan kernel is held to TOL against its plain version: both take
# cum = cumsum(dt A) in the same order, so they differ by summation order
# over the chunk and the state only (an H100 read fp32 4.8e-7 at |y| ~ 20,
# bf16 1.4e-7 of elements not bit-equal; a kernel that does not decay the
# carried state read 3.8).  Against the step-by-step recurrence, fp32 is
# held to the sweep tolerance of tests/test_kernels.py: the chunked
# algorithm takes exp of differences of cum, which reaches ~1400 inside a
# chunk where one fp32 ulp is 1.2e-4 (read: 1.2e-4 at |y| ~ 20).
SEQ_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 against the recurrence: each side rounds its fp32 sum to bf16 once,
# so they may differ by one bf16 ulp beyond SEQ_TOL
SEQ_TOL_BF16 = dict(rtol=2.0 ** -7 + SEQ_TOL["rtol"], atol=SEQ_TOL["atol"])
# one train step of mamba2-2.7b at full width and depth 8 (batch 8 x
# 1024, 2 microbatches, remat) through the kernels vs the plain versions,
# as TRAIN_TOL.  Read on an H100 over seeds 0-2 (PERF.md): fp32
# loss 0, grad norm <= 1.0e-7, masters 1.1e-4 to 1.2e-4; bf16 loss 4.8e-6
# to 8.8e-5, grad norm 2.8e-5 to 1.2e-4, masters 0.067 to 0.069.  A
# kernel that does not decay the carried state read fp32 / bf16 loss
# 1.7e-4 / 1.6e-4, grad norm 1.1e-5 / 7.3e-6, masters 0.096 / 0.111: fp32
# fails every limit; in bf16 only the masters limit (1.45x the worst
# sound reading) catches it, and the kernel check catches it by 3.8.
# bf16 now runs the tensor-core SSD kernel (1.0e-4 of its outputs
# not bit-equal to the plain version's, against 1.4e-7): bf16 masters
# 0.088 to 0.090 over seeds 0-2; 0.110 with W' split into two bf16 terms
# instead of three (PERF.md).
MAMBA_TRAIN_TOL = {"float32": dict(loss=1e-5, gnorm=1e-6, master=1e-3),
                   "bfloat16": dict(loss=1e-3, gnorm=1e-3, master=0.1)}
# substrings of cuBLAS / CUTLASS matrix-product kernel names
GEMM_WORDS = ("gemm", "gemv", "cutlass", "nvjet", "xmma", "splitk")


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def say(phase: str, text: str) -> None:
    print(f"{phase}: {text}", flush=True)


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# -- 1. probe -----------------------------------------------------------------

def probe(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    nvcc = build.find_nvcc()
    nvcc_v = "not found"
    if nvcc:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        nvcc_v = out.strip().splitlines()[-1]
    say("probe", f"{smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvcc {nvcc_v} | python "
        f"{sys.version.split()[0]} | devices {torch.cuda.device_count()}")
    return smi


# -- 2. build -----------------------------------------------------------------

def build_phase() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    log = build.BUILD_DIR / "build.log"
    usage = []
    if log.exists():
        name = spill = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spill = m.group(1), None
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                usage.append((name, int(m.group(1)), spill or (0, 0)))
                name = None
    say("build", f"{secs:.1f} s for {build.BUILD_DIR / build.LIB_NAME}; "
        f"ptxas registers (and spill stores / loads, bytes): " + (" ".join(
            f"{kernel_label(n)}:{r}r" + (f"({st}/{ld}B)" if st or ld else "")
            for n, r, (st, ld) in usage) or "n/a"))
    sass_check(build)


def kernel_label(mangled: str) -> str:
    """A readable name of a mangled kernel instance, such as
    ``decode_attention_kernel<fp32, 256, 8>``: the length-prefixed name
    that ends in ``kernel`` and its template arguments (types, integers);
    the mangled name's first 40 characters where there is none."""
    at = 0
    while True:
        m = re.compile(r"\d+").search(mangled, at)
        if m is None:
            return mangled[:40]
        at = m.end() + int(m.group())
        name, rest = mangled[m.end():at], mangled[at:]
        if not (name.endswith("kernel") and rest.startswith("I")):
            continue
        rest, args = rest[1:], []
        while rest and rest[0] != "E":
            if rest.startswith("13__nv_bfloat16"):
                args.append("bf16")
                rest = rest[15:]
            elif rest.startswith("13__nv_fp8_e4m3"):
                args.append("e4m3")
                rest = rest[15:]
            elif rest[0] == "f":
                args.append("fp32")
                rest = rest[1:]
            elif rest[0] == "L" and "E" in rest:   # integer: L<type><n>E
                end = rest.index("E")
                args.append(rest[2:end].replace("n", "-"))
                rest = rest[end + 1:]
            else:
                break
        if len(args) == 4 and args[3] == args[0]:
            args.pop()          # the cache type where it is q's own
        return f"{name}<{', '.join(args)}>"


# kernels that must run on the tensor cores, with their instances in the
# library (flash: D 16/32/64/128/256; SSD: P 32/64 x N 16/32/64/128):
# every instance of each in the library's SASS holds HGMMA
WGMMA_KERNELS = {"flash_attention_wgmma_kernel": 5,
                 "ssd_scan_wgmma_kernel": 8}


def sass_check(build) -> None:
    """The bf16 flash and SSD-scan kernels must run on the tensor cores:
    each of ``WGMMA_KERNELS`` must have its count of instances in the
    built library's SASS, and every one must hold HGMMA instructions
    (wgmma as the card executes it)."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        fail(f"sass: {tool} not found")
    sass = subprocess.run([str(tool), "-sass",
                           str(build.BUILD_DIR / build.LIB_NAME)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hgmma = {k: {} for k in WGMMA_KERNELS}
    name = family = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            family = next((k for k in WGMMA_KERNELS if k in name), None)
            if family:
                hgmma[family][name] = 0
        elif family and "HGMMA" in line:
            hgmma[family][name] += 1
    for k, per in hgmma.items():
        if len(per) != WGMMA_KERNELS[k] or min(per.values()) == 0:
            fail(f"sass: {k}: {len(per)} instances (expected "
                 f"{WGMMA_KERNELS[k]}), HGMMA per instance {per}")
    say("build", "sass: " + "; ".join(
        f"{len(per)} instances of {k}, HGMMA instructions per instance "
        f"{sorted(per.values())}" for k, per in hgmma.items()))


# -- 3. kernels ---------------------------------------------------------------

def time_ms(torch, fn, inner: int = 20, reps: int = 25) -> float:
    """Device time of one call: median over ``reps`` runs of ``inner``
    back-to-back calls between two CUDA events, after warm-up.  A sleep
    kernel queued first keeps the card busy while the host enqueues the
    calls, so host launch overhead does not show in the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2.0e9 * host_s * 2.0) + 100_000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def compare(torch, got, want, dtype: str, what: str, tol=None):
    """Max abs error of ``got`` against ``want`` within ``tol`` (default
    TOL[dtype]), and the share of elements that are not bit-equal."""
    differ = float((got != want).float().mean())
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite output")
    err = (got - want).abs()
    tol = tol or TOL[dtype]
    beyond = float((err > tol["atol"] + tol["rtol"] * want.abs()).float()
                   .mean())
    if beyond > 0:
        fail(f"{what}: max abs err {float(err.max()):.3e} beyond "
             f"rtol={tol['rtol']} atol={tol['atol']} ({beyond:.2e} of "
             f"elements; {differ:.2e} not bit-equal)")
    if differ > DIFFER_MAX[dtype]:
        fail(f"{what}: {differ:.2e} of elements not bit-equal, more than "
             f"{DIFFER_MAX[dtype]}")
    return float(err.max()), differ


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rmsnorm_variant_text(rmsnorm, x, w) -> str:
    warps, vecs = rmsnorm.variant(
        x.shape[-1], x.element_size(),
        all(t.data_ptr() % 16 == 0 for t in (x, w)))
    return (f"vector kernel, {warps} warp(s) a row, {vecs} vectors a lane"
            if warps else "rows kernel")


def rmsnorm_case(torch, F, shape, dtype_name, gen, timed: bool = True,
                 offset: int = 0) -> dict:
    """One RMSNorm case; ``offset`` > 0 starts x that many elements into
    its buffer, so it is not 16-byte aligned."""
    from repro_torch.kernels import rmsnorm
    dt = getattr(torch, dtype_name)
    n = math.prod(shape)
    x = torch.randn(n + offset, generator=gen, device="cuda").to(dt)[
        offset:].view(shape)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen,
                               device="cuda")).to(dt)
    got = rmsnorm.rms_norm(x, w)
    torch.cuda.synchronize()
    kernel = rmsnorm_variant_text(rmsnorm, x, w)
    err, differ = compare(torch, got, rmsnorm.rms_norm_plain(x, w),
                          dtype_name, f"rmsnorm {shape} {dtype_name} "
                          f"({kernel})")
    if not timed:
        return dict(max_abs_err=err, differ=differ, kernel=kernel)
    ms = time_ms(torch, lambda: rmsnorm.rms_norm(x, w))
    plain_ms = time_ms(torch, lambda: rmsnorm.rms_norm_plain(x, w))
    lib = getattr(F, "rms_norm", None)
    library_ms = None if lib is None else time_ms(
        torch, lambda: lib(x, (shape[-1],), w, 1e-6))
    nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    bound_ms, bound_by = bound(nbytes, 4.0 * x.numel())
    say("kernels", f"rmsnorm {tuple(shape)} {dtype_name} ({kernel}): "
        f"max_abs_err "
        f"{err:.3e} ({tol_text(dtype_name)}), not bit-equal {differ:.2e} "
        f"| kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms library "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f}'} ms "
        f"bound {bound_ms:.5f} ms ({bound_by}, {nbytes} B)")
    return dict(max_abs_err=err, differ=differ, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def tol_text(dtype_name: str) -> str:
    return f"rtol {TOL[dtype_name]['rtol']:.3g} atol {TOL[dtype_name]['atol']}"


def attention_inputs(torch, B, Hq, Hkv, D, smax, lengths, dt, gen, dv=None):
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, smax, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, smax, Hkv, dv or D, generator=gen,
                    device="cuda").to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def in_turn(fn, arg_sets):
    """A call of ``fn`` on each of ``arg_sets`` in turn, one per call."""
    turn = itertools.count()
    return lambda: fn(*arg_sets[next(turn) % len(arg_sets)])


def attention_case(torch, F, shape, lengths, dtype_name, gen,
                   timed: bool = True, copies: int = 1, dv=None,
                   draws: int = 1) -> dict:
    """One decode-attention case; ``copies`` > 1 times the calls over that
    many caches in turn, so a cache that fits the 50 MB L2 is read cold
    as a serving step reads it.  ``dv``: v's head dim where it is not D
    (MLA); the wrapper then pads q, k and v to one width, its time
    includes those copies, and the kernel alone is timed on inputs padded
    beforehand, as it is for a head dim the wrapper pads (zamba2's 112
    to 128).  The bound counts the unpadded bytes.  ``draws`` > 1 holds
    the comparison over that many draws of the inputs at this shape,
    every element to TOL and the share not bit-equal over all of them
    (one head of D 64 has 64 outputs: one rounding flip is 1/64 of a
    draw, above DIFFER_MAX, so one draw says nothing of the share)."""
    from repro_torch.kernels import decode_attention as da
    B, Hq, Hkv, D, smax = shape
    dv = dv or D
    dt = getattr(torch, dtype_name)
    q, k, v, lens = attention_inputs(torch, B, Hq, Hkv, D, smax, lengths,
                                     dt, gen, dv)
    got = da.decode_attention(q, k, v, lens)
    outs = [(got, da.decode_attention_plain(q, k, v, lens))]
    for _ in range(draws - 1):
        more = attention_inputs(torch, B, Hq, Hkv, D, smax, lengths, dt,
                                gen, dv)
        outs.append((da.decode_attention(*more),
                     da.decode_attention_plain(*more)))
        del more
    torch.cuda.synchronize()
    what = (f"decode_attention {shape}{f' Dv {dv}' if dv != D else ''} "
            f"lengths {lengths} {dtype_name}"
            f"{f' over {draws} draws' if draws > 1 else ''}")
    err, differ = compare(torch, torch.cat([o.flatten() for o, _ in outs]),
                          torch.cat([p.flatten() for _, p in outs]),
                          dtype_name, what)
    del outs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_text = (f"grid {'x'.join(map(str, da.grid(q, k)))} blocks (span "
                 f"{da.split_plan(smax, B * Hkv, sms)[0]}) on {sms} SMs")
    if not timed:
        return dict(max_abs_err=err, differ=differ, grid=grid_text)
    kvs = [(k, v)] + [(torch.randn_like(k), torch.randn_like(v))
                      for _ in range(copies - 1)]
    ms = time_ms(torch, in_turn(
        lambda kk, vv: da.decode_attention(q, kk, vv, lens), kvs))
    plain_ms = time_ms(torch, in_turn(
        lambda kk, vv: da.decode_attention_plain(q, kk, vv, lens), kvs))
    # yardstick: SDPA on K/V repeated to Hq heads, boolean length mask
    rep = Hq // Hkv
    sdpa_kvs = [tuple(t.repeat_interleave(rep, dim=2).transpose(1, 2)
                      .contiguous() for t in pair) for pair in kvs]
    mask = (torch.arange(smax, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    library_ms = time_ms(torch, in_turn(
        lambda ks, vs: F.scaled_dot_product_attention(
            q[:, :, None, :], ks, vs, attn_mask=mask), sdpa_kvs))
    del kvs, sdpa_kvs
    alone = ""
    width = da.padded_head_dim(max(D, dv))
    if dv != D or width != D:
        qp, kp, vp = (F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))
        kernel_ms = time_ms(torch, lambda: da._launch(
            qp, kp, vp, lens, scale=1.0 / math.sqrt(D)))
        alone = (f" (q/k {D} and v {dv} padded to {width} in the wrapper; "
                 f"the kernel alone on inputs padded beforehand "
                 f"{kernel_ms:.4f} ms, so the padding copies "
                 f"{ms - kernel_ms:.4f} ms)")
        del qp, kp, vp
    es = q.element_size()
    n_kv = sum(min(max(n, 0), smax) for n in lengths)
    nbytes = (n_kv * Hkv * (D + dv) * es + q.numel() * es
              + B * Hq * dv * es + 4 * B)
    flops = n_kv * Hq * 2.0 * (D + dv)
    bound_ms, bound_by = bound(nbytes, flops)
    cold = f"; {copies} caches in turn, read cold" if copies > 1 else ""
    say("kernels", f"decode_attention q {(B, Hq, D)} k/v "
        f"{(B, smax, Hkv, D)}{f' v Dv {dv}' if dv != D else ''} lengths "
        f"{lengths} {dtype_name}: max_abs_err "
        f"{err:.3e} ({tol_text(dtype_name)}), not bit-equal {differ:.2e}"
        f"{f' over {draws} draws' if draws > 1 else ''} | kernel "
        f"{ms:.4f} ms{alone} plain {plain_ms:.4f} ms library(SDPA) "
        f"{library_ms:.4f} ms bound {bound_ms:.5f} ms ({bound_by}, "
        f"{nbytes} B{cold}) | {grid_text}")
    return dict(max_abs_err=err, differ=differ, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


# qwen2-0.5b's heads at its published context of 32768 (27 MB of bf16
# K/V at these lengths): (B, Hq, Hkv, D, Smax); and gemma3-12b's (head
# dim 256, 863 MB)
DECODE_LONG = (4, 14, 2, 64, 32768)
GEMMA_DECODE_LONG = (4, 16, 8, 256, 32768)
# mixtral-8x7b's heads in the mixtral phase's serve run: 4 slots of 512
MIXTRAL_DECODE = (4, 32, 8, 128, 512)
# gemma3-12b's serve run: 4 slots, max_len 2048, so the 40 local layers
# keep rings of ring_size(1024) = 1040 slots and the 8 global layers 2048
GEMMA_SERVE_MAX_LEN = 2048
GEMMA_DECODE = ((4, 16, 8, 256, 1040), (4, 16, 8, 256, GEMMA_SERVE_MAX_LEN))
# its RMSNorms: (4, 1, 3840) 97 times a decode step; the training
# microbatch (4 x 2048 tokens)
GEMMA_NORM_SERVE = (4, 1, 3840)
GEMMA_NORM_TRAIN = (4, 2048, 3840)
DECODE_LONG_LENGTHS = [1, 4096, 16384, 32768]
DECODE_EDGE_SMAX = 1000
# head dims the attention wrappers zero-pad (REDUCED 8, 16 and 24;
# zamba2's 112; 200, padded to 256)
PADDED_DECODE_DIMS = (8, 16, 24, 32, 112, 200)
PADDED_FLASH_DIMS = (8, 24, 112, 200)


def kernels_phase(torch, F) -> dict:
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype_name in ("float32", "bfloat16"):
        for shape in ((4, 1, 896), (512, 896), (4, 1, 2048), (512, 2048),
                      (4, 1, 5120),     # d of qwen2-0.5b, internlm2, 32b
                      (4, 1, 4096),     # mixtral-8x7b serving
                      (4, 1024, 896),   # qwen2-0.5b training microbatch
                      (4, 1, 2560),     # mamba2-2.7b serving: norm1, final
                      (4, 1024, 2560),  # mamba2-2.7b: norm1, final norm
                      (4, 1024, 5120),  # mamba2-2.7b: the gated norm
                      GEMMA_NORM_SERVE,  # gemma3-12b serving
                      GEMMA_NORM_TRAIN,  # gemma3-12b training microbatch
                      QWEN_VL_NORM_SERVE, QWEN_VL_NORM_TRAIN,  # qwen2-vl
                      SEAMLESS_NORM_SERVE,   # seamless decode steps
                      SEAMLESS_NORM_TRAIN,   # its encoder, its training
                      ZAMBA_NORM_SERVE, ZAMBA_NORM_TRAIN,  # gated norms
                      DEEPSEEK_NORM_TRAIN):  # deepseek training
            r = rmsnorm_case(torch, F, shape, dtype_name, gen)
            results[("rmsnorm", shape, dtype_name)] = r
    # both kernels: REDUCED widths (qwen2 56, mamba2 64 and 128), widths
    # that are not a multiple of the vector, every warps-per-row group,
    # and x that is not 16-byte aligned
    picked = {}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype_name in ("float32", "bfloat16"):
        for d in (56, 64, 100, 128, 1000, 2050, 4096, 8192):
            for offset in (0, 1):
                r = rmsnorm_case(torch, F, (3, 5, d), dtype_name, gen,
                                 timed=False, offset=offset)
                worst[dtype_name] = max(worst[dtype_name], r["max_abs_err"])
                picked[r["kernel"]] = picked.get(r["kernel"], 0) + 1
    say("kernels", f"rmsnorm sweep: {sum(picked.values())} cases (15 rows "
        f"of d 56/64/100/128/1000/2050/4096/8192, aligned and not, fp32 "
        f"and bf16) all within tolerance, worst max_abs_err fp32 "
        f"{worst['float32']:.3e} bf16 {worst['bfloat16']:.3e} | "
        + "; ".join(f"{k}: {n}" for k, n in sorted(picked.items())))
    lengths = [1, 77, 300, 512]          # 1, not a multiple of 32, Smax
    for dtype_name in ("float32", "bfloat16"):
        for shape in ((4, 14, 2, 64, 512),      # qwen2-0.5b, group 7
                      (4, 16, 8, 128, 512),     # internlm2-1.8b, group 2
                      MIXTRAL_DECODE,           # mixtral-8x7b, group 4
                      *GEMMA_DECODE,            # gemma3-12b, group 2
                      QWEN_VL_DECODE,           # qwen2-vl-7b, group 7
                      ZAMBA_DECODE):            # zamba2-7b, D 112 padded
            r = attention_case(torch, F, shape, lengths, dtype_name, gen)
            results[("decode_attention", shape, dtype_name)] = r
        # seamless's self-attention and cross-attention (group 1)
        for shape, lens in zip(SEAMLESS_DECODE, SEAMLESS_DECODE_LENS):
            r = attention_case(torch, F, shape, lens, dtype_name, gen)
            results[("decode_attention", shape, dtype_name)] = r
    # every group the kernel takes, every head dim, ragged Smax
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype_name in ("float32", "bfloat16"):
        for D in da.HEAD_DIMS:
            for group in range(1, da.max_group(D) + 1):
                r = attention_case(torch, F, (3, 2 * group, 2, D, 70),
                                   [1, 33, 70], dtype_name, gen,
                                   timed=False)
                worst[dtype_name] = max(worst[dtype_name], r["max_abs_err"])
                n += 1
    say("kernels", f"decode_attention sweep: {n} cases (group 1-8, D "
        f"{'/'.join(map(str, da.HEAD_DIMS[:-1]))}; group 1, D "
        f"{da.HEAD_DIMS[-1]}; Smax 70, lengths 1/33/70, "
        f"fp32 and bf16) all within tolerance, worst max_abs_err fp32 "
        f"{worst['float32']:.3e} bf16 {worst['bfloat16']:.3e}")
    # the split grid's edges: lengths on a span boundary, one past it, and
    # an Smax that is not a multiple of the span
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = 0
    grids = set()
    for dtype_name in ("float32", "bfloat16"):
        for D in da.HEAD_DIMS:
            for group in (g for g in (1, 2, 7, 8) if g <= da.max_group(D)):
                shape = (4, 2 * group, 2, D, DECODE_EDGE_SMAX)
                span, splits = da.split_plan(DECODE_EDGE_SMAX, 8, sms)
                if DECODE_EDGE_SMAX % span == 0 or splits < 4:
                    fail(f"kernels: Smax {DECODE_EDGE_SMAX} gives span "
                         f"{span} x {splits}, not a ragged split grid")
                r = attention_case(torch, F, shape,
                                   [span, span + 1, 3 * span,
                                    DECODE_EDGE_SMAX], dtype_name, gen,
                                   timed=False)
                worst[dtype_name] = max(worst[dtype_name], r["max_abs_err"])
                grids.add(r["grid"])
                n += 1
    say("kernels", f"decode_attention split edges: {n} cases (group "
        f"1/2/7/8, D {'/'.join(map(str, da.HEAD_DIMS[:-1]))}; group 1, D "
        f"{da.HEAD_DIMS[-1]}; Smax "
        f"{DECODE_EDGE_SMAX}, lengths span, "
        f"span + 1, 3 span, Smax; fp32 and bf16) all within tolerance, "
        f"worst max_abs_err fp32 {worst['float32']:.3e} bf16 "
        f"{worst['bfloat16']:.3e} | {'; '.join(sorted(grids))}")
    # head dims the wrapper zero-pads to the kernel's 64 or 128
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype_name in ("float32", "bfloat16"):
        for D in PADDED_DECODE_DIMS:
            for group in (1, 7):
                r = attention_case(torch, F, (3, 2 * group, 2, D, 300),
                                   [1, 129, 300], dtype_name, gen,
                                   timed=False)
                worst[dtype_name] = max(worst[dtype_name], r["max_abs_err"])
                n += 1
    say("kernels", f"decode_attention padded head dims: {n} cases (D "
        f"{'/'.join(map(str, PADDED_DECODE_DIMS))} zero-padded to 64, 128 "
        f"or 256, group 1/7, Smax 300, fp32 and bf16) all within "
        f"tolerance, worst max_abs_err fp32 {worst['float32']:.3e} bf16 "
        f"{worst['bfloat16']:.3e}")
    for dtype_name in ("float32", "bfloat16"):
        for shape in (DECODE_LONG, GEMMA_DECODE_LONG):
            r = attention_case(torch, F, shape, DECODE_LONG_LENGTHS,
                               dtype_name, gen, copies=3)
            results[("decode_attention", shape, dtype_name)] = r
    return results


# -- 4. model -----------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Route the model through the plain versions (comparison only)."""
    rmsnorm, da, fa, ssd = kernel_modules()
    with mock.patch.object(rmsnorm, "rms_norm", rmsnorm.rms_norm_plain), \
            mock.patch.object(da, "decode_attention",
                              da.decode_attention_plain), \
            mock.patch.object(fa, "flash_attention",
                              fa.flash_attention_plain), \
            mock.patch.object(ssd, "ssd_scan", ssd.ssd_scan_plain):
        yield


def kernel_modules():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels import ssd_scan as ssd
    return rmsnorm, da, fa, ssd


def reset_counts() -> None:
    for mod in kernel_modules():
        mod.launches = 0
        for k in getattr(mod, "variant_launches", {}):
            mod.variant_launches[k] = 0


def counts():
    """Launches of (rmsnorm, decode_attention, flash_attention,
    ssd_scan)."""
    return tuple(mod.launches for mod in kernel_modules())


def decode_instances() -> dict:
    """Decode-attention launches since ``reset_counts`` by the kernel
    instance they took: (head dim as launched, group)."""
    from repro_torch.kernels import decode_attention as da
    return {k: n for k, n in da.variant_launches.items() if n}


@contextlib.contextmanager
def recorded_routes(log: list):
    """Append the experts every MoE layer picks (``layers.moe.route``,
    (B, S, top_k) each) to ``log``."""
    from repro_torch.layers import moe
    route = moe.route

    def recording(*args, **kwargs):
        gates, experts = route(*args, **kwargs)
        log.append(experts)
        return gates, experts

    with mock.patch.object(moe, "route", recording):
        yield log


@contextlib.contextmanager
def replayed_routes(log: list, agree: list):
    """Send every MoE layer to the experts ``recorded_routes`` put in
    ``log`` (taken in order), gated by the softmax of this run's own
    router logits at them, so that a near-tie of router logits cannot
    send two runs to different experts.  Adds to ``agree`` ([same, all])
    the (token, layer) routes this run would have picked alike."""
    from repro_torch.layers import moe
    route = moe.route
    fixed = iter(log)

    def replaying(params, x, top_k, router_noise=None):
        _, own = route(params, x, top_k, router_noise)
        experts = next(fixed)
        agree[0] += int((own.sort(-1).values == experts.sort(-1).values)
                        .all(-1).sum())
        agree[1] += own[..., 0].numel()
        logits = x.float() @ params["router"]
        if router_noise is not None:
            logits = logits + router_noise
        return logits.gather(-1, experts).softmax(-1), experts

    with mock.patch.object(moe, "route", replaying):
        yield agree


def cache_leaves(cache: dict) -> list:
    """The K/V (latent, state) tensors of a ``decode_step`` cache: those
    of the scanned blocks, of the prefix blocks (deepseek's first) and of
    the shared block's applications (zamba2's)."""
    layers = list(cache["blocks"].values()) + [
        lc for pc in cache.get("prefix", ()) for lc in pc.values()]
    if "shared" in cache:
        layers.append(cache["shared"])
    return [t for lc in layers for t in lc.values()]


def clone_cache(cache: dict, leaf=None) -> dict:
    """A copy of a ``decode_step`` cache, each tensor through ``leaf``
    (default: a clone)."""
    leaf = leaf or (lambda t: t.clone())

    def block(b):
        return {s: {n: leaf(t) for n, t in lc.items()}
                for s, lc in b.items()}
    out = {"blocks": block(cache["blocks"]), "len": leaf(cache["len"])}
    if "prefix" in cache:
        out["prefix"] = [block(pc) for pc in cache["prefix"]]
    if "shared" in cache:
        out["shared"] = {n: leaf(t) for n, t in cache["shared"].items()}
    return out


# -- the fp32 anchor of a bf16 check ---------------------------------------------
#
# A bf16 kernel run and a bf16 plain run each carry bf16 rounding noise
# that grows with depth, so a limit on their difference read at one depth
# does not transfer to another, and a systematic fault hides inside twice
# one run's noise.  The anchor is a third run of the same inputs through
# the plain versions in fp32, on the bf16 run's own weights and cache
# upcast exactly; each bf16 run is read by its distance from it,
# d = |run - anchor|_2 / |anchor|_2 over all rows, and a sound kernel run
# is about as far from it as the plain bf16 run, at any depth.
#
# The largest d_kern / d_plain a sound kernel run may read, held in the
# bf16 full-depth logits checks of ANCHORED.  Read on an H100 (``--limits
# <arch>``; PERF.md section 6) over seeds 0-5 with sound kernels:
# gemma3-12b at 48 layers 0.9835 to 1.0113 (d_plain 4.6e-2 to 4.8e-2),
# seamless-m4t-large-v2 at 24 + 24 0.9886 to 0.9994 (1.2e-2),
# qwen2-vl-7b at 28 0.9873 to 1.0080 (2.2e-2), zamba2-7b at 13 repeats
# 0.9943 to 1.0003 (5.1e-2 to 5.6e-2); one kernel alone 0.9882 to 1.0089.
# A decode kernel that swaps output pairs read 13.4 to 112; one that
# drops the last tile of long rows 20.6 (gemma3), 12.2 (qwen2-vl) and
# 2.33 (zamba2), but 1.0207 on seamless (only its cross-attention rows,
# 1024 frames, lose a tile: not caught); one that rounds toward zero
# 0.9877 to 1.0115, inside the sound range on every arch (not caught;
# the fp32 checks and the kernels phase catch it).  One value for all
# four: 1.2 lies 19% above the worst sound reading and below the least
# control it catches by 1.9x
ANCHOR_RATIO = 1.2
# The card holds the bf16 weights while both bf16 runs are made, then the
# fp32 ones (``fp32_anchor`` upcasts leaf by leaf, so one bf16 leaf at a
# time beside them): gemma3-12b at 48 layers 23.5 GB, then 47.0 GB;
# qwen2-vl-7b at 28 layers 15.2, then 30.5 GB; zamba2-7b at 13 repeats
# 12.8, then 25.7 GB; seamless-m4t-large-v2 3.3, then 6.5 GB.  The
# anchor's cache (batch 4 x 512 slots) is the bf16 one's upcast copy,
# taken before the first step: 1.6 GB for gemma3-12b's 48 layers
ANCHORED = ("gemma3-12b", "seamless-m4t-large-v2", "qwen2-vl-7b",
            "zamba2-7b")


def upcast_cache(torch, cache: dict) -> dict:
    """The anchor's cache: a copy of ``cache`` with each floating tensor
    in fp32 (exact from bf16), taken before a run writes into it."""
    return clone_cache(cache, lambda t: t.to(torch.float32, copy=True)
                       if t.is_floating_point() else t.clone())


def fp32_anchor(torch, params, cfg, run):
    """``run(cfg32)`` through the plain versions, ``cfg32`` being
    ``cfg`` in fp32, after ``params`` is upcast in place (each floating
    leaf ``.float()``, one leaf at a time: ``nn.Module.float``).  Fails
    if a kernel launched.  Returns what ``run`` returns."""
    import dataclasses
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params.float()
    reset_counts()
    with plain_kernels():
        out = run(cfg32)
    sync(torch)
    if any(counts()):
        fail(f"anchor {cfg.name}: the fp32 anchor launched {counts()}")
    return out


def anchor_readings(torch, plain: list, kern: list, anchor: list) -> dict:
    """Each bf16 run's (``plain``, ``kern``: logits in order) distance
    from the fp32 ``anchor`` over all rows, ``|run - anchor|_2 /
    |anchor|_2``, its max abs distance and its argmax agreement with the
    anchor, and ``ratio`` = d_kern / d_plain.  Fails if d_plain is 0 or
    not finite: the anchor would not be independent of the bf16 run."""
    sq = {"plain": 0.0, "kern": 0.0}
    worst = {"plain": 0.0, "kern": 0.0}
    agree = {"plain": 0, "kern": 0}
    ref = 0.0
    rows = 0
    for p, k, a in zip(plain, kern, anchor, strict=True):
        top = a.argmax(-1)
        a = a.double()
        ref += float(a.square().sum())
        rows += top.numel()
        for name, x in (("plain", p), ("kern", k)):
            d = x.double() - a
            sq[name] += float(d.square().sum())
            worst[name] = max(worst[name], float(d.abs().max()))
            agree[name] += int((x.argmax(-1) == top).sum())
    d_plain, d_kern = (math.sqrt(sq[n] / ref) for n in ("plain", "kern"))
    if not (d_plain > 0 and math.isfinite(d_plain)):
        fail(f"anchor: d_plain {d_plain}, the anchor is not independent of "
             f"the bf16 plain run")
    return dict(d_plain=d_plain, d_kern=d_kern, ratio=d_kern / d_plain,
                worst=worst, agree=agree, rows=rows)


def anchor_text(a: dict) -> str:
    return (f"fp32 anchor: d_plain {a['d_plain']:.4e} d_kern "
            f"{a['d_kern']:.4e} ratio {a['ratio']:.4f} (limit "
            f"{ANCHOR_RATIO}), max abs from it plain {a['worst']['plain']:.3e}"
            f" kernels {a['worst']['kern']:.3e}, argmax agree with it plain "
            f"{a['agree']['plain']}/{a['rows']} kernels "
            f"{a['agree']['kern']}/{a['rows']}")


def decode_launches_per_step(cfg):
    """(rmsnorm, decode_attention, flash_attention, ssd_scan) launches of
    one ``decode_step``: two RMSNorms a layer (norm1 and norm2 of a
    decoder layer, norm1 and the gated norm of a Mamba2 mixer) and the
    final norm; one decode attention an attention layer; with
    cross-attention (over a filled cross cache) a third RMSNorm
    (``norm_x``) and a second decode attention an attention layer; a
    shared block (zamba2, one of ``n_layers`` a block) two RMSNorms and
    one decode attention an application."""
    attn = sum(s.kind == "attn" for s in cfg.block_pattern) * \
        cfg.block_repeat
    x = attn if cfg.cross_attn else 0
    shared = cfg.block_repeat if cfg.shared_attn else 0
    return (2 * cfg.n_layers + 1 + x, attn + x + shared, 0, 0)


def encode_launches(cfg):
    """(rmsnorm, flash_attention) launches of one ``encdec.encode``: two
    RMSNorms and one flash attention (``causal=False``) an encoder layer,
    and the encoder's final norm."""
    n = cfg.encoder.n_layers
    return (2 * n + 1, n)


def model_check(torch, dtype_name: str, seed: int = 0,
                profile: bool = False, reduced: bool = False,
                arch: str = "qwen2-0.5b", depth=None, max_len: int = 512,
                start_lens=(0, 37, 200, 500), steps: int = 6,
                profiled_steps: int = 5, instance=None,
                anchor: bool = False) -> dict:
    """``arch`` FULL (or REDUCED; at ``depth`` blocks if given):
    ``steps`` ``decode_step`` calls through the plain versions and
    through the kernels on the same weights, cache of ``max_len`` slots
    filled with seeded random K/V at ``start_lens``, and tokens from
    ``seed``; a MoE model's kernel run takes the plain run's routes
    (``replayed_routes``).  An arch fed embeddings (qwen2-vl) takes
    seeded patch embeddings at every step instead, and first prefills
    ``len(start_lens)`` prompts of up to VL_PREFILL embeddings (lengths
    VL_PREFILL_LENS) through ``prefill(..., embeds=)`` both ways, its
    last logits held with the steps'.  Checks launches and logits' shape
    and finiteness, and with ``instance`` ((head dim, group)) that every
    decode attention took that kernel instance; returns the logits' max
    abs difference, max |logit|, argmax agreement, the routes the kernel
    run would have picked alike, the kernel runs' launches and wall ms
    per step (the comparison limits are the caller's).  With ``anchor``
    (a bf16 check), after both runs (and the profile) the same prefill
    and steps run once more through the plain versions in fp32
    (``fp32_anchor``), from the weights and the seeded cache upcast, the
    MoE layers sent to the plain run's routes, and ``anchor`` holds each
    run's distance from it (``anchor_readings``)."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    cfg = (C.get_reduced if reduced else C.get_config)(arch)
    cfg = dataclasses.replace(cfg, dtype=dtype_name,
                              block_repeat=depth or cfg.block_repeat)
    per_step = decode_launches_per_step(cfg)
    B = len(start_lens)
    start_lens = list(start_lens)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = T.init_params(gen, cfg, device=DEVICE)
    cache = T.init_cache(cfg, B, max_len, device=DEVICE)
    for t in cache_leaves(cache):
        t.normal_(generator=gen)
    cache["len"] = torch.tensor(start_lens, dtype=torch.int32, device=DEVICE)
    plain_cache = clone_cache(cache)
    anchor_cache = upcast_cache(torch, cache) if anchor else None
    toks = torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    worst, scale, agree = 0.0, 0.0, 0
    routes = [0, 0]
    t_kern = t_plain = 0.0
    embeds = [None] * steps
    rows = B * steps
    launched = (0, 0, 0, 0)
    # both runs' logits in order, and the plain run's routes step by
    # step, for the anchor
    kept = {"plain": [], "kern": [], "routes": []}
    prefill = None
    if cfg.embeds_input:
        embeds = torch.randn(steps, B, 1, cfg.d_model, generator=gen,
                             device=DEVICE)
        r = vl_prefill_check(torch, T, params, cfg, B, max_len, gen)
        worst, scale, agree = r["worst"], r["scale"], r["agree"]
        rows += B
        launched = counts()
        prefill = r["inputs"]
        kept["plain"].append(r["plain"])
        kept["kern"].append(r["logits"])
    for s in range(steps):
        reset_counts()
        step_routes = []
        with plain_kernels(), recorded_routes(step_routes):
            sync(torch)
            t0 = time.perf_counter()
            plain, plain_cache = T.decode_step(params, cfg, toks[s],
                                               plain_cache, embeds[s])
            sync(torch)
            if s:                        # step 0 pays one-time set-up
                t_plain += time.perf_counter() - t0
        if any(counts()):
            fail("model: the plain run launched a kernel")
        t0 = time.perf_counter()
        with replayed_routes(step_routes, routes):
            logits, cache = T.decode_step(params, cfg, toks[s], cache,
                                          embeds[s])
        sync(torch)
        if s:
            t_kern += time.perf_counter() - t0
        if counts() != per_step:
            fail(f"model {dtype_name}: launches {counts()} in one "
                 f"decode_step, expected {per_step}")
        if instance is not None and set(decode_instances()) != {instance}:
            fail(f"model {dtype_name}: decode attention on (head dim, "
                 f"group) {decode_instances()}, expected only {instance}")
        launched = tuple(a + b for a, b in zip(launched, counts()))
        if tuple(logits.shape) != (B, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            fail(f"model {dtype_name}: bad logits {logits.shape}")
        worst = max(worst, float((logits.float() - plain.float()).abs().max()))
        scale = max(scale, float(plain.float().abs().max()))
        agree += int((logits.argmax(-1) == plain.argmax(-1)).sum())
        kept["plain"].append(plain)
        kept["kern"].append(logits)
        kept["routes"].append(step_routes)
    lc = dict(cache["blocks"]["l0"], **cache.get("shared", {}))
    smax = next((lc[n].shape[2] for n in ("k", "c_kv") if n in lc), None)
    if profile:
        profile_steps(torch, T, params, cfg, cache, toks[:profiled_steps])
    del cache, plain_cache
    anchored = None
    if anchor:
        def run(cfg32):
            out = [] if prefill is None else [
                T.prefill(params, cfg32, embeds=prefill["embeds"],
                          lengths=prefill["lengths"],
                          tokens=prefill["tokens"],
                          max_len=max_len)[0]]
            c = anchor_cache
            for s, log in enumerate(kept["routes"]):
                with replayed_routes(log, [0, 0]):
                    logits, c = T.decode_step(params, cfg32, toks[s], c,
                                              embeds[s])
                out.append(logits)
            return out

        anchored = anchor_readings(torch, kept["plain"], kept["kern"],
                                   fp32_anchor(torch, params, cfg, run))
    del params, anchor_cache, kept
    torch.cuda.empty_cache()
    return dict(cfg=cfg, batch=B, start_lens=start_lens, steps=steps,
                max_len=max_len, smax=smax,
                per_step=per_step, worst=worst, scale=scale, agree=agree,
                rows=rows, ms_kernels=t_kern / (steps - 1) * 1e3,
                ms_plain=t_plain / (steps - 1) * 1e3, routes=tuple(routes),
                launched=launched, anchor=anchored)


# qwen2-vl's prefill in model_check: prompts of patch embeddings, ragged
VL_PREFILL = 32
VL_PREFILL_LENS = (32, 17, 5, 32)


def vl_prefill_check(torch, T, params, cfg, batch: int, max_len: int,
                     gen) -> dict:
    """``prefill(..., embeds=)`` of ``batch`` prompts of seeded patch
    embeddings (lengths VL_PREFILL_LENS) through the plain versions and
    through the kernels: each replay step launches what a decode step
    does.  Returns the last logits of both runs, their max abs
    difference, max |logit| and argmax agreement, and the prefill's
    inputs (``prefill``'s keyword arguments but ``max_len``)."""
    emb = torch.randn(batch, VL_PREFILL, cfg.d_model, generator=gen,
                      device=DEVICE)
    toks = torch.zeros(batch, VL_PREFILL, dtype=torch.int32, device=DEVICE)
    lens = torch.tensor(VL_PREFILL_LENS[:batch], dtype=torch.int32,
                        device=DEVICE)
    reset_counts()
    with plain_kernels():
        plain, pc = T.prefill(params, cfg, toks, max_len, embeds=emb,
                              lengths=lens)
    if any(counts()):
        fail("prefill: the plain run launched a kernel")
    del pc
    logits, kc = T.prefill(params, cfg, toks, max_len, embeds=emb,
                           lengths=lens)
    sync(torch)
    want = tuple(n * VL_PREFILL for n in decode_launches_per_step(cfg))
    if counts() != want:
        fail(f"prefill {cfg.name}: launches {counts()} in {VL_PREFILL} "
             f"replay steps, expected {want}")
    if kc["len"].tolist() != list(VL_PREFILL_LENS[:batch]) or not bool(
            torch.isfinite(logits).all()):
        fail(f"prefill {cfg.name}: lengths {kc['len'].tolist()} or "
             f"non-finite logits")
    del kc
    return dict(worst=float((logits.float() - plain.float()).abs().max()),
                scale=float(plain.float().abs().max()),
                agree=int((logits.argmax(-1) == plain.argmax(-1)).sum()),
                plain=plain, logits=logits,
                inputs=dict(tokens=toks, embeds=emb, lengths=lens))


def head_text(cfg) -> str:
    if cfg.attn_kind == "mla":
        return (f"MLA q/k {cfg.qk_nope_head_dim + cfg.qk_rope_head_dim} v "
                f"{cfg.v_head_dim}")
    return f"head dim {cfg.head_dim}"


def model_readings(r: dict, dtype_name: str) -> str:
    text = (f"logits max_abs_err kernels vs plain {r['worst']:.3e} (tol "
            f"{LOGIT_TOL[dtype_name]}, max|logit| {r['scale']:.3e}), argmax "
            f"agree {r['agree']}/{r['rows']} (floor "
            f"{ARGMAX_FLOOR[dtype_name]:.0%})")
    same, n = r["routes"]
    if n:
        text += (f", MoE routes replayed from the plain run (the kernel "
                 f"run's own agree {same}/{n}, {same / n:.2%})")
    if r.get("anchor"):
        text += ", " + anchor_text(r["anchor"])
    return text


def model_phase(torch, reduced: bool = False, phase: str = "model",
                arch: str = "qwen2-0.5b", depths=None,
                dtypes=("float32", "bfloat16"), hold_logits: bool = True,
                profile=None, profiled_steps: int = 5, instance=None,
                anchor: bool = False, **shape) -> dict:
    """``model_check`` in each of ``dtypes`` (at ``depths[dtype]`` blocks
    where given), held to LOGIT_TOL and ARGMAX_FLOOR, or to ARGMAX_FLOOR
    alone with ``hold_logits=False`` (the logits difference is then
    printed, not held); with ``anchor``, the bf16 run also against its
    fp32 anchor, held to ANCHOR_RATIO.  The bf16 FULL run also profiles
    its decode steps unless ``shape`` (``model_check``'s ``max_len``,
    ``start_lens``, ``steps``) is given, or as ``profile`` says, over
    ``profiled_steps`` decode steps.  Returns ``model_check``'s readings
    by dtype."""
    out = {}
    for dtype_name in dtypes:
        r = model_check(torch, dtype_name, reduced=reduced, arch=arch,
                        depth=(depths or {}).get(dtype_name),
                        profile=(dtype_name == "bfloat16" and not reduced
                                 and not shape) if profile is None
                        else profile, profiled_steps=profiled_steps,
                        instance=instance,
                        anchor=anchor and dtype_name == "bfloat16", **shape)
        out[dtype_name] = r
        readings = model_readings(r, dtype_name)
        if (hold_logits and r["worst"] > LOGIT_TOL[dtype_name]) or \
                r["agree"] < ARGMAX_FLOOR[dtype_name] * r["rows"] or \
                (r["anchor"] and r["anchor"]["ratio"] > ANCHOR_RATIO):
            fail(f"{phase} {dtype_name}: {readings}")
        if not hold_logits:
            readings += (" (the abs difference not held at this depth"
                         + ("; the anchored ratio is)" if r["anchor"]
                            else ")"))
        cfg = r["cfg"]
        say(phase, f"{arch} {'REDUCED' if reduced else 'FULL width'} "
            f"({cfg.n_layers} layers, d {cfg.d_model}, {head_text(cfg)}, "
            f"vocab {cfg.vocab_size}) {dtype_name} batch "
            f"{r['batch']} max_len {r['max_len']} ({r['smax']} slots) lens "
            f"{r['start_lens']}+{r['steps']} steps"
            + (f" after a prefill of patch embeddings (lengths "
               f"{list(VL_PREFILL_LENS)})" if cfg.embeds_input else "")
            + ": "
            f"{readings}, launches/step rmsnorm {r['per_step'][0]} "
            f"decode_attention {r['per_step'][1]}, wall per step after the "
            f"first {r['ms_kernels']:.2f} ms kernels / {r['ms_plain']:.2f} "
            f"ms plain")
    return out


# broken decode-attention kernels, made by a wrapper around the sound one,
# read against the model phase's limits (``--limits``)
CONTROLS = ("drop_tile", "swap_pairs", "round_to_zero")


def broken_decode(torch, kind: str):
    """Patch the decode-attention wrapper with a deliberate fault:
    ``drop_tile`` skips the last 32-slot tile of every row longer than one
    tile; ``swap_pairs`` stores each pair of output elements swapped;
    ``round_to_zero`` rounds the fp32 result toward zero to bf16
    precision instead of to nearest."""
    from repro_torch.kernels import decode_attention as da
    sound = da.decode_attention

    def faulty(q, k, v, lengths):
        if kind == "drop_tile":
            last = (lengths - 1) % 32 + 1
            return sound(q, k, v, torch.where(lengths > 32, lengths - last,
                                              lengths))
        if kind == "swap_pairs":
            out = sound(q, k, v, lengths)
            return out.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
        out = sound(q.float(), k.float(), v.float(), lengths)
        return (out.view(torch.int32) & -65536).view(torch.float32).to(
            q.dtype)

    return mock.patch.object(da, "decode_attention", faulty)


@contextlib.contextmanager
def one_kernel(keep):
    """Run only the ``keep`` kernel ("rmsnorm", "decode_attention",
    "flash_attention" or "ssd_scan"; None: none of them); the other
    wrappers run their plain versions, still counting their launches so
    that the launch checks hold.  Shows which kernel's rounding flips a
    bf16 reading comes from."""
    rmsnorm, da, fa, ssd = kernel_modules()
    wrappers = {"rmsnorm": (rmsnorm, "rms_norm", rmsnorm.rms_norm_plain),
                "decode_attention": (da, "decode_attention",
                                     da.decode_attention_plain),
                "flash_attention": (fa, "flash_attention",
                                    fa.flash_attention_plain),
                "ssd_scan": (ssd, "ssd_scan", ssd.ssd_scan_plain)}
    with contextlib.ExitStack() as stack:
        for name, (mod, attr, plain) in wrappers.items():
            if name == keep:
                continue

            def counted(*args, _mod=mod, _plain=plain, **kwargs):
                _mod.launches += 1
                return _plain(*args, **kwargs)

            stack.enter_context(mock.patch.object(mod, attr, counted))
        yield


def limits_phase(torch, arch: str = "mixtral-8x7b", depths=None,
                 seeds=range(6)) -> None:
    """The readings that show the model phase's limits fit ``arch``:
    ``model_check`` over ``seeds`` with the sound kernels, and at seed 0
    under each broken kernel of CONTROLS and with one of the two kernels
    at a time (``one_kernel``), for each dtype of ``depths`` (in blocks;
    by default the arch's smoke depths and, for gemma3-12b, bf16 also at
    all 48 layers; deepseek-v2-lite-16b's, qwen2-vl-7b's and
    seamless-m4t-large-v2's bf16 depth is the whole model; zamba2-7b at
    2, 4 and all 13 repeats in both dtypes).  seamless is
    read through ``seamless_check`` (encode, prefill and decode steps;
    its flash kernel also alone).  The bf16 runs of ANCHORED at the
    whole depth also read their fp32 anchor (ANCHOR_RATIO).  Prints them
    and checks nothing (``python3 chip_smoke.py --limits [arch]``)."""
    if depths is None:
        ats = {"mixtral-8x7b": (MIXTRAL_DEPTHS,),
               "gemma3-12b": (GEMMA_DEPTHS, {"bfloat16": None}),
               DEEPSEEK: (DEEPSEEK_DEPTHS,), QWEN_VL: (QWEN_VL_DEPTHS,),
               SEAMLESS: (SEAMLESS_DEPTHS,),
               ZAMBA: ZAMBA_LIMIT_DEPTHS}[arch]
    else:
        ats = (depths,)
    if arch == ZAMBA and depths is None:
        train_limits(torch)
    check = seamless_check if arch == SEAMLESS else model_check
    alone = ("rmsnorm", "decode_attention") + (
        ("flash_attention",) if arch == SEAMLESS else ())
    runs = ([(seed, None) for seed in seeds] + [(0, k) for k in CONTROLS]
            + [(0, k) for k in alone])
    for at in ats:
        for dtype_name, depth in at.items():
            anchor = (arch in ANCHORED and dtype_name == "bfloat16"
                      and depth is None)
            for seed, kind in runs:
                if kind in CONTROLS:
                    patch = broken_decode(torch, kind)
                    what = f"control {kind}"
                elif kind:
                    patch, what = one_kernel(kind), f"only the {kind} kernel"
                else:
                    patch, what = contextlib.nullcontext(), f"seed {seed}"
                # a wrapper replaced by a control or its plain version
                # takes no kernel instance
                with patch:
                    r = check(torch, dtype_name, seed=seed, arch=arch,
                              depth=depth, instance=None, anchor=anchor)
                say("limits", f"{arch} {dtype_name} {r['cfg'].n_layers} "
                    f"layers {what}: " + model_readings(r, dtype_name))


# profiler ranges around the MoE FFNs (the program's own ``moe_forward``
# span) and the attention wrappers' padding
RANGES = ("moe_forward", "attend_padded")


@contextlib.contextmanager
def named_ranges():
    """Run each attention wrapper's padding (``attend_padded``, the kernel
    launch inside it) in a ``torch.profiler.record_function`` range of
    that name, so that a profile can tell its kernels from the rest; each
    MoE FFN is a ``moe_forward`` range of the program's own
    (``repro_torch.tracing``)."""
    from torch.profiler import record_function

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    with contextlib.ExitStack() as stack:
        for mod in (da, fa):
            def ranged(*args, _fn=mod.attend_padded, **kw):
                with record_function(RANGES[1]):
                    return _fn(*args, **kw)
            stack.enter_context(mock.patch.object(mod, RANGES[1], ranged))
        yield


def ranged_ms(prof, steps: int) -> dict:
    """Device ms a step of the profile's matrix products inside an MoE FFN
    and of the kernels inside the attention wrappers' padding other than
    the attention kernel (the padding copies and the output's slice): each
    kernel attributed through the PyTorch op that launched it and that
    op's enclosing ranges.  None where no kernel was attributed."""
    expert = pad = 0.0
    found = False
    for e in prof.events():
        kernels = getattr(e, "kernels", None)
        if not kernels:
            continue
        found = True
        names, p = set(), e
        while p is not None:
            names.add(p.name)
            p = p.cpu_parent
        for k in kernels:
            kname = k.name.lower()
            if any(w in kname for w in ("decode_attention",
                                        "flash_attention", "rmsnorm")):
                continue
            if RANGES[0] in names and any(w in kname for w in GEMM_WORDS):
                expert += k.duration
            elif RANGES[1] in names:
                pad += k.duration
    if not found:
        return {"moe ffn gemm": None, "padding copies": None}
    return {"moe ffn gemm": expert / 1e3 / steps,
            "padding copies": pad / 1e3 / steps}


def expert_bound_text(params, expert_ms) -> str:
    """The MoE FFNs' weights (``blocks.<r>.<slot>.ffn.*``: the routed
    experts, which dense dispatch reads whole every step, the shared
    experts and the router) against the profile's matrix products inside
    ``moe_forward``, which are those of the same three; empty for a model
    without MoE FFNs."""
    nbytes = sum(p.numel() * p.element_size()
                 for n, p in params.named_parameters()
                 if re.fullmatch(r"blocks\.\d+\.l\d+\.ffn\..+", n))
    if not nbytes or not expert_ms:
        return ""
    ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (f"; MoE FFN weights (routed and shared experts, router) "
            f"{nbytes / 1e9:.2f} GB: bound {ms:.3f} ms (their products "
            f"{expert_ms / ms:.2f}x it)")


def profile_steps(torch, T, params, cfg, cache, toks) -> None:
    """Where a decode step's time goes: wall time per step without and
    with torch.profiler, and the profiled device time by kernel family
    (busy share = device kernel time / wall time).  The products inside
    a MoE FFN (routed and shared experts, router), and the copies of a
    padded attention head dim, are set apart from the matrix products and
    "other" (``named_ranges``)."""
    from torch.profiler import ProfilerActivity, profile
    steps = toks.shape[0]
    sync(torch)
    t0 = time.perf_counter()
    for s in range(steps):
        _, cache = T.decode_step(params, cfg, toks[s], cache)
    sync(torch)
    wall = (time.perf_counter() - t0) / steps
    cache["len"] = cache["len"] - steps
    with named_ranges(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(steps):
            _, cache = T.decode_step(params, cfg, toks[s], cache)
        sync(torch)
        wall_prof = (time.perf_counter() - t0) / steps
    families = {"gemm": 0.0, "decode_attention": 0.0, "rmsnorm": 0.0,
                "other": 0.0}
    per_kernel = []
    n_kernels = 0
    # every weight is read once a step (a MoE FFN computes every expert),
    # but an untied embedding table only at the batch's rows, and an
    # encoder's not at all (its memory's K/V sit in the cross cache)
    weight_bytes = sum(p.numel() * p.element_size()
                       for n, p in params.named_parameters()
                       if (n != "embed" or cfg.tie_embeddings)
                       and not n.startswith("encoder."))
    weight_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    for e in prof.key_averages():
        if "cuda" not in str(e.device_type).lower() or e.key in RANGES:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        n_kernels += e.count
        name = e.key.lower()
        fam = ("decode_attention" if "decode_attention" in name else
               "rmsnorm" if "rmsnorm" in name else
               "gemm" if any(w in name for w in GEMM_WORDS) else "other")
        families[fam] += us / 1e3 / steps
        per_kernel.append((us / 1e3 / steps, e.count // steps, e.key))
    busy = sum(families.values())
    if busy <= 0:
        say("profile", f"decode_step wall {wall * 1e3:.2f} ms; device time "
            f"not measured (the profiler saw no device kernels)")
        return
    apart = ranged_ms(prof, steps)
    for fam, whole in (("moe ffn gemm", "gemm"), ("padding copies", "other")):
        if apart[fam] is not None:
            families[whole] -= apart[fam]
        families[fam] = apart[fam]
    if apart["moe ffn gemm"] == 0.0 and cfg.ffn_kind == "moe":
        fail(f"profile: no matrix product attributed to {cfg.name}'s MoE "
             f"FFNs")
    say("profile", f"{cfg.name} FULL width, {cfg.n_layers} layers, bf16 "
        f"decode_step, batch 4: wall "
        f"{wall * 1e3:.2f} ms/step ({wall_prof * 1e3:.2f} ms under the "
        f"profiler), device kernels {busy:.3f} ms/step "
        f"({n_kernels / steps:.0f} launches/step, busy share "
        f"{busy / (wall_prof * 1e3):.1%} of profiled wall, "
        f"{busy / (wall * 1e3):.1%} of unprofiled): "
        + ", ".join(f"{k} {'not measured' if v is None else f'{v:.3f} ms'}"
                    for k, v in families.items())
        + f" | weights {weight_bytes / 1e9:.2f} GB, read once a step: "
        f"bound {weight_ms:.3f} ms (device time {busy / weight_ms:.2f}x it)"
        + expert_bound_text(params, families["moe ffn gemm"]))
    top = sorted(per_kernel, reverse=True)[:6]
    say("profile", "top kernels by device ms/step: " + "; ".join(
        f"{name[:60]} x{n} {ms:.3f} ms" for ms, n, name in top))


# -- 5. serve -----------------------------------------------------------------

SEARCH_CLUSTER = "h100x8"


def search_text(base, best) -> str:
    """The plan search's baseline and best plan, held to a priced plan and
    a finite best time above 0."""
    e2e = best.best.e2e_latency
    if best.num_schemes < 1 or not (math.isfinite(e2e) and e2e > 0):
        fail(f"serve: the plan search priced {best.num_schemes} plans, "
             f"best e2e {e2e}")
    return (f"plan search for the FULL model on {SEARCH_CLUSTER} (the "
            f"port's simulator, analytic tables): baseline "
            f"{base.plan_label} e2e {base.e2e_latency:.3f} s, best "
            f"{best.best.plan_label} e2e {e2e:.3f} s "
            f"({base.e2e_latency / e2e:.3f}x), {best.num_schemes} plans "
            f"priced ({best.num_feasible} feasible) in "
            f"{best.search_seconds:.2f} s")


def serve_phase(torch, smi: str, size: str = "full", phase: str = "serve",
                arch: str = "qwen2-0.5b", depth=None, max_len: int = 512,
                requests: int = 8, prompt_cap: int = 128,
                gen_cap: int = 64, instances=None, search: bool = False):
    """``requests`` chat-trace requests (prompts cut to ``prompt_cap``,
    outputs to ``gen_cap``) served through ``launch.serve.serve`` in
    bf16 (at ``depth`` blocks if given) with caches of ``max_len``
    slots; every request must finish with its token count, and every
    step must launch exactly its kernels; with ``instances`` ((head dim,
    group) of the decode kernel), every decode attention on that
    instance.  With ``search``, through ``launch.serve.plan_and_serve``:
    APEX's plan search for ``arch`` FULL on ``SEARCH_CLUSTER`` first.
    Returns the launches, the engine's report and the requests served."""
    import dataclasses

    from repro_torch.launch.serve import plan_and_serve, serve
    from repro_torch import configs as C
    cfg = (C.get_config if size == "full" else C.get_reduced)(arch)
    cfg = dataclasses.replace(cfg, block_repeat=depth or cfg.block_repeat)
    vocab = cfg.vocab_size
    torch.cuda.empty_cache()
    engine = dict(arch=arch, size=size, requests=requests, max_batch=4,
                  max_len=max_len, prompt_cap=prompt_cap, gen_cap=gen_cap,
                  seed=0, device=DEVICE, log=lambda s: None, depth=depth)
    reset_counts()
    if search:
        base, best, report, reqs = plan_and_serve(cluster=SEARCH_CLUSTER,
                                                  **engine)
    else:
        report, reqs = serve(**engine)
    launched = counts()
    if search:
        say(phase, search_text(base, best))
    seen = decode_instances()
    if len(report.results) != len(reqs):
        fail(f"{phase}: {len(report.results)} of {len(reqs)} finished")
    by_rid = {r["rid"]: r for r in reqs}
    for res in report.results:
        want = max(by_rid[res.rid]["gen_len"], 2)
        if len(res.tokens) != want:
            fail(f"{phase}: rid {res.rid} gave {len(res.tokens)} tokens, "
                 f"expected {want}")
        if not all(0 <= t < vocab for t in res.tokens):
            fail(f"{phase}: rid {res.rid} has a token outside the vocab")
    steps = report.iterations + sum(len(r["prompt"]) for r in reqs)
    per_step = decode_launches_per_step(cfg)
    want = tuple(n * steps for n in per_step)
    if report.preemptions == 0 and launched != want:
        fail(f"{phase}: launches {launched} for {steps} decode steps, "
             f"expected {want} ({per_step} a step)")
    if min(launched[:2]) <= 0:
        fail(f"{phase}: a kernel was never launched: {launched}")
    if instances is not None and set(seen) != {instances}:
        fail(f"{phase}: decode attention launched on (head dim, group) "
             f"{seen}, expected only {instances}")
    say(phase, f"{arch} {size.upper()} ({cfg.n_layers} layers, "
        f"{head_text(cfg)}, max_len {max_len}) bf16 on {smi}: "
        f"{len(report.results)} "
        f"requests (prompts {[len(r['prompt']) for r in reqs]}, gen "
        f"{[r['gen_len'] for r in reqs]}) in {report.total_time:.3f} s, "
        f"{report.iterations} iterations + "
        f"{steps - report.iterations} prefill steps, "
        f"{report.preemptions} preemptions | TTFT mean "
        f"{report.ttft_mean * 1e3:.1f} ms TPOT mean "
        f"{report.tpot_mean * 1e3:.2f} ms throughput "
        f"{report.throughput:.1f} tok/s | launches rmsnorm {launched[0]} "
        f"decode_attention {launched[1]} ({per_step[0]} and {per_step[1]} "
        f"a step; decode instances by (head dim, group) {seen})")
    return launched, report, reqs


def reduced_phase(torch, smi: str) -> None:
    """qwen2-0.5b REDUCED, head dim 8: both attention kernels run it
    zero-padded (decode to 64, flash to 16).  mixtral-8x7b REDUCED, head
    dim 16 (decode pads it to 64), window 16: its ring caches hold 32
    slots, so the served prompts (up to 128 tokens) wrap them, and its
    train step runs the flash kernel with the window.  deepseek-v2-lite-16b
    REDUCED (MLA: q and k 24 wide, v 16, both padded to 64 by the decode
    wrapper; a dense prefix layer): logits and serve (the port does not
    train MLA)."""
    from repro_torch import configs as C
    for arch in ("qwen2-0.5b", "mixtral-8x7b", DEEPSEEK):
        model_phase(torch, reduced=True, phase="reduced", arch=arch)
        serve_phase(torch, smi, size="reduced", phase="reduced", arch=arch)
        if C.get_reduced(arch).attn_kind != "mla":
            train_parity_phase(torch, dict(TRAIN, arch=arch),
                               phase="reduced", reduced=True)


# -- profile ------------------------------------------------------------------

PROFILE_X_MAX = 4096
SSD_PROFILE_X = (128, 1024, 4096)
# deepseek-v2-lite-16b's attn_decode table: the simulator prices MLA's
# decode at (n_heads, kv_lora_rank) = (16, 512), which the profiler times
# on the decode kernel's head-dim-512, group-1 instance
MLA_DECODE_AXES = (16, 512, "bf16")
MLA_PROFILE_X = (128, 1024, 4096)
# the kernel each profiled op launches: its index in counts()
PROFILE_KERNELS = {"attn_decode": 1, "attn_prefill": 2, "ssd_scan": 3}
# the record's cases, at the profile's largest x: decode (B, Hq, Hkv, D,
# Smax) over 4096 KV tokens; flash causal at S 90 (area 4095); the SSD
# scan over 4096 tokens (B, S, H, P, N, chunk)
PROFILE_DECODE = (1, 2, 2, 64, 4096)
PROFILE_MLA_DECODE = (1, 16, 16, 512, 4096)
PROFILE_FLASH = (1, 90, 90, 14, 14, 64, None, 0)
PROFILE_SSD = (1, 4096, 80, 64, 128, 128)
# the other archs the engine serves: every table the simulator prices
# them with at FULL and qwen2-0.5b's keys above lack, at these x
PROFILE_ARCHS = ("internlm2-1.8b", "qwen1.5-32b", "mixtral-8x7b",
                 "gemma3-12b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                 "zamba2-7b")
ARCH_PROFILE_X = (1, 16, 256, 4096)
# the record's cases at the largest of those tables: qwen1.5-32b's decode
# (40, 128) and prefill (40, 128) attention, zamba2's SSD scan (7168, 64)
PROFILE_ARCHS_DECODE = (1, 40, 40, 128, 4096)
PROFILE_ARCHS_FLASH = (1, 90, 90, 40, 40, 128, None, 0)
PROFILE_ARCHS_SSD = (1, 4096, 112, 64, 64, 128)


def profile_keys(cfg, ssm_cfg, grid):
    """``(op, axes, xs)`` of every table the simulator prices ``cfg`` (a
    dense GQA decoder) with (``arch_tables``) over ``grid``; then
    ``ssm_cfg``'s SSD scan at ``SSD_PROFILE_X``, and
    deepseek-v2-lite-16b's MLA decode sample (MLA_DECODE_AXES) at
    MLA_PROFILE_X."""
    keys = [(op, axes, grid) for op, axes in arch_tables(cfg)]
    keys.append(("ssd_scan", (ssm_cfg.d_inner, ssm_cfg.d_state, "bf16"),
                 SSD_PROFILE_X))
    keys.append(("attn_decode", MLA_DECODE_AXES, MLA_PROFILE_X))
    return keys


def arch_tables(cfg) -> list:
    """``(op, axes)`` of every table the port's simulator prices ``cfg``
    with (an arch the engine serves) on one H100 in bf16, the heuristic
    plan Fig. 6 prices: the keys its ``ProfileStore`` queries for one
    iteration that prefills one prompt and decodes one sequence, in the
    order it first queries them.  deepseek's dense first layer is not in
    the IR (``to_ir`` ignores ``first_k_dense``), so neither is its MLP."""
    from repro_torch.core import (AnalyticBackend, ApexSearch, PlanSimulator,
                                  h100_node, heuristic_scheme, map_scheme)
    from repro_torch.core.ir import Workload
    keys = {}

    class Recording(AnalyticBackend):
        def measure(self, op, axes, x):
            keys.setdefault((op, tuple(axes)))
            return super().measure(op, axes, x)

    model = cfg.to_ir()
    cluster = h100_node(1)
    search = ApexSearch(model, cluster, backend=Recording(cluster))
    scheme = heuristic_scheme(model, 1, cluster, quant="bf16")
    sim = PlanSimulator(map_scheme(scheme, cluster), search.store,
                        search.coll)
    sim.iteration_cost(Workload.from_batch([(16, 16)], [16], sim.windows,
                                           batch_sequences=2))
    return list(keys)


def sample_text(phase: str, op: str, axes, x: float, wall: float,
                dev: float) -> str:
    """One sample's wall and device ms beside the bound of the work the
    simulator charges it; fails on a time that is not finite or below its
    bound."""
    from repro_torch.core.profiles import _op_work
    flops, nbytes, dtype = _op_work(op, axes, float(x))
    peak = FP32_FLOPS if dtype == "fp32" else BF16_FLOPS
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / peak)
    text = (f"x {x:g}: wall {wall * 1e3:.4f} device {dev * 1e3:.4f} "
            f"bound {bound_s * 1e3:.3g} ms")
    if not (math.isfinite(wall) and math.isfinite(dev)) \
            or min(wall, dev) < bound_s:
        fail(f"{phase} {op} {axes} {text}: not finite or below the bound")
    return text


def sample_tables(timer, keys, samples: dict) -> None:
    """Each ``(op, axes, xs)`` table through ``timer`` (a
    ``MeasuredBackend``), kept in ``samples`` (``(op, axes, x)`` ->
    ``(wall_s, device_s)``, as ``TorchMeasuredBackend`` keeps them): one
    line a table, each sample checked by ``sample_text``."""
    for op, axes, xs in keys:
        readings = []
        for x in xs:
            wall, dev = timer.measure(op, axes, float(x))
            samples[(op, tuple(axes), float(x))] = (wall, dev)
            readings.append(sample_text("profile", op, axes, x, wall, dev))
        say("profile", f"op table {op} {axes}: " + "; ".join(readings))


def expected_launches(timer) -> tuple:
    """(rmsnorm, decode, flash, ssd) launches of ``timer``'s calls: one
    kernel launch per profiled attention or scan call, no RMSNorm."""
    want = [0, 0, 0, 0]
    for op, i in PROFILE_KERNELS.items():
        want[i] = timer.calls[op]
    return tuple(want)


def profile_phase(torch, F):
    """The port's op profiler (``repro_torch.core.profiles``) over every
    table qwen2-0.5b FULL needs, mamba2-2.7b's SSD scan and deepseek's
    MLA decode sample: wall and device time of each sample, each at or
    above its bound (the work the simulator charges the sample,
    ``_op_work``), and exactly one kernel launch per profiled attention
    or scan call, the MLA samples' on the decode kernel's D 512 instance;
    then the same over the other engine archs' tables (``arch_tables``)
    that those lack, at ``ARCH_PROFILE_X``.  Returns the launches (the
    four kernels', the D 512 instance's, then the four kernels' in the
    other archs' tables), the kernels' cases at the largest shapes of
    both, and the samples of the first tables (qwen2-0.5b's and the two
    extra ones)."""
    from repro_torch import configs as C
    from repro_torch.core.profiles import _GRID, MeasuredBackend
    timer = MeasuredBackend(DEVICE, repeats=3)
    grid = [x for x in _GRID if x <= PROFILE_X_MAX]
    keys = profile_keys(C.get_config("qwen2-0.5b"),
                        C.get_config("mamba2-2.7b"), grid)
    samples = {}
    reset_counts()
    t0 = time.perf_counter()
    sample_tables(timer, keys, samples)
    secs = time.perf_counter() - t0
    launched = counts()
    wide = decode_instances().get((MLA_DECODE_AXES[1], 1), 0)
    if launched != expected_launches(timer):
        fail(f"profile: launches {launched}, expected "
             f"{expected_launches(timer)} from the profiler's calls "
             f"{timer.calls}")
    mla = len(MLA_PROFILE_X) * (1 + 2 * timer.repeats)
    if wide != mla:
        fail(f"profile: {wide} decode launches at D "
             f"{MLA_DECODE_AXES[1]}, expected {mla} from the MLA samples "
             f"{MLA_DECODE_AXES}")
    say("profile", f"{sum(len(xs) for _, _, xs in keys)} samples of "
        f"{len(keys)} tables in {secs:.1f} s (each sample one warm-up and "
        f"2 x {timer.repeats} timed calls, L2 flushed before each timed "
        f"one) | calls {timer.calls} | launches decode_attention "
        f"{launched[1]} ({wide} on the D {MLA_DECODE_AXES[1]} instance) "
        f"flash_attention {launched[2]} ssd_scan {launched[3]} rmsnorm "
        f"{launched[0]}")
    done = {(op, axes) for op, axes, _ in keys}
    arch_keys = [(op, axes, ARCH_PROFILE_X) for op, axes in dict.fromkeys(
        k for arch in PROFILE_ARCHS for k in arch_tables(C.get_config(arch)))
        if (op, axes) not in done]
    arch_timer = MeasuredBackend(DEVICE, repeats=3)
    reset_counts()
    t0 = time.perf_counter()
    sample_tables(arch_timer, arch_keys, {})
    secs = time.perf_counter() - t0
    arch_launched = counts()
    if arch_launched != expected_launches(arch_timer):
        fail(f"profile: the other archs' tables launched {arch_launched}, "
             f"expected {expected_launches(arch_timer)} from the "
             f"profiler's calls {arch_timer.calls}")
    say("profile", f"{', '.join(PROFILE_ARCHS)}: {len(arch_keys)} more "
        f"tables, {len(arch_keys) * len(ARCH_PROFILE_X)} samples in "
        f"{secs:.1f} s | calls {arch_timer.calls} | launches "
        f"decode_attention {arch_launched[1]} flash_attention "
        f"{arch_launched[2]} ssd_scan {arch_launched[3]} rmsnorm "
        f"{arch_launched[0]}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {
        ("decode_attention", PROFILE_DECODE, "bfloat16"): attention_case(
            torch, F, PROFILE_DECODE, [PROFILE_DECODE[-1]], "bfloat16",
            gen),
        ("decode_attention", PROFILE_MLA_DECODE, "bfloat16"):
            attention_case(torch, F, PROFILE_MLA_DECODE,
                           [PROFILE_MLA_DECODE[-1]], "bfloat16", gen),
        (PROFILE_FLASH, "bfloat16"): flash_case(torch, F, PROFILE_FLASH,
                                                "bfloat16", gen),
        ("ssd_scan", PROFILE_SSD, "bfloat16"): ssd_case(
            torch, PROFILE_SSD, "bfloat16", gen),
        ("decode_attention", PROFILE_ARCHS_DECODE, "bfloat16"):
            attention_case(torch, F, PROFILE_ARCHS_DECODE,
                           [PROFILE_ARCHS_DECODE[-1]], "bfloat16", gen),
        (PROFILE_ARCHS_FLASH, "bfloat16"): flash_case(
            torch, F, PROFILE_ARCHS_FLASH, "bfloat16", gen),
        ("ssd_scan", PROFILE_ARCHS_SSD, "bfloat16"): ssd_case(
            torch, PROFILE_ARCHS_SSD, "bfloat16", gen)}
    # fp32, ragged lengths over a batch of 3
    attention_case(torch, F, (3, *PROFILE_MLA_DECODE[1:]),
                   [1, 1000, 4096], "float32", gen, timed=False)
    return (*launched, wide, *arch_launched), results, samples


# -- predict ------------------------------------------------------------------

PREDICT_CAP = 4          # the serve phase's slots


def predict_phase(report, reqs, samples: dict, smi: str) -> None:
    """The serve phase's engine run (``report`` of ``reqs``, all at t=0)
    as the port's ``PlanSimulator`` predicts it on ``h100_node(1)``
    (``launch.fig6.predictions``: the heuristic plan in bf16, a batch cap
    of ``PREDICT_CAP``), on the profile phase's ``samples`` read on each
    clock, and on the analytic tables: total, TTFT and TPOT means beside
    the engine's.  Printed, not held; fails if a table would be timed
    again (a key the profile phase did not sample) or a prediction is
    infeasible or not finite."""
    from repro_torch import configs as C
    from repro_torch.core import AnalyticBackend, h100_node
    from repro_torch.core.profiles import TorchMeasuredBackend
    from repro_torch.launch.fig6 import predictions
    t0 = time.perf_counter()
    wall = TorchMeasuredBackend("wall", device=DEVICE)
    wall.samples = dict(samples)
    backends = {"wall": wall, "device": wall.sibling("device"),
                "analytic": AnalyticBackend(h100_node(1))}
    model = C.get_config("qwen2-0.5b").to_ir()
    got = {name: predictions(
        model, b, reqs, (PREDICT_CAP,),
        None if name == "analytic" else PROFILE_X_MAX)[PREDICT_CAP]
        for name, b in backends.items()}
    secs = time.perf_counter() - t0
    if sum(wall.timer.calls.values()) or len(wall.samples) != len(samples):
        fail(f"predict: the prediction timed {wall.timer.calls} calls "
             f"({len(wall.samples) - len(samples)} samples the profile "
             f"phase did not take)")
    for name, rep in got.items():
        if not (rep.feasible and all(math.isfinite(v) for v in (
                rep.e2e_latency, rep.ttft_mean, rep.tpot_mean))):
            fail(f"predict: the {name} prediction is infeasible or not "
                 f"finite: {rep}")

    def row(name, total, ttft, tpot):
        return (f"{name} {total:.4f} s / {ttft * 1e3:.2f} ms / "
                f"{tpot * 1e3:.3f} ms")

    say("predict", f"qwen2-0.5b FULL, {len(reqs)} requests at t=0, cap "
        f"{PREDICT_CAP}, plan {got['wall'].plan_label} on h100_node(1), "
        f"engine on {smi}; total / TTFT mean / TPOT mean: "
        + row("engine", report.total_time, report.ttft_mean,
              report.tpot_mean) + " | "
        + " | ".join(
            row(name, rep.e2e_latency, rep.ttft_mean, rep.tpot_mean)
            + f" (total {rep.e2e_latency / report.total_time - 1:+.1%})"
            for name, rep in got.items())
        + f" | {got['wall'].iterations} simulated iterations, the "
        f"engine's {report.iterations} and "
        f"{sum(len(r['prompt']) for r in reqs)} prompt-replay steps; "
        f"{len(samples)} profiled samples, none timed again; "
        f"{secs:.2f} s")


# -- plan-modes ---------------------------------------------------------------

# qwen2-0.5b FULL on h100_node(PLAN_DEVICES): at TP 2 its ops take keys
# the profile phase did not sample (decode attention over 1 KV head,
# prefill over 7 heads, the sharded GEMMs), timed here on first use
PLAN_DEVICES = 2
# the dynamic search's trace: chat at two levels of load, as
# tests/test_dynamic.py builds its non-stationary trace
PLAN_DYNAMIC = dict(num_requests=60, seed=3, starts=(0.0, 1.0),
                    rates=(30.0, 60.0))
PLAN_DYNAMIC_SLO = dict(slo_ttft_s=0.5, slo_tpot_s=0.2)
# the kernels' cases at the new tables' largest x: decode (B, Hq, Hkv, D,
# Smax) over 4096 KV tokens of one KV head; flash causal at S 90 (area
# 4095) over 7 heads
PLAN_DECODE = (1, 1, 1, 64, 4096)
# its 64 outputs a draw: the share not bit-equal is held over 32 draws
PLAN_DECODE_DRAWS = 32
PLAN_FLASH = (1, 90, 90, 7, 7, 64, None, 0)


def finite_report(what: str, rep) -> str:
    """``rep``'s e2e, TTFT p95 and TPOT p95; fails unless it is feasible
    and all three are finite."""
    vals = (rep.e2e_latency, rep.ttft_p95, rep.tpot_p95)
    if not (rep.feasible and all(math.isfinite(v) for v in vals)):
        fail(f"plan-modes: {what} {rep.plan_label} is infeasible or not "
             f"finite: e2e {vals[0]} TTFT p95 {vals[1]} TPOT p95 {vals[2]}")
    return (f"{rep.plan_label} e2e {vals[0]:.6f} s TTFT p95 "
            f"{vals[1] * 1e3:.4f} ms TPOT p95 {vals[2] * 1e3:.4f} ms")


def plan_modes_phase(torch, F, samples: dict, smi: str):
    """The simulator's search modes on the H100's own op tables:
    qwen2-0.5b FULL on ``h100_node(PLAN_DEVICES)``, priced by a
    ``TorchMeasuredBackend`` on the device clock seeded with the profile
    phase's ``samples`` (the store capped at ``PROFILE_X_MAX``), over
    ``launch.serve``'s search trace, in this process (``jobs=1``): the
    joint colocated + disaggregated search, the multi-fidelity search on
    the same trace, and the dynamic search over two switching timetables
    on a two-level trace.  Fails if a search raises, a best plan's report
    is infeasible or not finite, a sample timed here is below its bound,
    or the decode and flash kernels did not launch once per profiled
    call.  Then both kernels against their plain versions at the new
    tables' largest shapes.  Returns the launches and those cases."""
    from repro_torch import configs as C
    from repro_torch.core import (ApexSearch, DynamicSpec, EpochSchedule,
                                  MultiFidelitySearch, PiecewiseRate,
                                  get_trace, h100_node)
    from repro_torch.core.profiles import TorchMeasuredBackend
    from repro_torch.core.search import OBJECTIVES
    from repro_torch.launch.serve import SEARCH_RATE, SEARCH_REQUESTS
    t0 = time.perf_counter()
    backend = TorchMeasuredBackend("device", device=DEVICE)
    backend.samples = dict(samples)
    model = C.get_config("qwen2-0.5b").to_ir()
    search = ApexSearch(model, h100_node(PLAN_DEVICES), backend=backend)
    search.store.x_max = PROFILE_X_MAX
    reqs = get_trace("chat", arrival_rate=SEARCH_RATE,
                     num_requests=SEARCH_REQUESTS)
    opts = dict(quant="bf16", feasible_only=True, disaggregated=True,
                jobs=1)
    where = (f"qwen2-0.5b FULL on h100_node({PLAN_DEVICES}), bf16, "
             f"tables timed on {smi} (device clock)")
    reset_counts()
    exact = search.search(reqs, **opts)
    mf = MultiFidelitySearch(search).search(reqs, **opts)
    dyn_reqs = get_trace("chat", num_requests=PLAN_DYNAMIC["num_requests"],
                         seed=PLAN_DYNAMIC["seed"],
                         arrival_rate=PiecewiseRate(
                             starts=PLAN_DYNAMIC["starts"],
                             rates=PLAN_DYNAMIC["rates"]))
    flip = PLAN_DYNAMIC["starts"][1]
    spec = DynamicSpec(top_k=2, mechanism="drain", schedules=(
        EpochSchedule(epochs=((0.0, 0), (flip, 1))),
        EpochSchedule(epochs=((0.0, 1), (flip, 0)))))
    dyn = search.search(dyn_reqs, objective="goodput", dynamic=spec,
                        **PLAN_DYNAMIC_SLO, **opts)
    launched = counts()
    if launched != expected_launches(backend.timer):
        fail(f"plan-modes: launches {launched}, expected "
             f"{expected_launches(backend.timer)} from the profiler's "
             f"calls {backend.timer.calls}")
    new = {}
    for (op, axes, x), (wall, dev) in backend.samples.items():
        if (op, axes, x) not in samples:
            new.setdefault((op, axes), []).append(
                sample_text("plan-modes", op, axes, x, wall, dev))
    for (op, axes), readings in new.items():
        say("plan-modes", f"op table {op} {axes}: " + "; ".join(readings))
    say("plan-modes", f"{sum(map(len, new.values()))} samples of "
        f"{len(new)} tables timed here (beside the profile phase's "
        f"{len(samples)}) | calls {backend.timer.calls} | "
        f"launches decode_attention {launched[1]} flash_attention "
        f"{launched[2]} ssd_scan {launched[3]} rmsnorm {launched[0]}")

    key = OBJECTIVES[exact.objective]
    disagg = [r for r in exact.all_reports
              if r.plan_label.startswith("disagg[")]
    admitted = [r for r in disagg if exact.admissible(r)]
    if not admitted:
        fail(f"plan-modes: no feasible disaggregated plan among "
             f"{len(disagg)} priced")
    best_disagg = min(admitted, key=key)
    say("plan-modes", f"search(disaggregated=True, feasible_only=True) "
        f"{where}, chat {SEARCH_RATE} req/s x {SEARCH_REQUESTS}: "
        f"{exact.num_schemes - len(disagg)} colocated and {len(disagg)} "
        f"disaggregated plans priced ({exact.num_feasible} feasible) in "
        f"{exact.search_seconds:.2f} s | best "
        + finite_report("the best plan", exact.best)
        + " | best disaggregated "
        + finite_report("the best disaggregated plan", best_disagg)
        + f" ({exact.objective} {key(best_disagg):.9g} against "
        f"{key(exact.best):.9g}: disaggregated "
        f"{'wins' if key(best_disagg) < key(exact.best) else 'loses'})")

    frontier = [mf.surrogate_reports[i].plan_label
                for i in mf.survivor_indices]
    rungs = "; ".join(f"{r.fraction:.0%} of the trace ({r.n_requests} "
                      f"requests) {r.evaluated} -> {r.promoted}"
                      for r in mf.rungs) or "none"
    say("plan-modes", f"MultiFidelitySearch on the same trace: "
        f"{mf.num_candidates} candidates screened by the fluid surrogate "
        f"in {mf.screen_seconds:.3f} s, {mf.screen_survivors} survived "
        f"screening; rungs: {rungs}; frontier {frontier} confirmed "
        f"exactly in {mf.confirm_seconds:.3f} s | winner "
        + finite_report("the multi-fidelity winner", mf.best)
        + f" | equals the exact search's: "
        f"{mf.best.plan_label == exact.best.plan_label} "
        f"({exact.objective} {key(mf.best):.9g} against "
        f"{key(exact.best):.9g})")

    switching = [r for r in dyn.all_reports if r.reconfig is not None]
    if len(switching) != len(spec.schedules):
        fail(f"plan-modes: {len(switching)} switching timetables priced, "
             f"expected {len(spec.schedules)}")
    static = max((r for r in dyn.all_reports
                  if r.reconfig is None and dyn.admissible(r)),
                 key=lambda r: r.goodput_rps)
    say("plan-modes", f"search(dynamic=DynamicSpec(top_k=2, drain)) on "
        f"chat at {PLAN_DYNAMIC['rates'][0]:g} then "
        f"{PLAN_DYNAMIC['rates'][1]:g} req/s from t={flip:g} s "
        f"({len(dyn_reqs)} requests), goodput under TTFT p95 <= "
        f"{PLAN_DYNAMIC_SLO['slo_ttft_s']} s and TPOT p95 <= "
        f"{PLAN_DYNAMIC_SLO['slo_tpot_s']} s, {dyn.num_schemes} plans "
        f"and timetables in {dyn.search_seconds:.2f} s: "
        + "; ".join(f"{r.plan_label} goodput {r.goodput_rps:.4f} req/s "
                    f"({r.reconfig.num_switches} switch, reshard "
                    f"{r.reconfig.total_reshard_s * 1e3:.3f} ms)"
                    for r in switching)
        + f" | best static {static.plan_label} goodput "
        f"{static.goodput_rps:.4f} req/s | winner "
        + finite_report("the dynamic search's winner", dyn.best)
        + f" goodput {dyn.best.goodput_rps:.4f} req/s; a switching "
        f"timetable won: {dyn.best.reconfig is not None}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {
        ("decode_attention", PLAN_DECODE, "bfloat16"): attention_case(
            torch, F, PLAN_DECODE, [PLAN_DECODE[-1]], "bfloat16", gen,
            draws=PLAN_DECODE_DRAWS),
        (PLAN_FLASH, "bfloat16"): flash_case(torch, F, PLAN_FLASH,
                                             "bfloat16", gen)}
    say("plan-modes", f"phase {time.perf_counter() - t0:.1f} s")
    return launched, results


# -- 6. flash -----------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, window, q_offset)
FLASH_MAIN = (4, 1024, 1024, 14, 2, 64, None, 0)   # qwen2-0.5b training
# gemma3-12b's training microbatch (4 x 2048): its local layers (window
# 1024) and its global one
GEMMA_FLASH = ((4, 2048, 2048, 16, 8, 256, 1024, 0),
               (4, 2048, 2048, 16, 8, 256, None, 0))
FLASH_CASES = (
    FLASH_MAIN,
    (2, 1024, 1024, 16, 8, 128, None, 0),          # internlm2-1.8b heads
    (1, 257, 257, 2, 1, 16, None, 0),              # ragged length
    (2, 300, 300, 8, 2, 32, 37, 0),                # sliding window 37
    (2, 100, 357, 14, 2, 64, None, 257),           # prefix: Sq < Skv
    *GEMMA_FLASH,                                  # gemma3-12b training
)
# without the causal mask: seamless-m4t-large-v2's encoder over 1024
# frames (Sq = Skv), its cross-attention from 256 decoder rows to 1024
# frames (Sq != Skv), and a source of 1000 frames, which ends inside a
# 64-key tile; qwen2-vl-7b's causal training microbatch
SEAMLESS_ENCODE = (4, 1024, 1024, 16, 16, 64, None, 0)
NONCAUSAL_CASES = (SEAMLESS_ENCODE, (4, 256, 1024, 16, 16, 64, None, 0),
                   (4, 256, 1000, 16, 16, 64, None, 0))
# causal: qwen2-vl-7b's training microbatch, seamless's decoder
# self-attention in training
QWEN_VL_FLASH = (4, 1024, 1024, 28, 4, 128, None, 0)
SEAMLESS_SELF = (4, 1024, 1024, 16, 16, 64, None, 0)
# zamba2-7b's shared block in training (D 112, padded to 128)
ZAMBA_FLASH = (4, 1024, 1024, 32, 32, 112, None, 0)
FLASH_CASES = FLASH_CASES + (QWEN_VL_FLASH, SEAMLESS_SELF, ZAMBA_FLASH)
# deepseek-v2-lite-16b's MLA in training: q/k 192, v 128 (both padded to
# 256 by the wrapper)
DEEPSEEK_FLASH = (4, 1024, 1024, 16, 16, 192, None, 0)
DEEPSEEK_FLASH_DV = 128


def flash_inputs(torch, case, dt, gen, dv=None):
    B, Sq, Skv, Hq, Hkv, D, _, _ = case
    q = torch.randn(B, Sq, Hq, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, Skv, Hkv, dv or D, generator=gen,
                    device="cuda").to(dt)
    return q, k, v


def flash_case(torch, F, case, dtype_name, gen, timed: bool = True,
               dv=None, causal: bool = True) -> dict:
    """One flash-attention case; ``dv``: v's head dim where it is not D
    (MLA, which the wrapper pads to the width of q and k; its time
    includes those copies); ``causal=False``: no causal mask (the
    encoder's and cross-attention's call)."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, Hq, Hkv, D, window, q_offset = case
    dt = getattr(torch, dtype_name)
    q, k, v = flash_inputs(torch, case, dt, gen, dv)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, **kw)
    what = (f"flash_attention {case}{f' Dv {dv}' if dv else ''}"
            f"{'' if causal else ' non-causal'} {dtype_name}")
    err, differ = compare(torch, out, want_out, dtype_name, what)
    lse_err, _ = compare(torch, lse, want_lse, "float32", what + " lse")
    if not timed:
        return dict(max_abs_err=max(err, lse_err))
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), inner=5,
                 reps=11)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                               **kw),
                       inner=2, reps=5)
    # yardstick: SDPA in its (B, H, S, D) layout, GQA without repeat
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = fa.attention_mask(Sq, Skv, causal=causal, window=window,
                             q_offset=q_offset, device="cuda")
    if not causal and window is None:
        sdpa = {}
    elif window is None and q_offset == 0 and Sq == Skv:
        sdpa = dict(is_causal=True)
    else:
        sdpa = dict(attn_mask=mask)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, enable_gqa=True, **sdpa), inner=5, reps=11)
    del qs, ks, vs
    alone = ""
    width = fa.padded_head_dim(max(D, v.shape[-1]))
    if width != D or width != v.shape[-1]:
        qp, kp, vp = (F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))
        kernel_ms = time_ms(torch, lambda: fa._launch(
            qp, kp, vp, scale=1.0 / math.sqrt(D), **kw), inner=5, reps=11)
        alone = (f" (padded to {width} in the wrapper; the kernel alone on "
                 f"inputs padded beforehand {kernel_ms:.4f} ms, so the "
                 f"padding copies {ms - kernel_ms:.4f} ms)")
        del qp, kp, vp
    (gx, gy), threads = fa.grid(q)
    pairs = int(mask.sum())
    es = q.element_size()
    nbytes = ((q.numel() + k.numel() + v.numel() + out.numel()) * es
              + 4 * lse.numel())
    flops = 2.0 * (D + v.shape[-1]) * pairs * B * Hq
    peak = BF16_FLOPS if dtype_name == "bfloat16" else FP32_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = ((t_ops, "operations") if t_ops >= t_bytes
                          else (t_bytes, "bytes"))
    say("flash", f"q {(B, Sq, Hq, D)} k/v {(B, Skv, Hkv, D)}"
        f"{f' v Dv {dv}' if dv else ''} "
        f"{'causal' if causal else 'non-causal'} window "
        f"{window} q_offset {q_offset} {dtype_name}: max_abs_err out "
        f"{err:.3e} ({tol_text(dtype_name)}), not bit-equal {differ:.2e}, "
        f"lse {lse_err:.3e} ({tol_text('float32')}) | kernel {ms:.4f} ms"
        f"{alone} plain {plain_ms:.4f} ms library(SDPA) {library_ms:.4f} ms "
        f"bound "
        f"{bound_ms:.5f} ms ({bound_by}: {flops:.4g} FLOP at "
        f"{peak / 1e12:.0f} TFLOP/s, {nbytes} B) | "
        f"{flops / ms / 1e9:.1f} TFLOP/s, grid {gx}x{gy} blocks of "
        f"{threads} threads")
    return dict(max_abs_err=max(err, lse_err), differ=differ, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def flash_phase(torch, F) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype_name in ("float32", "bfloat16"):
        for case in FLASH_CASES:
            results[(case, dtype_name)] = flash_case(torch, F, case,
                                                     dtype_name, gen)
        for case in NONCAUSAL_CASES:
            results[(case, "non-causal", dtype_name)] = flash_case(
                torch, F, case, dtype_name, gen, causal=False)
        results[(DEEPSEEK_FLASH, "mla", dtype_name)] = flash_case(
            torch, F, DEEPSEEK_FLASH, dtype_name, gen, dv=DEEPSEEK_FLASH_DV)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype_name in ("float32", "bfloat16"):
        for D in (16, 32, 64, 128, 256):
            for group in (1, 2, 3, 8):
                for window, q_offset in ((None, 0), (19, 5)):
                    case = (2, 77, 77 + q_offset, 2 * group, 2, D, window,
                            q_offset)
                    r = flash_case(torch, F, case, dtype_name, gen,
                                   timed=False)
                    worst[dtype_name] = max(worst[dtype_name],
                                            r["max_abs_err"])
                    n += 1
    say("flash", f"sweep: {n} cases (D 16/32/64/128/256, group 1/2/3/8, "
        f"Sq 77, causal and window 19 with q_offset 5, fp32 and bf16) all "
        f"within tolerance, worst max_abs_err fp32 {worst['float32']:.3e} "
        f"bf16 {worst['bfloat16']:.3e}")
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype_name in ("float32", "bfloat16"):
        for D in (16, 32, 64, 128, 256):
            for group in (1, 7):
                for sq, skv in ((77, 200), (130, 64), (200, 77)):
                    r = flash_case(torch, F, (2, sq, skv, 2 * group, 2, D,
                                              None, 0), dtype_name, gen,
                                   timed=False, causal=False)
                    worst[dtype_name] = max(worst[dtype_name],
                                            r["max_abs_err"])
                    n += 1
    say("flash", f"non-causal sweep: {n} cases (D 16/32/64/128/256, group "
        f"1/7, Sq x Skv 77 x 200, 130 x 64, 200 x 77, fp32 and bf16; out "
        f"and lse) all within tolerance, worst max_abs_err fp32 "
        f"{worst['float32']:.3e} bf16 {worst['bfloat16']:.3e}")
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype_name in ("float32", "bfloat16"):
        for D in PADDED_FLASH_DIMS:
            for group in (1, 7):
                for window, q_offset in ((None, 0), (19, 5)):
                    case = (2, 77, 77 + q_offset, 2 * group, 2, D, window,
                            q_offset)
                    r = flash_case(torch, F, case, dtype_name, gen,
                                   timed=False)
                    worst[dtype_name] = max(worst[dtype_name],
                                            r["max_abs_err"])
                    n += 1
    say("flash", f"padded head dims: {n} cases (D "
        f"{'/'.join(map(str, PADDED_FLASH_DIMS))} zero-padded to 16, 32, "
        f"128 and 256, group 1/7, Sq 77, causal and window 19 with q_offset "
        f"5, fp32 and bf16; out and lse) all within tolerance, worst "
        f"max_abs_err fp32 {worst['float32']:.3e} bf16 "
        f"{worst['bfloat16']:.3e}")
    return results


# -- 7. train -----------------------------------------------------------------

TRAIN = dict(arch="qwen2-0.5b", steps=5, batch=8, seq=1024, microbatches=2)
KERNEL_NAMES = ("rmsnorm", "decode_attention", "flash_attention", "ssd_scan")


def layer_runs(cfg):
    """How often one train step with remat runs each layer slot of a
    block, per block and microbatch: once forward, and in the backward
    again for the block's checkpoint and, in a block of several layers,
    for the layer's own (``models.transformer.forward``'s nested remat).
    The block's recomputation stops once it has what the block's
    backward needs, the last layer's input (torch.utils.checkpoint's
    early stop), so the last slot runs twice and the others three times:
    3n - 1 layer runs a block of n > 1 layers, 2 a block of one.  A
    shared block (zamba2) ends every block and is not checkpointed on
    its own: the recomputation runs through it, so every slot of a
    nested block runs three times."""
    n = len(cfg.block_pattern)
    last = 3 if cfg.shared_attn and n > 1 else 2
    return [3 if i < n - 1 else last for i in range(n)]


def train_launches_per_step(cfg, microbatches: int):
    """(rmsnorm, decode_attention, flash_attention, ssd_scan) launches of
    one train step with remat: per microbatch, for every layer run
    (``layer_runs``) two RMSNorms (norm1 and norm2 of a decoder layer,
    norm1 and the gated norm of a Mamba2 mixer) and one flash attention
    or SSD scan, with cross-attention a third RMSNorm (``norm_x``) and a
    second flash attention (no mask), and the final norm; an encoder's
    layers, each checkpointed, run twice: ``encode_launches`` plus two
    RMSNorms and one flash attention a layer again; a shared block runs
    twice a block (forward, and the block's recomputation), two
    RMSNorms and one flash attention each time.  The backward passes
    are plain PyTorch and launch nothing."""
    runs = {"attn": 0, "ssm": 0}           # per microbatch
    # prefix blocks (deepseek's dense first layer) are never checkpointed
    R = cfg.block_repeat - cfg.first_k_dense
    for spec, n in zip(cfg.block_pattern, layer_runs(cfg)):
        runs[spec.kind] += n * R + cfg.first_k_dense
    x = runs["attn"] if cfg.cross_attn else 0
    if cfg.shared_attn:
        runs["attn"] += 2 * cfg.block_repeat
    rms, flash = 2 * sum(runs.values()) + 1 + x, runs["attn"] + x
    if cfg.encoder is not None:
        enc_rms, enc_flash = encode_launches(cfg)
        rms += enc_rms + 2 * cfg.encoder.n_layers
        flash += 2 * enc_flash
    return (rms * microbatches, 0, flash * microbatches,
            runs["ssm"] * microbatches)


def launch_text(per_step) -> str:
    return " ".join(f"{name} {n}" for name, n in zip(KERNEL_NAMES, per_step)
                    if n)


def train_phase(torch, smi: str, spec: dict = TRAIN, phase: str = "train"):
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.launch.train import train
    cfg = C.get_config(spec["arch"])
    cfg = dataclasses.replace(cfg, block_repeat=spec.get("depth")
                              or cfg.block_repeat)
    per_step = train_launches_per_step(cfg, spec["microbatches"])
    history = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    train(**spec, reduced=False, seed=0, device=DEVICE,
          log=lambda s: None, history=history)
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = tuple(n * spec["steps"] for n in per_step)
    if launched != want:
        fail(f"{phase}: launches {launched} in {spec['steps']} steps, "
             f"expected {want} ({per_step} per step)")
    for h in history:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"{phase}: non-finite metrics {h}")
    if len(history) != spec["steps"]:
        fail(f"{phase}: {len(history)} steps ran")
    step_s = statistics.mean(h["seconds"] for h in history[1:])
    tokens = spec["batch"] * spec["seq"]
    say(phase, f"{spec['arch']} FULL ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}) bf16 on {smi}: "
        f"{spec['steps']} steps of {spec['batch']}x{spec['seq']} tokens, "
        f"{spec['microbatches']} microbatches, remat | loss "
        + " ".join(f"{h['loss']:.4f}" for h in history) + " | grad norm "
        + " ".join(f"{h['grad_norm']:.4f}" for h in history)
        + " | step ms " + " ".join(f"{h['seconds'] * 1e3:.1f}"
                                    for h in history)
        + f" | {step_s * 1e3:.1f} ms/step after the first, "
        f"{tokens / step_s:.0f} tokens/s, peak memory {peak_gb:.2f} GiB | "
        f"launches/step {launch_text(per_step)}")
    return launched


def train_parity(torch, dtype_name: str, seed: int = 0,
                 profile: bool = False, spec: dict = TRAIN,
                 depth=None, reduced: bool = False,
                 anchor: bool = False) -> dict:
    """One train step of ``spec``'s arch at FULL width (and ``depth``
    blocks, if given) from the same weights and batch through the plain
    versions and then through the kernels, the kernel run taking the
    plain run's MoE routes (``replayed_routes``; every recomputation of
    a checkpoint routes again, in the same order in both runs); returns
    |loss difference|, relative grad-norm difference, and the L2 norm of
    the difference of the updated fp32 masters relative to the L2 norm
    of the plain run's update (both over every leaf).  The starting
    weights and the plain run's masters wait in host memory, so the card
    holds one run's weights and optimizer state at a time (gemma3-12b's
    block: 2.35 B parameters).  With ``anchor`` (bf16), one more step
    through the plain versions in fp32 from the starting weights upcast,
    on the same batch and routes (``fp32_anchor``), and ``anchor`` holds
    the distances of both bf16 runs' updated masters and gradient trees
    from its (``tree_distance``; both runs' trees wait in host memory)."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import stub_inputs
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import adamw_init
    cfg = (C.get_reduced if reduced else C.get_config)(spec["arch"])
    cfg = dataclasses.replace(cfg, dtype=dtype_name,
                              block_repeat=depth or cfg.block_repeat)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = (ED.init_encdec_params if cfg.encoder is not None
              else T.init_params)(gen, cfg, device=DEVICE)
    start = {n: p.detach().to("cpu", copy=True)
             for n, p in params.named_parameters()}
    batch = {k: t.to(DEVICE) for k, t in TokenPipeline(
        cfg.vocab_size, spec["seq"], spec["batch"],
        seed=seed).global_batch_at(0).items()}
    batch.update(stub_inputs(cfg, spec["batch"], spec["seq"], 0, seed,
                             DEVICE))
    step = make_train_step(cfg, microbatches=spec["microbatches"],
                           remat=True)
    runs = []
    log, routes = [], [0, 0]
    kept = {}
    for plain in (True, False):
        with torch.no_grad():
            for n, p in params.named_parameters():
                p.copy_(start[n])
        opt = None
        opt = adamw_init(params)
        reset_counts()
        grads = {}
        with (contextlib.ExitStack() if not plain else plain_kernels()), \
                (recorded_routes(log) if plain
                 else replayed_routes(log, routes)), \
                (recorded_grads(grads) if anchor
                 else contextlib.nullcontext()):
            _, opt, metrics = step(params, opt, batch)
        sync(torch)
        if plain and counts() != (0, 0, 0, 0):
            fail("train parity: the plain run launched a kernel")
        if not plain:
            launched = counts()
        master = opt.master if not (plain or anchor) else {
            n: t.cpu() for n, t in opt.master.items()}
        runs.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     master))
        if anchor:
            kept["plain" if plain else "kern"] = (
                master, {n: t.cpu() for n, t in grads.items()})
        del metrics, grads, master
    (loss_p, gnorm_p, master_p), (loss_k, gnorm_k, master_k) = runs
    diff_sq = upd_sq = 0.0
    for n in master_k:
        mp = master_p[n].to(DEVICE)
        diff_sq += float((master_k[n].to(DEVICE) - mp).square().sum())
        upd_sq += float((mp - start[n].to(DEVICE).float()).square().sum())
    del opt, runs, master_k, master_p
    torch.cuda.empty_cache()
    if profile:
        profile_train_step(torch, step, params, adamw_init(params), batch,
                           f"{spec['arch']} FULL width, {cfg.n_layers} "
                           f"layers, bf16 train step ({spec['batch']}x"
                           f"{spec['seq']} tokens, {spec['microbatches']} "
                           f"microbatches, remat)")
    anchored = None
    if anchor:
        def run(cfg32):
            with torch.no_grad():
                for n, p in params.named_parameters():
                    p.copy_(start[n])
            step32 = make_train_step(cfg32, microbatches=spec["microbatches"],
                                     remat=True)
            grads = {}
            with replayed_routes(log, [0, 0]), recorded_grads(grads):
                _, opt, _ = step32(params, adamw_init(params), batch)
            return opt.master, grads

        master_a, grads_a = fp32_anchor(torch, params, cfg, run)
        # each distance over the anchor's update, or its gradient's norm
        scales = (tree_distance(torch, start, master_a),
                  tree_distance(torch, {n: g.new_zeros(()) for n, g in
                                        grads_a.items()}, grads_a))
        anchored = {}
        for i, (what, ref) in enumerate((("master", master_a),
                                         ("grad", grads_a))):
            d_plain, d_kern = (tree_distance(torch, kept[n][i], ref)
                               / scales[i] for n in ("plain", "kern"))
            if not (d_plain > 0 and math.isfinite(d_plain)):
                fail(f"train anchor: {what} d_plain {d_plain}")
            anchored[what] = dict(d_plain=d_plain, d_kern=d_kern,
                                  ratio=d_kern / d_plain)
        del master_a, grads_a, kept
    del params, start, log
    torch.cuda.empty_cache()
    master = math.sqrt(diff_sq / upd_sq)
    for v in (loss_k, loss_p, gnorm_k, gnorm_p, master):
        if not math.isfinite(v):
            fail(f"train parity {dtype_name}: non-finite reading")
    return dict(loss=abs(loss_k - loss_p), loss_k=loss_k, loss_p=loss_p,
                gnorm=abs(gnorm_k - gnorm_p) / gnorm_p, gnorm_k=gnorm_k,
                gnorm_p=gnorm_p, master=master, update=math.sqrt(upd_sq),
                launched=launched, routes=tuple(routes), anchor=anchored)


@contextlib.contextmanager
def recorded_grads(store: dict):
    """Put the gradient tree a train step hands AdamW
    (``launch.steps.adamw_update``) into ``store``, by parameter name."""
    from repro_torch.launch import steps
    update = steps.adamw_update

    def recording(params, grads, *args, **kwargs):
        store.update(grads)
        return update(params, grads, *args, **kwargs)

    with mock.patch.object(steps, "adamw_update", recording):
        yield store


def tree_distance(torch, a: dict, b: dict) -> float:
    """The L2 norm of ``a - b`` over two trees of tensors by name (on
    the host or the card), leaf by leaf on the card in fp64."""
    return math.sqrt(sum(
        float((a[n].to(DEVICE, torch.float64)
               - b[n].to(DEVICE, torch.float64)).square().sum())
        for n in b))


def parity_readings(r: dict, tol: dict) -> str:
    text = (f"loss {r['loss_k']:.6f} kernels vs {r['loss_p']:.6f} "
            f"plain (|diff| {r['loss']:.3e}, tol {tol['loss']}), "
            f"grad norm {r['gnorm_k']:.6f} vs {r['gnorm_p']:.6f} "
            f"(rel diff {r['gnorm']:.3e}, tol {tol['gnorm']}), "
            f"updated fp32 masters |diff| / |update| "
            f"{r['master']:.3e} (tol {tol['master']}; |update| "
            f"{r['update']:.3e})")
    if r.get("anchor"):
        text += ("; fp32 anchor, |run - anchor| plain / kernels (over the "
                 "anchor's update, its gradient's norm): " + ", ".join(
                     f"{what} {a['d_plain']:.4e} / {a['d_kern']:.4e} ratio "
                     f"{a['ratio']:.4f}" for what, a in r["anchor"].items()))
    return text


def train_parity_phase(torch, spec: dict = TRAIN, limits=None,
                       depth=None, phase: str = "train",
                       reduced: bool = False, unheld=()) -> None:
    """``train_parity`` in fp32 and bf16, held to ``limits`` (default
    TRAIN_TOL) but for the (dtype, reading) pairs of ``unheld``, which
    are printed and not held (zamba2's bf16 masters: PERF.md)."""
    limits = limits or TRAIN_TOL
    for dtype_name in ("float32", "bfloat16"):
        r = train_parity(torch, dtype_name, spec=spec, depth=depth,
                         reduced=reduced,
                         profile=dtype_name == "bfloat16" and not reduced)
        if r["launched"][0] == 0 or sum(r["launched"][2:]) == 0:
            fail(f"{phase} parity {dtype_name}: launches "
                 f"{r['launched']}, no RMSNorm or no mixer kernel")
        tol = limits[dtype_name]
        readings = parity_readings(r, tol)
        same, n = r["routes"]
        if n:
            readings += (f", MoE routes replayed from the plain run (the "
                         f"kernel run's own agree {same}/{n}, "
                         f"{same / n:.2%})")
        held = [key for key in tol if (dtype_name, key) not in unheld]
        if any(r[key] > tol[key] for key in held):
            fail(f"{phase} parity {dtype_name}: {readings}")
        if len(held) < len(tol):
            readings += (f" ({', '.join(k for k in tol if k not in held)} "
                         f"not held in {dtype_name})")
        shape = ("" if depth is None else
                 f" at full width and depth {depth}")
        if reduced:
            shape = (f" at REDUCED size ({launch_text(r['launched'])} "
                     f"launches)")
        say(phase, f"{spec['arch']} parity {dtype_name}{shape}, one step "
            f"from the same weights and batch: {readings}")


def profile_train_step(torch, step, params, opt, batch,
                       label: str = "qwen2-0.5b FULL bf16 train step "
                                    "(8x1024 tokens, 2 microbatches, remat)"
                       ) -> None:
    """Device time of one bf16 train step by kernel family, and the busy
    share (device kernel time / wall time of the profiled step)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(torch)
        t0 = time.perf_counter()
        step(params, opt, batch)
        sync(torch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"flash_attention": 0.0, "ssd_scan": 0.0, "rmsnorm": 0.0,
                "gemm": 0.0, "other": 0.0}
    n_kernels = 0
    per_kernel = []
    for e in prof.key_averages():
        if "cuda" not in str(e.device_type).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        n_kernels += e.count
        name = e.key.lower()
        fam = ("flash_attention" if "flash_attention" in name else
               "ssd_scan" if "ssd_scan" in name else
               "rmsnorm" if "rmsnorm" in name else
               "gemm" if any(w in name for w in GEMM_WORDS) else "other")
        families[fam] += us / 1e3
        per_kernel.append((us / 1e3, e.count, e.key))
    busy = sum(families.values())
    if busy <= 0:
        say("profile", f"train step wall {wall_ms:.1f} ms; device time not "
            f"measured (the profiler saw no device kernels)")
        return
    say("profile", f"{label}: wall {wall_ms:.1f} ms under the profiler, "
        f"device kernels {busy:.1f} ms ({n_kernels} launches, busy share "
        f"{busy / wall_ms:.1%}): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in families.items()))
    top = sorted(per_kernel, reverse=True)[:8]
    say("profile", "top kernels by device ms/step: " + "; ".join(
        f"{name[:60]} x{n} {ms:.2f} ms" for ms, n, name in top))


# -- 8. ssd -------------------------------------------------------------------

# (B, S, H, P, N, chunk)
SSD_MAIN = (4, 1024, 80, 64, 128, 128)       # mamba2-2.7b training microbatch
# zamba2-7b's training microbatch: head dim 112, which the wrapper runs as
# two panels of 64 (the second zero-padded); and a ragged length
ZAMBA_SSD = (4, 1024, 64, 112, 64, 128)
ZAMBA_SSD_CASES = (ZAMBA_SSD, (4, 1000, 64, 112, 64, 128))


def ssd_inputs(torch, case, dt, gen):
    """x, dt, a_log, b, c as the model makes them: dt softplus-activated
    in fp32, a_log = log(linspace(1, 16, H)) as ``init_mamba2`` sets it."""
    B, S, H, P, N, _ = case
    x = (0.5 * torch.randn(B, S, H, P, generator=gen, device="cuda")).to(dt)
    dtv = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device="cuda"))
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))
    b = (0.3 * torch.randn(B, S, N, generator=gen, device="cuda")).to(dt)
    c = (0.3 * torch.randn(B, S, N, generator=gen, device="cuda")).to(dt)
    return x, dtv, a_log, b, c


def ssd_work(case, dtype_name: str):
    """(bytes, FLOPs, bound ms, bound by) of the scan on ``case``: each
    input read once and y written once; the least work is C B^T on the
    lower triangle once per (b, chunk), the intra-chunk product on the
    lower triangle, C h^T and the state update per (b, h, chunk)."""
    B, S, H, P, N, chunk = case
    Q = min(chunk, S)
    n_chunks = -(-S // Q)
    es = 4 if dtype_name == "float32" else 2
    nbytes = (2 * B * S * H * P * es + 4 * B * S * H + 4 * H
              + 2 * B * S * N * es)
    tri = Q * (Q + 1) // 2
    flops = B * n_chunks * (2.0 * N * tri
                            + H * (2.0 * P * tri + 4.0 * Q * P * N))
    peak = BF16_FLOPS if dtype_name == "bfloat16" else FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (nbytes, flops) + ((t_ops, "operations") if t_ops >= t_bytes
                              else (t_bytes, "bytes"))


def ssd_kernels(torch, ssd, case, dtype_name):
    """The kernels that take ``case``: the wrapper's pick first, then the
    CUDA-core kernel where that is not it (it takes every case)."""
    dt = getattr(torch, dtype_name)
    picked = ssd.variant(dt, dt, case[3], case[4], case[5])
    return (picked,) if picked == "cuda_cores" else (picked, "cuda_cores")


def ssd_case(torch, case, dtype_name, gen, timed: bool = True,
             kernel=None) -> dict:
    """One SSD case on ``kernel`` (the wrapper's pick unless given).
    Timed in bf16 on the tensor-core kernel, the CUDA-core kernel is timed
    in the same call on the same inputs, in turns (old, new, new, old)."""
    from repro_torch.kernels import ssd_scan as ssd
    chunk = case[-1]
    args = ssd_inputs(torch, case, getattr(torch, dtype_name), gen)
    ssd.check_kernel_args(*args, chunk)
    kernel = kernel or ssd.variant(args[0].dtype, args[3].dtype, case[3],
                                   case[4], chunk)
    got = ssd._launch(*args, chunk, kernel=kernel)
    torch.cuda.synchronize()
    what = f"ssd_scan {case} {dtype_name} ({kernel} kernel)"
    err, differ = compare(torch, got, ssd.ssd_scan_plain(*args, chunk=chunk),
                          dtype_name, what)
    if not timed:
        return dict(max_abs_err=err, differ=differ)
    seq = ""
    if (dtype_name == "float32" and case == SSD_MAIN) or \
            case in ZAMBA_SSD_CASES:
        want = ssd.ssd_scan_sequential(*args)
        tol = SEQ_TOL if dtype_name == "float32" else SEQ_TOL_BF16
        # no DIFFER_MAX here: the chunked and step-by-step fp32 sums round
        # to bf16 apart more often than two kernels of one algorithm do
        seq_err, _ = compare(torch, got, want, "float32",
                             what + " vs the sequential recurrence", tol)
        seq = (f", vs the sequential recurrence {seq_err:.3e} (rtol "
               f"{tol['rtol']:.4g} atol {tol['atol']}, max|y| "
               f"{float(want.float().abs().max()):.3g})")
    def run(k):
        return time_ms(torch, lambda: ssd._launch(*args, chunk, kernel=k),
                       inner=5, reps=11)

    old = ""
    if kernel == "cuda_cores":
        ms = run(kernel)
    else:
        old_ms = [run("cuda_cores")]
        new_ms = [run(kernel), run(kernel)]
        old_ms.append(run("cuda_cores"))
        ms = statistics.median(new_ms)
        old_err, _ = compare(torch, ssd._launch(*args, chunk,
                                                kernel="cuda_cores"),
                             ssd.ssd_scan_plain(*args, chunk=chunk),
                             dtype_name, what + " on the cuda_cores kernel")
        old = (f" | in turns cuda_cores / {kernel} / {kernel} / cuda_cores "
               f"{old_ms[0]:.4f} / {new_ms[0]:.4f} / {new_ms[1]:.4f} / "
               f"{old_ms[1]:.4f} ms (cuda_cores max_abs_err "
               f"{old_err:.3e}), {statistics.mean(old_ms) / ms:.1f}x")
    if case[3] > ssd.PANEL_P:
        split = ssd.split_panels(*args[:3]) + args[3:]
        kernel_ms = time_ms(
            torch, lambda: ssd._launch(*split, chunk, kernel=kernel),
            inner=5, reps=11)
        old += (f" | the kernel alone on panels split beforehand "
                f"{kernel_ms:.4f} ms, so the pad and slice copies "
                f"{ms - kernel_ms:.4f} ms")
        del split
    plain_ms = time_ms(torch, lambda: ssd.ssd_scan_plain(*args, chunk=chunk),
                       inner=2, reps=5)
    nbytes, flops, bound_ms, bound_by = ssd_work(case, dtype_name)
    say("ssd", f"x {case[:4]} N {case[4]} chunk {chunk} {dtype_name} "
        f"({kernel} kernel): "
        f"max_abs_err {err:.3e} ({tol_text(dtype_name)}), not bit-equal "
        f"{differ:.2e}{seq} | kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms library none bound "
        f"{bound_ms:.5f} ms ({bound_by}: {nbytes} B, {flops:.4g} FLOP) | "
        f"{flops / ms / 1e9:.2f} TFLOP/s, grid "
        f"{case[0] * case[2] * -(-case[3] // ssd.PANEL_P)} blocks"
        f"{'' if case[3] <= ssd.PANEL_P else ' (head dim in panels of 64)'}"
        f"{old}")
    return dict(max_abs_err=err, differ=differ, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def ssd_phase(torch) -> dict:
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype_name in ("float32", "bfloat16"):
        for case in (SSD_MAIN,) + ZAMBA_SSD_CASES:
            results[("ssd_scan", case, dtype_name)] = ssd_case(
                torch, case, dtype_name, gen)
    worst = {}
    n = {}
    for dtype_name in ("float32", "bfloat16"):
        for P in (32, 64):
            for N in (16, 32, 64, 128):
                for S in (1, 100, 300, 1024):   # one row; one padded
                    for chunk in (32, 128):     # chunk; a ragged last one
                        case = (2, S, 8, P, N, chunk)
                        for kernel in ssd_kernels(torch, ssd, case,
                                                  dtype_name):
                            r = ssd_case(torch, case, dtype_name, gen,
                                         timed=False, kernel=kernel)
                            key = f"{kernel} {dtype_name}"
                            worst[key] = max(worst.get(key, 0.0),
                                             r["max_abs_err"])
                            n[key] = n.get(key, 0) + 1
    say("ssd", f"sweep: {sum(n.values())} runs (B 2, H 8, P 32/64, N "
        f"16/32/64/128, S 1/100/300/1024, chunk 32/128, fp32 and bf16; every "
        f"case on each kernel that takes it) all within tolerance | "
        + "; ".join(f"{k}: {n[k]} cases, worst max_abs_err {worst[k]:.3e}"
                    for k in sorted(n)))
    return results


# -- 9. mamba2 ----------------------------------------------------------------

MAMBA_TRAIN = dict(arch="mamba2-2.7b", steps=5, batch=8, seq=1024,
                   microbatches=2)
MAMBA_PARITY_DEPTH = 8


# -- 10. mixtral ----------------------------------------------------------------

# mixtral-8x7b at full width is 46.7 B parameters (93.4 GB in bf16) at
# its 32 layers: one H100 holds 16 (47.0 GB in bf16), and 4 in fp32
MIXTRAL_DEPTHS = {"bfloat16": 16, "float32": 4}
# the ring check: Smax = ring_size(4096) = 4112 slots at max_len 4608;
# lengths inside the ring, one short of it, on it, and wrapped twice (and
# one more each on the second step)
RING = dict(depth=2, max_len=4608, smax=4112,
            lengths=[100, 4111, 4112, 9000])
# 4 requests, prompts cut to 32 and outputs to 16 (8 requests of up to
# 128 and 64 before the fp32 anchors needed the time: 28 s)
MIXTRAL_SERVE = dict(requests=4, prompt_cap=32, gen_cap=16)


def ring_phase(torch, arch: str = "mixtral-8x7b", ring=None,
               phase: str = "mixtral") -> None:
    """``arch`` at full width and depth ``ring["depth"]``, ``max_len``
    ``ring["max_len"]``, so its sliding-window layers keep rings of
    ``ring["smax"]`` slots (default RING, mixtral-8x7b's: 4112 slots at
    max_len 4608):
    a cache of seeded random K/V at ``ring["lengths"]``, two
    ``decode_step`` calls through the kernels and through the plain
    versions, held as in the model phase."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    ring = RING if ring is None else ring
    window = next(w for w in C.get_config(arch).windows if w is not None)
    if min(ring["max_len"], T.ring_size(window)) != ring["smax"]:
        fail(f"{phase} ring: max_len {ring['max_len']} gives no ring of "
             f"{ring['smax']} slots")
    model_phase(torch, phase=phase, arch=arch,
                depths=dict.fromkeys(("float32", "bfloat16"), ring["depth"]),
                max_len=ring["max_len"], start_lens=ring["lengths"],
                steps=2)


def mixtral_phase(torch, smi: str):
    """mixtral-8x7b at full width: (a) bf16 ``decode_step`` logits at
    depth 16 and (b) fp32 at depth 4, kernels vs plain, with (d) a
    profiled bf16 step; (c) 4 chat requests served at depth 16; (e) the
    ring check.  Returns the serve run's launches."""
    torch.cuda.empty_cache()
    model_phase(torch, phase="mixtral", arch="mixtral-8x7b",
                depths=MIXTRAL_DEPTHS)
    served, _, _ = serve_phase(torch, smi, phase="mixtral",
                               arch="mixtral-8x7b",
                               depth=MIXTRAL_DEPTHS["bfloat16"],
                               **MIXTRAL_SERVE)
    ring_phase(torch)
    return served


# -- 11. ssm-serve --------------------------------------------------------------

# prompts cut to 32 and outputs to 8 (64 and 16 before the fp32 anchors
# needed the time: 198 host-bound steps a dtype, now 117)
SSM_SERVE = dict(requests=4, prompt_cap=32, gen_cap=8, max_batch=4,
                 max_len=512)
# its RMSNorms per decode step: norm1 of 64 layers and the final norm at
# d 2560, the gated norm of 64 layers at d_inner 5120
SSM_SERVE_NORMS = (((4, 1, 2560), 65), ((4, 1, 5120), 64))


def launch_mix(results: dict, parts) -> dict:
    """A record entry's numbers for a path that launches one kernel at
    several shapes, ``parts`` ((``results`` key, launches), ...): times
    and bound per launch averaged over the launches, the worst error,
    and ``bound_by`` of the shape with the largest share of the bound."""
    rs = [(results[key], n) for key, n in parts]
    total = sum(n for _, n in rs)

    def mean(field):
        if any(r[field] is None for r, _ in rs):
            return None
        return sum(r[field] * n for r, n in rs) / total

    return dict({f: mean(f) for f in ("ms", "plain_ms", "bound_ms",
                                      "library_ms")},
                max_abs_err=max(r["max_abs_err"] for r, _ in rs),
                bound_by=max(rs, key=lambda p: p[0]["bound_ms"] * p[1])[0][
                    "bound_by"])
# the last request arrives after the others have finished, so it is
# admitted into a slot an earlier request used
SSM_LATE_ARRIVAL = 1e6
# tests/test_torch_ssm.py's fp32 CACHE_TOL: the engine's state after a
# prefill against a batch-1 prefill of the same prompt, max abs; for
# zamba2 also the shared block's K/V rows of the prompt
SSM_STATE_TOL = {"ssm": 1e-4, "conv_x": 1e-4, "conv_bc": 1e-4,
                 "shared k": 1e-4, "shared v": 1e-4}


def ssm_serve_phase(torch, smi: str, arch: str = "mamba2-2.7b",
                    spec: dict = SSM_SERVE, norms=SSM_SERVE_NORMS,
                    phase: str = "ssm-serve", instance=None):
    """``arch`` FULL (mamba2-2.7b: 64 layers; zamba2-7b: 78 and the
    shared block 13 times) served by ``ServingEngine``: ``spec``'s chat
    requests (4; prompts cut to 32 tokens, outputs to 8; zamba2's to
    16 and 8), 4 slots, the last request admitted into a reused slot.  In
    bf16: every request finishes with its token count and every step
    launches its kernels (``norms``: the RMSNorm shapes of a step, with
    their launches), every decode attention on the kernel ``instance``
    ((head dim, group)) where given.  In fp32: after each prefill the slot's
    ``ssm``/``conv_x``/``conv_bc`` rows, and the shared block's K/V rows
    of its prompt, equal those of a batch-1 ``prefill`` of the same
    prompt within SSM_STATE_TOL, and the other active slots' SSM rows
    are unchanged.  Returns the bf16 run's launches."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.data.requests import make_serving_requests
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import SSM_STATE, ServingEngine
    base = C.get_config(arch)
    layers = base.n_layers
    per_step = decode_launches_per_step(base)
    if sum(n for _, n in norms) != per_step[0]:
        fail(f"{phase}: its RMSNorm shapes do not count {per_step[0]} "
             f"RMSNorms a step")
    reqs = make_serving_requests("chat", 1.0, spec["requests"],
                                 base.vocab_size, seed=0,
                                 max_len=spec["prompt_cap"])
    for i, r in enumerate(reqs):
        r["gen_len"] = min(r["gen_len"], spec["gen_cap"])
        r["arrival"] = SSM_LATE_ARRIVAL if i == len(reqs) - 1 else 0.0
    launched = None
    states = SSM_STATE + (("shared k", "shared v") if base.shared_attn
                          else ())
    for dtype_name in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, dtype=dtype_name)
        torch.cuda.empty_cache()
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        params = T.init_params(gen, cfg, device=DEVICE)
        eng = ServingEngine(cfg, params, max_batch=spec["max_batch"],
                            max_len=spec["max_len"], device=DEVICE)
        admitted = []
        worst = dict.fromkeys(states, 0.0)
        prefill = eng._prefill_slot

        def checked(i, prefill=prefill, eng=eng, cfg=cfg, params=params,
                    worst=worst, admitted=admitted, check=dtype_name ==
                    "float32"):
            others = [j for j, o in enumerate(eng.slots)
                      if o.active and j != i]
            before = [t[:, others].clone() for t in eng._state()] \
                if check else []
            prefill(i)
            admitted.append(i)
            if not check:
                return
            for t, rows in zip(eng._state(), before):
                if not torch.equal(t[:, others], rows):
                    fail(f"ssm-serve: slots {others} changed during slot "
                         f"{i}'s prefill")
            prompt = torch.as_tensor(eng.slots[i].prompt[None],
                                     device=DEVICE)
            _, alone = T.prefill(params, cfg, prompt, eng.max_len)
            for lc, ref in zip(eng.cache["blocks"].values(),
                               alone["blocks"].values()):
                for name in SSM_STATE:
                    err = float((lc[name][:, i] - ref[name][:, 0]).abs()
                                .max())
                    worst[name] = max(worst[name], err)
            n = prompt.shape[1]
            for name in ("k", "v") if cfg.shared_attn else ():
                got = eng.cache["shared"][name][:, i, :n]
                err = float((got - alone["shared"][name][:, 0, :n]).abs()
                            .max())
                worst[f"shared {name}"] = max(worst[f"shared {name}"], err)

        eng._prefill_slot = checked
        reset_counts()
        report = eng.run(reqs, time_scale=1.0)
        sync(torch)
        if dtype_name == "bfloat16":
            launched = counts()
        if len(report.results) != len(reqs):
            fail(f"{phase} {dtype_name}: {len(report.results)} of "
                 f"{len(reqs)} finished")
        by_rid = {r["rid"]: r for r in reqs}
        for res in report.results:
            if len(res.tokens) != max(by_rid[res.rid]["gen_len"], 2) or \
                    not all(0 <= t < cfg.vocab_size for t in res.tokens):
                fail(f"{phase} {dtype_name}: rid {res.rid} gave tokens "
                     f"{res.tokens}")
        if len(set(admitted)) == len(admitted):
            fail(f"{phase}: no slot was reused ({admitted})")
        steps = report.iterations + sum(len(r["prompt"]) for r in reqs)
        want = tuple(n * steps for n in per_step)
        if dtype_name == "bfloat16" and report.preemptions == 0 and \
                launched != want:
            fail(f"{phase}: launches {launched} for {steps} decode "
                 f"steps, expected {want}")
        if dtype_name == "bfloat16" and instance is not None and \
                set(decode_instances()) != {instance}:
            fail(f"{phase}: decode attention on (head dim, group) "
                 f"{decode_instances()}, expected only {instance}")
        beyond = {n: e for n, e in worst.items() if e > SSM_STATE_TOL[n]}
        if beyond:
            fail(f"{phase}: state after prefill vs batch-1 prefill "
                 f"{worst}, beyond {SSM_STATE_TOL}")
        state = (" | state after each prefill vs a batch-1 prefill of the "
                 "prompt, max abs: " + ", ".join(
                     f"{n} {e:.3e}" for n, e in worst.items())
                 + f" (tol {SSM_STATE_TOL['ssm']}); other active slots "
                 f"unchanged")
        if dtype_name == "bfloat16":
            state = (f" | launches rmsnorm {launched[0]} decode_attention "
                     f"{launched[1]} ({per_step[0]} and {per_step[1]} a "
                     f"step; decode instances by (head dim, group) "
                     f"{decode_instances()})")
        say(phase, f"{arch} FULL ({layers} layers) {dtype_name} on "
            f"{smi}: {len(report.results)} requests (prompts "
            f"{[len(r['prompt']) for r in reqs]}, gen "
            f"{[r['gen_len'] for r in reqs]}), slots in admission order "
            f"{admitted}, {report.iterations} iterations + "
            f"{steps - report.iterations} prefill steps, "
            f"{report.preemptions} preemptions | TTFT mean "
            f"{report.ttft_mean * 1e3:.1f} ms TPOT mean "
            f"{report.tpot_mean * 1e3:.2f} ms{state}")
        del params, eng
        torch.cuda.empty_cache()
    return launched


# -- 12. gemma3 -----------------------------------------------------------

# gemma3-12b at full width, held to LOGIT_TOL and ARGMAX_FLOOR: fp32 at 2
# blocks (12 layers, 14.8 GB of fp32 weights), bf16 at 4 blocks (24
# layers, qwen2-0.5b's depth, at which LOGIT_TOL was read).  At all 48
# layers (23.5 GB) bf16 is held to ARGMAX_FLOOR only: with sound kernels
# the logits there read 0.246 to 0.266 over seeds 0-5 on an H100, above
# LOGIT_TOL's 0.25, all of it from the decode kernel's bf16 rounding flips
# grown over twice the depth (PERF.md; ``--limits gemma3-12b``)
GEMMA_DEPTHS = {"float32": 2, "bfloat16": 4}
# the ring check at depth one block: at max_len 4096 the five local
# layers keep rings of ring_size(1024) = 1040 slots and the global one
# 4096; lengths inside the ring, one short of it, on it, and wrapped
GEMMA_RING = dict(depth=1, max_len=4096, smax=1040,
                  lengths=[100, 1039, 1040, 3000])
# one block (five local layers and the global one) at full width: the 48
# layers' AdamW state alone passes 80 GB.  2048 tokens a row, so the
# window of 1024 masks.  Parity at half the batch: two fp32 runs' weights
# and optimizer state of 2.35 B parameters take 56 GB of the card
GEMMA_TRAIN = dict(arch="gemma3-12b", steps=5, batch=8, seq=2048,
                   microbatches=2, depth=1)
GEMMA_PARITY = dict(GEMMA_TRAIN, batch=4)
# 4 requests, prompts cut to 32 and outputs to 16, at all 48 layers (8
# requests of up to 128 and 64 before the fp32 anchors needed the time:
# 41 s)
GEMMA_SERVE = dict(requests=4, prompt_cap=32, gen_cap=16,
                   max_len=GEMMA_SERVE_MAX_LEN)


def gemma3_phase(torch, smi: str):
    """gemma3-12b (blocks of five sliding-window layers and one global
    layer, head dim 256) at full width: (a) ``decode_step`` logits,
    kernels vs plain, at GEMMA_DEPTHS held to LOGIT_TOL and ARGMAX_FLOOR,
    and in bf16 at all 48 layers held to ARGMAX_FLOOR and, against its
    fp32 anchor, to ANCHOR_RATIO, with a profiled bf16 step (device ms by
    family beside the 7.02 ms it takes to read the weights once); (b)
    the ring check at depth one block; (c) 4 chat requests served at all
    48 layers with caches of GEMMA_SERVE_MAX_LEN slots; (d) one block
    trained for 5 steps through ``launch.train.train`` and one step
    kernels vs plain.  Returns the serve and train runs' launches."""
    torch.cuda.empty_cache()
    model_phase(torch, phase="gemma3", arch="gemma3-12b",
                depths=GEMMA_DEPTHS, profile=False)
    model_phase(torch, phase="gemma3", arch="gemma3-12b",
                dtypes=("bfloat16",), hold_logits=False, profile=True,
                anchor=True)
    ring_phase(torch, "gemma3-12b", GEMMA_RING, "gemma3")
    served, _, _ = serve_phase(torch, smi, phase="gemma3",
                               arch="gemma3-12b", **GEMMA_SERVE)
    trained = train_phase(torch, smi, GEMMA_TRAIN, "gemma3")
    train_parity_phase(torch, GEMMA_PARITY, depth=GEMMA_TRAIN["depth"],
                       phase="gemma3")
    return served, trained


# -- 13. deepseek ---------------------------------------------------------

DEEPSEEK = "deepseek-v2-lite-16b"
# deepseek-v2-lite-16b at full width is 15.7 B parameters, 31.4 GB in
# bf16: one H100 holds all 27 layers.  fp32 at 4 (the dense prefix layer
# and 3 MoE layers; 7.4 GB)
DEEPSEEK_DEPTHS = {"float32": 4, "bfloat16": None}
# forward (the flash kernel with q/k 192 wide, v 128) at the prefix and one
# MoE layer, bf16
DEEPSEEK_FORWARD = dict(depth=2, batch=2, seq=256)
# prompts cut to 16 and outputs to 8 (64 and 16 before the fp8 and
# dry-run phases needed the time, 32 and 8 before the fp32 anchors did:
# the host-bound steps of this run took ~260-350 ms of wall each on an
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 5)
DEEPSEEK_SERVE = dict(requests=4, prompt_cap=16, gen_cap=8, max_len=512)
# decode attention at the serve run's shape: q (4, 16, 192) against the
# expanded keys (4, 512, 16, 192) and values (4, 512, 16, 128), Hkv = H
# (group 1); the wrapper pads all three to 256.  RMSNorm at d 2048
DEEPSEEK_DECODE = (4, 16, 16, 192, 512)
DEEPSEEK_DV = 128
DEEPSEEK_INSTANCE = (256, 1)
DEEPSEEK_NORM = (4, 1, 2048)


def thw_positions(torch, batch: int, seq: int, side: int = 16):
    """(batch, seq, 3) M-RoPE ids of a stub image: patch i at time i //
    side^2, row (i // side) % side, column i % side."""
    i = torch.arange(seq, device=DEVICE)
    ids = torch.stack([i // side ** 2, (i // side) % side, i % side], -1)
    return ids.to(torch.int32).expand(batch, seq, 3)


def forward_check(torch, arch: str, depth: int, batch: int, seq: int,
                  dtype_name: str = "bfloat16", seed: int = 0) -> dict:
    """``forward`` of ``arch`` FULL at ``depth`` blocks over seeded
    (batch, seq) tokens, without gradients, through the plain versions
    and through the kernels (the kernel run taking the plain run's MoE
    routes); an arch fed embeddings takes seeded patch embeddings at
    (t, h, w) ids of a 16 x 16 patch grid (``thw_positions``) instead.
    Fails on the launches (RMSNorms, flash attentions of the attention
    layers and the shared block, SSD scans of the Mamba2 layers), on
    logits that are not finite, or beyond LOGIT_TOL / ARGMAX_FLOOR."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(C.get_config(arch), dtype=dtype_name,
                              block_repeat=depth)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = T.init_params(gen, cfg, device=DEVICE)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    inputs = dict(tokens=toks)
    if cfg.embeds_input:
        inputs = dict(embeds=torch.randn(batch, seq, cfg.d_model,
                                         generator=gen, device=DEVICE),
                      positions=thw_positions(torch, batch, seq))
    attn = sum(s.kind == "attn" for s in cfg.block_pattern) * depth
    ssm = sum(s.kind == "ssm" for s in cfg.block_pattern) * depth
    want = (2 * cfg.n_layers + 1, 0,
            attn + (depth if cfg.shared_attn else 0), ssm)
    log, routes = [], [0, 0]
    reset_counts()
    with torch.no_grad():
        with plain_kernels(), recorded_routes(log):
            plain = T.forward(params, cfg, **inputs)
        if any(counts()):
            fail("forward: the plain run launched a kernel")
        with replayed_routes(log, routes):
            logits = T.forward(params, cfg, **inputs)
    sync(torch)
    if counts() != want:
        fail(f"forward: launches {counts()}, expected {want}")
    if not bool(torch.isfinite(logits).all()):
        fail("forward: logits not finite")
    worst = float((logits.float() - plain.float()).abs().max())
    agree = int((logits.argmax(-1) == plain.argmax(-1)).sum())
    r = dict(cfg=cfg, worst=worst, scale=float(plain.float().abs().max()),
             agree=agree, rows=batch * seq, routes=tuple(routes),
             launches=want)
    del params, plain, logits
    torch.cuda.empty_cache()
    readings = model_readings(r, dtype_name)
    if r["worst"] > LOGIT_TOL[dtype_name] or \
            agree < ARGMAX_FLOOR[dtype_name] * r["rows"]:
        fail(f"forward {arch} {dtype_name}: {readings}")
    return dict(r, readings=readings)


def deepseek_phase(torch, F, smi: str):
    """deepseek-v2-lite-16b (MLA over latent caches; a dense first layer
    before 26 MoE layers of 64 experts, top-6, 2 shared) at full width on
    seeded random weights, after gemma3's memory is freed: (a) decode
    attention at MLA's shapes (q/k 192 and v 128, REDUCED 24 and 16, each
    padded by the wrapper) against the plain version, and at the serve
    shape timed, the padding copies apart; the flash kernel at those
    shapes; (b) ``decode_step`` logits kernels vs plain, fp32 at 4 layers
    and bf16 at all 27, held to LOGIT_TOL and ARGMAX_FLOOR, with a
    profiled bf16 step (device ms by family beside the 9.38 ms it takes to
    read the 31.4 GB of weights once); (c) ``forward`` in bf16 at 2 layers,
    B 2 x S 256, kernels vs plain; (d) 4 chat requests served at all 27
    layers, 55 RMSNorms and 27 decode attentions a step, every one on the
    D 256, group 1 instance.  Returns the serve run's launches and the
    timed cases."""
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype_name in ("float32", "bfloat16"):
        for D, dv, H in ((24, 16, 4), (192, 128, 16)):
            r = attention_case(torch, F, (3, H, H, D, 300), [1, 129, 300],
                               dtype_name, gen, timed=False, dv=dv)
            worst[dtype_name] = max(worst[dtype_name], r["max_abs_err"])
            for window, q_offset in ((None, 0), (19, 5)):
                r = flash_case(torch, F, (2, 77, 77 + q_offset, H, H, D,
                                          window, q_offset), dtype_name,
                               gen, timed=False, dv=dv)
                worst[dtype_name] = max(worst[dtype_name], r["max_abs_err"])
            n += 3
    say("deepseek", f"MLA head dims: {n} cases (decode attention and flash, "
        f"q/k 24 and v 16 padded to 64 (flash 32), q/k 192 and v 128 padded "
        f"to 256, group 1, fp32 and bf16) all within tolerance, worst "
        f"max_abs_err fp32 {worst['float32']:.3e} bf16 "
        f"{worst['bfloat16']:.3e}")
    for dtype_name in ("float32", "bfloat16"):
        results[("decode_attention", DEEPSEEK_DECODE, dtype_name)] = \
            attention_case(torch, F, DEEPSEEK_DECODE, [1, 77, 300, 512],
                           dtype_name, gen, dv=DEEPSEEK_DV)
    # a profiled step makes ~13k launches: the profiler's events of two
    # steps, not five, keep its reading short
    model_phase(torch, phase="deepseek", arch=DEEPSEEK,
                depths=DEEPSEEK_DEPTHS, profiled_steps=2)
    r = forward_check(torch, DEEPSEEK, **DEEPSEEK_FORWARD)
    say("deepseek", f"forward {DEEPSEEK} FULL width ({r['cfg'].n_layers} "
        f"layers) bf16 B {DEEPSEEK_FORWARD['batch']} x S "
        f"{DEEPSEEK_FORWARD['seq']}: {r['readings']}, launches rmsnorm "
        f"{r['launches'][0]} flash_attention {r['launches'][2]}")
    served, _, _ = serve_phase(torch, smi, phase="deepseek", arch=DEEPSEEK,
                               instances=DEEPSEEK_INSTANCE,
                               **DEEPSEEK_SERVE)
    return served, results


# -- 14. qwen2-vl ---------------------------------------------------------

QWEN_VL = "qwen2-vl-7b"
# qwen2-vl-7b at full width is 7.62 B parameters (its untied embedding
# table and head 1.09 B of them), 15.2 GB in bf16: all 28 layers on one
# card.  fp32 at 4 layers (2.02 B parameters, 8.1 GB)
QWEN_VL_DEPTHS = {"float32": 4, "bfloat16": None}
QWEN_VL_INSTANCE = (128, 7)
QWEN_VL_FORWARD = dict(depth=2, batch=2, seq=256)
# 4 of 28 layers: AdamW keeps ~18 B a parameter (bf16 weights, fp32
# gradient accumulators, masters and both moments), 2.02 B parameters
# at depth 4 (the embedding table and the head are 1.09 B of them) take
# ~36 GB before activations; 28 layers (7.6 B) would take ~137 GB
QWEN_VL_TRAIN = dict(arch=QWEN_VL, steps=5, batch=8, seq=1024,
                     microbatches=2, depth=4)
QWEN_VL_PARITY = dict(QWEN_VL_TRAIN, batch=4)
QWEN_VL_NORM_SERVE = (4, 1, 3584)
QWEN_VL_NORM_TRAIN = (4, 1024, 3584)
QWEN_VL_DECODE = (4, 28, 4, 128, 512)


def qwen2vl_phase(torch, smi: str):
    """qwen2-vl-7b (M-RoPE, fed patch embeddings; GQA group 7, head dim
    128) at full width on seeded random weights: (a) logits kernels vs
    plain through ``prefill(..., embeds=)`` and ``decode_step(embeds=)``,
    fp32 at 4 layers and bf16 at all 28, held to LOGIT_TOL and
    ARGMAX_FLOOR (bf16 also to ANCHOR_RATIO against its fp32 anchor),
    with 57 RMSNorms and 28 decode attentions a step, all
    on the D 128, group 7 instance, and a profiled bf16 step; (b)
    ``forward`` in bf16 at 2 layers, B 2 x S 256, at the (t, h, w) ids of
    a patch grid, through the flash kernel; (c) 4 layers trained for 5
    steps on patch embeddings (8 x 1024, 2 microbatches, remat), and one
    step kernels vs plain held to TRAIN_TOL.  Returns the bf16 decode
    run's and the train run's launches."""
    torch.cuda.empty_cache()
    runs = model_phase(torch, phase="qwen2-vl", arch=QWEN_VL,
                       depths=QWEN_VL_DEPTHS, instance=QWEN_VL_INSTANCE,
                       anchor=True)
    r = forward_check(torch, QWEN_VL, **QWEN_VL_FORWARD)
    say("qwen2-vl", f"forward {QWEN_VL} FULL width ({r['cfg'].n_layers} "
        f"layers) bf16 B {QWEN_VL_FORWARD['batch']} x S "
        f"{QWEN_VL_FORWARD['seq']}, patch embeddings at (t, h, w) ids of a "
        f"16 x 16 grid: {r['readings']}, launches rmsnorm "
        f"{r['launches'][0]} flash_attention {r['launches'][2]}")
    trained = train_phase(torch, smi, QWEN_VL_TRAIN, "qwen2-vl")
    train_parity_phase(torch, QWEN_VL_PARITY, depth=QWEN_VL_TRAIN["depth"],
                       phase="qwen2-vl")
    return runs["bfloat16"]["launched"], trained


# -- 15. seamless -----------------------------------------------------------

SEAMLESS = "seamless-m4t-large-v2"
# seamless-m4t-large-v2 at full width and depth is 1.63 B parameters
# (3.3 GB in bf16, 6.5 GB in fp32): 24 encoder and 24 decoder layers,
# in both dtypes.  In bf16 at that depth the dropped-tile and
# round-toward-zero controls read inside the sound kernels' range; fp32
# at full depth is the reading that fails every control (PERF.md)
SEAMLESS_DEPTHS = {"float32": None, "bfloat16": None}
# 4 requests of 1024 frames each, a BOS token, 16 greedy steps in caches
# of 64 slots
SEAMLESS_SERVE = dict(requests=4, source=1024, steps=16, max_len=64)
SEAMLESS_INSTANCE = (64, 1)
# full width and depth: ~29 GB of AdamW state before activations
SEAMLESS_TRAIN = dict(arch=SEAMLESS, steps=5, batch=8, seq=1024,
                      microbatches=2)
SEAMLESS_NORM_SERVE = (4, 1, 1024)
SEAMLESS_NORM_TRAIN = (4, 1024, 1024)
# decode attention in a serve step: self-attention over the 64-slot
# caches (lengths after the BOS token and up to 16 steps), cross-attention
# over the 1024 frames' K/V
SEAMLESS_DECODE = ((4, 16, 16, 64, 64), (4, 16, 16, 64, 1024))
SEAMLESS_DECODE_LENS = ([1, 6, 11, 17], [1024] * 4)


def seamless_check(torch, dtype_name: str, seed: int = 0,
                   arch: str = SEAMLESS, depth=None,
                   instance=SEAMLESS_INSTANCE, profile: bool = False,
                   anchor: bool = False) -> dict:
    """seamless serving at full width (``depth`` layers of encoder and
    decoder if given) on seeded random weights: SEAMLESS_SERVE's requests
    of seeded frames through ``encdec_prefill`` and greedy
    ``encdec_decode_step``s, through the plain versions and through the
    kernels, the kernel run fed the plain run's tokens.  Checks that an
    encode launches ``encode_launches``, a prefill that and one decode
    step, every step ``decode_launches_per_step`` (self and cross
    attention on the kernel ``instance``, (head dim, group), unless None),
    and the logits' shape and finiteness; with ``profile``, profiles two
    more decode steps (``profile_steps``); with ``anchor`` (bf16), the
    prefill and the steps once more through the plain versions in fp32
    from the weights upcast, fed the same frames and the plain run's
    tokens (``fp32_anchor``).  Returns the readings ``model_check``
    returns, the serve run's launches and encode, prefill and step
    times."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import encdec as ED
    cfg = dataclasses.replace(C.get_config(arch), dtype=dtype_name)
    if depth:
        cfg = dataclasses.replace(
            cfg, block_repeat=depth,
            encoder=dataclasses.replace(cfg.encoder, n_layers=depth))
    spec = SEAMLESS_SERVE
    B, steps = spec["requests"], spec["steps"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = ED.init_encdec_params(gen, cfg, device=DEVICE)
    frames = torch.randn(B, spec["source"], cfg.d_model, generator=gen,
                         device=DEVICE)
    bos = torch.zeros(B, 1, dtype=torch.int32, device=DEVICE)
    enc = encode_launches(cfg)
    per_step = decode_launches_per_step(cfg)
    reset_counts()
    with plain_kernels():
        logits, cache, _ = ED.encdec_prefill(params, cfg, frames, bos,
                                             spec["max_len"])
        plain = [logits]
        for _ in range(steps):
            tok = plain[-1].argmax(-1).to(torch.int32)[:, None]
            logits, cache = ED.encdec_decode_step(params, cfg, tok, cache)
            plain.append(logits)
    if any(counts()):
        fail(f"{arch}: the plain run launched a kernel")
    del cache
    toks = [p.argmax(-1).to(torch.int32)[:, None] for p in plain[:-1]]
    reset_counts()
    sync(torch)
    t0 = time.perf_counter()
    with torch.no_grad():
        ED.encode(params, cfg, frames)
    sync(torch)
    encode_ms = (time.perf_counter() - t0) * 1e3
    if counts() != (enc[0], 0, enc[1], 0):
        fail(f"{arch} encode: launches {counts()}, expected "
             f"({enc[0]}, 0, {enc[1]}, 0)")
    reset_counts()
    t0 = time.perf_counter()
    logits, cache, _ = ED.encdec_prefill(params, cfg, frames, bos,
                                         spec["max_len"])
    sync(torch)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    want = (enc[0] + per_step[0], per_step[1], enc[1], 0)
    if counts() != want:
        fail(f"{arch} prefill: launches {counts()}, expected {want}")
    kern, walls = [logits], []
    launched = counts()
    for s in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        logits, cache = ED.encdec_decode_step(params, cfg, toks[s], cache)
        sync(torch)
        walls.append(time.perf_counter() - t0)
        if counts() != per_step or (instance is not None and set(
                decode_instances()) != {instance}):
            fail(f"{arch} decode step: launches {counts()} on "
                 f"{decode_instances()}, expected {per_step} on "
                 f"{instance}")
        launched = tuple(a + b for a, b in zip(launched, counts()))
        kern.append(logits)
    step_wall = statistics.mean(walls[1:])
    # the same step again, writing the same cache slot each time
    dev_ms = time_ms(torch, lambda: ED.encdec_decode_step(
        params, cfg, toks[-1], cache), inner=1, reps=3)
    if profile:
        from repro_torch.models import transformer as T
        profile_steps(torch, T, params, cfg, cache, torch.stack(toks[:2]))
    worst = scale = 0.0
    agree = 0
    for k, p in zip(kern, plain):
        if tuple(k.shape) != (B, cfg.vocab_size) or not bool(
                torch.isfinite(k).all()):
            fail(f"{arch}: bad logits {tuple(k.shape)}")
        worst = max(worst, float((k.float() - p.float()).abs().max()))
        scale = max(scale, float(p.float().abs().max()))
        agree += int((k.argmax(-1) == p.argmax(-1)).sum())
    del cache
    anchored = None
    if anchor:
        def run(cfg32):
            logits, c, _ = ED.encdec_prefill(params, cfg32, frames, bos,
                                             spec["max_len"])
            out = [logits]
            for tok in toks:
                logits, c = ED.encdec_decode_step(params, cfg32, tok, c)
                out.append(logits)
            return out

        anchored = anchor_readings(torch, plain, kern,
                                   fp32_anchor(torch, params, cfg, run))
    del params, kern, plain
    torch.cuda.empty_cache()
    return dict(cfg=cfg, worst=worst, scale=scale, agree=agree,
                rows=B * (steps + 1), routes=(0, 0), per_step=per_step,
                launched=launched, encode_ms=encode_ms,
                prefill_ms=prefill_ms, step_wall_ms=step_wall * 1e3,
                step_device_ms=dev_ms, anchor=anchored)


def seamless_phase(torch, smi: str):
    """seamless-m4t-large-v2 (24 encoder and 24 decoder layers, d 1024, 16
    heads of 64, non-gated FFN, vocab 256206) at full width and depth on
    seeded random weights: (a) 4 requests of 1024 frames served through
    ``encdec_prefill`` (the encoder through the flash kernel without the
    causal mask) and 16 greedy ``encdec_decode_step``s (self and cross
    attention through the decode kernel), logits kernels vs plain in fp32
    and bf16 at 24 + 24 layers, held to LOGIT_TOL and
    ARGMAX_FLOOR (bf16 also to ANCHOR_RATIO against its fp32 anchor),
    24 flash launches and 49 RMSNorms an encode, 73
    RMSNorms and 48 decode attentions a step; (b) 5 train steps at full
    depth on the frames batch (8 x 1024 frames and tokens, 2
    microbatches, remat) and one step kernels vs plain held to
    TRAIN_TOL.  Returns the bf16 serve run's and the train run's
    launches."""
    torch.cuda.empty_cache()
    served = None
    for dtype_name, depth in SEAMLESS_DEPTHS.items():
        r = seamless_check(torch, dtype_name, depth=depth,
                           profile=dtype_name == "bfloat16",
                           anchor=dtype_name == "bfloat16")
        readings = model_readings(r, dtype_name)
        if r["worst"] > LOGIT_TOL[dtype_name] or \
                r["agree"] < ARGMAX_FLOOR[dtype_name] * r["rows"] or \
                (r["anchor"] and r["anchor"]["ratio"] > ANCHOR_RATIO):
            fail(f"seamless {dtype_name}: {readings}")
        cfg = r["cfg"]
        say("seamless", f"{SEAMLESS} FULL width ({cfg.encoder.n_layers} "
            f"encoder + {cfg.block_repeat} decoder layers, d "
            f"{cfg.d_model}, head dim {cfg.head_dim}, vocab "
            f"{cfg.vocab_size}) {dtype_name} on {smi}: "
            f"{SEAMLESS_SERVE['requests']} requests of "
            f"{SEAMLESS_SERVE['source']} frames, BOS + "
            f"{SEAMLESS_SERVE['steps']} greedy steps: {readings} | encode "
            f"{r['encode_ms']:.2f} ms, prefill (encode, cross K/V, first "
            f"step) {r['prefill_ms']:.2f} ms, decode step wall "
            f"{r['step_wall_ms']:.2f} ms device {r['step_device_ms']:.3f} "
            f"ms | launches an encode rmsnorm {encode_launches(cfg)[0]} "
            f"flash_attention {encode_launches(cfg)[1]}, a step rmsnorm "
            f"{r['per_step'][0]} decode_attention {r['per_step'][1]} (all "
            f"on (head dim, group) {SEAMLESS_INSTANCE})")
        if dtype_name == "bfloat16":
            served = r["launched"]
    trained = train_phase(torch, smi, SEAMLESS_TRAIN, "seamless")
    train_parity_phase(torch, SEAMLESS_TRAIN, phase="seamless")
    return served, trained


# -- 16. zamba2 -------------------------------------------------------------

ZAMBA = "zamba2-7b"
# zamba2-7b at full width: 78 Mamba2 layers (six a repeat, 13 repeats) and
# one shared attention + MLP block applied after each repeat, 6.4 B
# parameters, 12.8 GB in bf16 and 25.7 GB in fp32: all 13 repeats fit one
# card in either dtype.  fp32 is held at 2 repeats, bf16 at ZAMBA_DEPTHS
# (``--limits zamba2-7b``)
ZAMBA_DEPTHS = {"float32": 2, "bfloat16": None}
# ``--limits zamba2-7b`` reads 2 and 4 repeats and all 13, in both dtypes
ZAMBA_LIMIT_DEPTHS = ({"float32": 2, "bfloat16": 2},
                      {"float32": 4, "bfloat16": 4},
                      {"float32": None, "bfloat16": None})
ZAMBA_INSTANCE = (128, 1)          # head dim 112 padded to 128, group 1
# forward through the SSD kernel at P 112 and the flash kernel at D 112
ZAMBA_FORWARD = dict(depth=2, batch=2, seq=256)
# prompts cut to 16 and outputs to 8 (32 and 16 before the fp8 and
# dry-run phases needed the time: the host-bound steps of this run took
# 95-145 ms of wall each on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md
# section 5)
ZAMBA_SERVE = dict(requests=4, prompt_cap=16, gen_cap=8, max_batch=4,
                   max_len=512)
# its RMSNorms per decode step: norm1 of 78 layers, the shared block's two
# norms 13 times and the final norm at d 3584; the gated norm of 78 layers
# at d_inner 7168.  In training (4 x 1024 tokens a microbatch) alike
ZAMBA_NORM_SERVE = (4, 1, 7168)
ZAMBA_NORM_TRAIN = (4, 1024, 7168)
ZAMBA_SERVE_NORMS = ((QWEN_VL_NORM_SERVE, 78 + 2 * 13 + 1),
                     (ZAMBA_NORM_SERVE, 78))
# decode attention in a serve step: the shared block's 32 heads of 112
# (group 1) over 4 slots of 512
ZAMBA_DECODE = (4, 32, 32, 112, 512)
# two repeats at full width: 12 Mamba2 layers and two applications of the
# tied block, so its gradient sums over both; 1.36 B parameters
ZAMBA_TRAIN = dict(arch=ZAMBA, steps=5, batch=8, seq=1024, microbatches=2,
                   depth=2)
# TRAIN_TOL's bf16 masters limit (0.1) is read, not held, for zamba2: with
# sound kernels one bf16 step reads 0.117 to 0.128 over seeds 0-2 on an
# H100, and 0.102 to 0.123 with any one kernel alone (RMSNorm, whose
# output is bit-equal to the plain version's in all but ~1e-5 of its
# elements, 0.123), while plain against plain reads 0: any one-ulp change
# flips the sign of the first Adam update of the gradients nearest zero.
# The bf16 loss and grad norm and every fp32 reading stay held; fp32
# catches each of TRAIN_CONTROLS (masters 1.5e-2 to 2.7e-2), bf16 none
# (PERF.md; ``--limits zamba2-7b`` prints the readings).  Against an fp32
# anchor step (``train_parity(anchor=True)``) neither the masters nor the
# gradient tree separate them either: |kernel run - anchor| over |plain
# run - anchor| read masters 0.9999 to 1.0002 and gradients 0.9964 to
# 1.0000 with sound kernels (seeds 0-2, each kernel alone), and under
# TRAIN_CONTROLS masters 1.0003 to 1.0011 (a gap to the sound runs no
# wider than their own spread) and gradients 0.9945 to 1.0029: at 2
# repeats x 1024 tokens each control moves one step's gradient by less
# than bf16 moves it from fp32 (3.3% of its norm), so the bf16 masters
# stay unheld (PERF.md section 6)
ZAMBA_UNHELD = (("bfloat16", "master"),)


def zamba2_phase(torch, smi: str):
    """zamba2-7b (78 Mamba2 layers, SSD head dim 112; a shared attention
    + MLP block after every six, head dim 112) at full width on seeded
    random weights: (a) ``decode_step`` logits kernels vs plain at
    ZAMBA_DEPTHS, held to LOGIT_TOL and ARGMAX_FLOOR (bf16 also to
    ANCHOR_RATIO against its fp32 anchor), 183 RMSNorms and 13
    decode attentions a step at 13 repeats, all on the (128, 1) instance,
    with a profiled bf16 step at all 13 repeats (device ms by family and
    the padding copies beside the weights' read-once bound); (b)
    ``forward`` in bf16 at 2 repeats, B 2 x S 256, through the SSD kernel
    at P 112 (two panels of 64) and the flash kernel at D 112; (c) 4 chat
    requests served at all 13 repeats, the last into a reused slot, the
    fp32 run's state after each prefill against a batch-1 prefill; (d)
    two repeats trained for 5 steps (every SSD launch on the tensor-core
    kernel) and one step kernels vs plain held to TRAIN_TOL but for
    ZAMBA_UNHELD.  Returns the serve and train runs' launches."""
    from repro_torch.kernels import ssd_scan
    torch.cuda.empty_cache()
    model_phase(torch, phase="zamba2", arch=ZAMBA, depths=ZAMBA_DEPTHS,
                instance=ZAMBA_INSTANCE, anchor=True)
    r = forward_check(torch, ZAMBA, **ZAMBA_FORWARD)
    if ssd_scan.variant_launches["wgmma"] != r["launches"][3]:
        fail(f"zamba2 forward: SSD launches {ssd_scan.variant_launches}, "
             f"expected all {r['launches'][3]} on the tensor-core kernel")
    say("zamba2", f"forward {ZAMBA} FULL width ({r['cfg'].n_layers} "
        f"layers) bf16 B {ZAMBA_FORWARD['batch']} x S "
        f"{ZAMBA_FORWARD['seq']}: {r['readings']}, launches rmsnorm "
        f"{r['launches'][0]} flash_attention {r['launches'][2]} (D 112 "
        f"padded to 128) ssd_scan {r['launches'][3]} (P 112 as two "
        f"panels of 64, all on the tensor-core kernel)")
    served = ssm_serve_phase(torch, smi, ZAMBA, ZAMBA_SERVE,
                             ZAMBA_SERVE_NORMS, "zamba2", ZAMBA_INSTANCE)
    trained = train_phase(torch, smi, ZAMBA_TRAIN, "zamba2")
    if ssd_scan.variant_launches["wgmma"] != trained[3]:
        fail(f"zamba2: {ssd_scan.variant_launches} of {trained[3]} SSD "
             f"launches were not on the tensor-core kernel")
    train_parity_phase(torch, ZAMBA_TRAIN, depth=ZAMBA_TRAIN["depth"],
                       phase="zamba2", unheld=ZAMBA_UNHELD)
    return served, trained


# broken kernels of the train path, made by wrapping the sound ones and
# read against TRAIN_TOL by ``--limits zamba2-7b``: the SSD scan rounding
# its fp32 result toward zero to bf16 precision; the flash kernel
# returning an lse 0.01 high (only the backward reads it); the flash
# kernel with the values of the last 64 keys dropped
TRAIN_CONTROLS = ("ssd_round_to_zero", "flash_lse_high", "flash_drop_keys")


def broken_train(torch, kind: str):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    if kind == "ssd_round_to_zero":
        sound = ssd.ssd_scan

        def faulty(x, dt, a_log, b, c, chunk=128):
            y = sound(x.float(), dt, a_log, b.float(), c.float(), chunk)
            cut = (y.detach().view(torch.int32) & -65536).view(torch.float32)
            # the backward still sees the sound scan's gradient
            return (y + (cut - y.detach())).to(x.dtype)

        return mock.patch.object(ssd, "ssd_scan", faulty)
    sound = fa.flash_attention

    def faulty(q, k, v, **kw):
        if kind == "flash_lse_high":
            out, lse = sound(q, k, v, **kw)
            return out, lse + 0.01
        v = v.clone()
        v[:, -64:] = 0
        return sound(q, k, v, **kw)

    return mock.patch.object(fa, "flash_attention", faulty)


def train_limits(torch, spec: dict = None, seeds=range(3)) -> None:
    """The readings behind ZAMBA_UNHELD: zamba2's
    train parity (2 repeats, batch 8 x 1024) over ``seeds`` in both
    dtypes, in bf16 with one kernel at a time (``one_kernel``) and with
    no kernel at all (plain against plain), and under each of
    TRAIN_CONTROLS in both dtypes, every bf16 step also against its fp32
    anchor; printed against TRAIN_TOL, nothing held."""
    spec = spec or ZAMBA_TRAIN
    alone = ("rmsnorm", "flash_attention", "ssd_scan", None)
    runs = [(d, seed, None) for d in ("float32", "bfloat16") for seed in seeds]
    runs += [("bfloat16", 0, ("only", k)) for k in alone]
    runs += [(d, 0, k) for d in ("float32", "bfloat16")
             for k in TRAIN_CONTROLS]
    for dtype_name, seed, kind in runs:
        if kind is None:
            patch, what = contextlib.nullcontext(), f"seed {seed}"
        elif isinstance(kind, tuple):
            patch = one_kernel(kind[1])
            what = ("no kernel (plain against plain)" if kind[1] is None
                    else f"only the {kind[1]} kernel")
        else:
            patch, what = broken_train(torch, kind), f"control {kind}"
        with patch:
            r = train_parity(torch, dtype_name, seed=seed, spec=spec,
                             depth=spec.get("depth"),
                             anchor=dtype_name == "bfloat16")
        say("limits", f"{spec['arch']} train parity {dtype_name} depth "
            f"{spec.get('depth')} {what}: "
            + parity_readings(r, TRAIN_TOL[dtype_name]))


# -- 17. deepseek-train -----------------------------------------------------

# deepseek-v2-lite-16b at full width and depth 2: the dense prefix layer
# and one MoE layer (64 experts, top-6, 2 shared), 1.09 B parameters; AdamW
# for all 27 layers (15.7 B) does not fit one card.  Parity at half the
# batch
DEEPSEEK_TRAIN = dict(arch=DEEPSEEK, steps=5, batch=8, seq=1024,
                      microbatches=2, depth=2)
DEEPSEEK_PARITY = dict(DEEPSEEK_TRAIN, batch=4)
DEEPSEEK_NORM_TRAIN = (4, 1024, 2048)


def deepseek_train_phase(torch, smi: str):
    """deepseek-v2-lite-16b trained at full width and depth 2 (MLA: the
    flash kernel with q/k 192 and v 128, both padded to 256 by the
    wrapper, and the plain backward): 5 steps of 8 x 1024 tokens (2
    microbatches, remat; the prefix block is not checkpointed), then one
    step kernels vs plain held to TRAIN_TOL, the kernel run taking the
    plain run's MoE routes.  Returns the train run's launches."""
    torch.cuda.empty_cache()
    trained = train_phase(torch, smi, DEEPSEEK_TRAIN, "deepseek-train")
    train_parity_phase(torch, DEEPSEEK_PARITY,
                       depth=DEEPSEEK_TRAIN["depth"], phase="deepseek-train")
    return trained


# -- 18. parallel ---------------------------------------------------------------

# fp32 limits of the parallel phase: the CPU tests' (tests/
# test_parallel.py, tests/test_torch_parallel*.py): EP and SP decode 2e-4,
# the pipeline's schedule check 2e-5 against the microbatches run in turn,
# compression's error bound scale + 1e-7.  The CPU tests also hold the
# pipeline at 2e-5 against one run over the whole batch; on the card two
# plain runs miss that limit alike (cuBLAS takes other fp32 algorithms
# for 4x the rows in three of the layer's products; ``pipeline_case``),
# so fp32 holds the pipeline's share beyond 2e-5 to the plain runs' share
# (0.61-0.72%), and max_abs_err / max|x| to a limit of the card's own.  It and the bf16 limits were read on an H100 over seeds 0-2
# (``python3 chip_smoke.py --limits parallel``; PERF.md): EP bf16 0
# (mixtral) and 3.1e-2 (deepseek: one bf16 ulp at |y| ~ 5), controls >=
# 1.41 (an expert dropped: 2.60 / 1.76; gates not renormalised: 1.62 /
# 1.41); SP decode bf16 1.5e-5 to 1.2e-4, controls 3.88 (each row's last
# valid slot masked) and 38.0 (the normaliser left out), read when its
# partials were plain PyTorch (they are the decode kernel's now, merged by
# its log-sum-exp, which at world size 1 weighs by e^0: the normaliser's
# control runs on 8 gloo ranks, tests/test_torch_parallel_ranks.py);
# pipeline bf16 0
# against both, fp32 against the whole batch 2.8e-6 to 3.8e-6, microbatch
# 1 passed through the stage untouched 0.99.  At world size 1 every
# collective is the identity, so a left-out all-reduce cannot show here;
# tests/test_torch_parallel_ranks.py catches it at tp 4.
PARALLEL_FP32 = {"ep": 2e-4, "sp": 2e-4, "pipeline": 2e-5,
                 "pipeline_whole": 1e-4}
PARALLEL_BF16 = {"ep": 0.1, "sp": 1e-3, "pipeline": 1e-2,
                 "pipeline_whole": 1e-2}
# (arch, (batch, seq)) of the EP cases: one MoE FFN at full width
EP_CASES = (("mixtral-8x7b", (4, 512)), (DEEPSEEK, (4, 512)))
# qwen1.5-32b's decode heads over the kernels phase's long cache
SP_DECODE = (4, 40, 40, 128, 32768)
# the decode kernel's log-sum-exp against its plain version's, fp32 both
# ways: about 100 fp32 ulps at the ~11 a row of 32768 slots reads; the
# two sum the same exponentials in other orders
SP_LSE_TOL = 1e-4
# qwen2-0.5b FULL's 24 layers as one stage: 4 microbatches of (2, 1024)
PIPE = dict(arch="qwen2-0.5b", n_micro=4, mb=2, seq=1024)
PIPE_FLASH = (2, 1024, 1024, 14, 2, 64, None, 0)
PIPE_NORM = (2, 1024, 896)
# qwen1.5-32b FULL width at depth 2 of 64, 40 heads padded to 48:
# prompts of these lengths replayed, then ``steps`` decode steps
PAD = dict(arch="qwen1.5-32b", depth=2, lengths=(16, 9, 3, 12), steps=4,
           max_len=256)
PAD_NORM = (4, 1, 5120)
PAD_DECODE = (4, 48, 48, 128, 256)
COMPRESS_ARCH = "qwen2-0.5b"
PARALLEL_CONTROLS = ("drop_expert", "gates_not_renormalised",
                     "skip_last_slot", "skip_microbatch")


def held(what: str, reading: float, limit, hold: bool) -> str:
    """``reading`` against ``limit``: fails above it where ``hold``."""
    if limit is None or not hold:
        return f"{what} {reading:.3e} (read, not held)"
    if not reading <= limit:
        fail(f"parallel: {what} {reading:.3e} beyond {limit}")
    return f"{what} {reading:.3e} (limit {limit})"


def holds(dtype_name: str, control, limits_run: bool) -> bool:
    """A reading is held unless it is a control's, or bf16 in a limits
    run (which reads the bf16 limits)."""
    return control is None and not (limits_run and dtype_name == "bfloat16")


@contextlib.contextmanager
def parallel_control(kind):
    """A broken variant of one parallel function, for ``--limits
    parallel``: ``drop_expert`` (expert 0's outputs never come back),
    ``gates_not_renormalised`` (top-k of the softmax over every expert),
    ``skip_last_slot`` (SP decode's kernel call leaves out each rank's
    last valid slot), ``skip_microbatch`` (the stage passes microbatch 1
    through untouched).  SP decode's merge by log-sum-exp is the
    identity at world size 1 (each weight is e^0), so its controls (the
    all-reduces or the normaliser left out) run on 8 gloo ranks in
    tests/test_torch_parallel_ranks.py."""
    from repro_torch.layers import moe
    from repro_torch.parallel import ep, sp_decode
    if kind is None:
        yield None
    elif kind == "drop_expert":
        bucket = ep._bucket_by_expert

        def dropping(x, idx, n_exp, cap):
            buffers, where, drops = bucket(x, idx, n_exp, cap)
            tok, e_idx, s_idx, kept = where
            return buffers, (tok, e_idx, s_idx, kept & (e_idx != 0)), drops

        with mock.patch.object(ep, "_bucket_by_expert", dropping):
            yield None
    elif kind == "gates_not_renormalised":
        def unnormalised(params, x, top_k, router_noise=None):
            _, experts = moe.route(params, x, top_k, router_noise)
            probs = (x.float() @ params["router"]).softmax(-1)
            return probs.gather(-1, experts), experts

        with mock.patch.object(ep, "route", unnormalised):
            yield None
    elif kind == "skip_last_slot":
        partial = sp_decode._partial

        def skipping(q, k, v, n):
            return partial(q, k, v, (n - 1).clamp_min(0).to(n.dtype))

        with mock.patch.object(sp_decode, "_partial", skipping):
            yield None
    else:
        yield "skip_microbatch"


def ep_case(torch, arch: str, shape, dtype_name: str, mesh, seed: int,
            timed: bool, control=None, limits_run=False) -> dict:
    """One MoE FFN of ``arch`` at full width through ``moe_ep_forward``
    (world size 1: the all-to-alls over NCCL) against the dense
    ``moe_forward``: at capacity factor 8 (no drops) held to PARALLEL_*;
    at 1.25 its drop fraction must equal the overflow of a per-expert
    count of the same routes (``bincount``, less the capacity, clamped at
    0), and the port's own bucketing of those routes on the CPU (which
    tells the card's sort and search from the CPU's, not a wrong route).
    bf16 also times EP (1.25) and dense (printed; no claim)."""
    from repro_torch import configs as C
    from repro_torch.layers.moe import init_moe, moe_forward, route
    from repro_torch.parallel import ep
    cfg = C.get_config(arch)
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p = init_moe(gen, cfg.d_model, cfg.d_ff_expert, cfg.n_routed,
                 cfg.top_k, cfg.n_shared, cfg.ffn_gated, dtype=dt,
                 device=DEVICE)
    # tokens share a mean direction, as hidden states do, so the router's
    # load is uneven and capacity factor 1.25 drops assignments
    x = (torch.randn(*shape, cfg.d_model, generator=gen, device=DEVICE)
         + 0.5 * torch.randn(cfg.d_model, generator=gen, device=DEVICE)
         ).to(dt)
    k = cfg.top_k
    with torch.no_grad():
        dense = moe_forward(p, x, k)
        with parallel_control(control):
            y, drop = ep.moe_ep_forward(p, x, k, mesh, cap_factor=8.0)
        y125, drop125 = ep.moe_ep_forward(p, x, k, mesh, cap_factor=1.25)
        sync(torch)
        T = x.shape[0] * x.shape[1]
        _, idx = route(p, x.reshape(T, -1), k)
        cap = max(1, int(1.25 * T * k / cfg.n_routed))
        _, _, cpu_drops = ep._bucket_by_expert(x.reshape(T, -1).cpu(),
                                               idx.cpu(), cfg.n_routed, cap)
        load = torch.bincount(idx.reshape(-1), minlength=cfg.n_routed)
        overflow = int((load - cap).clamp_min(0).sum())
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(y125)
                                                   .all())):
        fail(f"parallel: EP {arch} {dtype_name}: non-finite output")
    if float(drop) != 0.0 and control is None:
        fail(f"parallel: EP {arch} at capacity factor 8 dropped {float(drop)}")
    want_drop = overflow / (T * k)
    # the fraction is fp32: compare the assignments it counts
    if (round(float(drop125) * T * k) != overflow
            or int(cpu_drops) != overflow or overflow == 0):
        fail(f"parallel: EP {arch} drop fraction {float(drop125)} at "
             f"capacity factor 1.25; the routes' overflow {want_drop} "
             f"({overflow} of {T * k}), the CPU bucketing's "
             f"{int(cpu_drops)}")
    err = float((y.float() - dense.float()).abs().max())
    limit = (PARALLEL_FP32 if dtype_name == "float32" else PARALLEL_BF16)["ep"]
    text = held("EP (cap 8) vs dense max_abs_err", err, limit,
                holds(dtype_name, control, limits_run))
    r = dict(err=err, drop=want_drop)
    if timed:
        r["ep_ms"] = time_ms(torch, lambda: ep.moe_ep_forward(
            p, x, k, mesh, cap_factor=1.25), inner=5, reps=5)
        r["dense_ms"] = time_ms(torch, lambda: moe_forward(p, x, k),
                                inner=5, reps=5)
        text += (f" | EP (cap 1.25, {cap} slots an expert) "
                 f"{r['ep_ms']:.3f} ms, dense {r['dense_ms']:.3f} ms")
    say("parallel", f"EP {arch} FFN (d {cfg.d_model}, f {cfg.d_ff_expert}, "
        f"{cfg.n_routed} experts top {k}, {cfg.n_shared} shared) x "
        f"{tuple(x.shape)} {dtype_name} seed {seed}"
        f"{f' control {control}' if control else ''}: {text} (max|y| "
        f"{float(dense.float().abs().max()):.3e}) | drop fraction at cap "
        f"1.25 {want_drop:.4%} (= the routes' per-expert overflow at "
        f"{cap} slots, = the CPU bucketing)")
    return r


def sp_case(torch, F, dtype_name: str, mesh, seed: int, timed: bool,
            control=None, limits_run=False) -> dict:
    """``sp_decode_attention`` at qwen1.5-32b's decode heads over a long
    cache (world size 1: the MAX and SUM combines over NCCL) against
    ``decode_attention_plain`` and the decode kernel on the same cache.
    Its one decode-kernel launch (counted) asks for each row's
    log-sum-exp as well, which the kernel and the plain version must
    give alike (fp32, SP_LSE_TOL).  Timed (bf16), the numbers of the
    record's ``decode_attention/parallel-sp``: the kernel call with the
    log-sum-exp beside its plain version, its bound, and SDPA on the
    same cache; and the SP call's time beside it."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.parallel import sp_decode
    B, Hq, Hkv, D, smax = SP_DECODE
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v, lens = attention_inputs(torch, B, Hq, Hkv, D, smax,
                                     DECODE_LONG_LENGTHS, dt, gen)
    reset_counts()
    with parallel_control(control):
        out = sp_decode.sp_decode_attention(q, k, v, lens, mesh)
    sync(torch)
    launched = counts()
    if launched != (0, 1, 0, 0):
        fail(f"parallel: SP decode launched {launched} (rmsnorm, decode, "
             f"flash, ssd), not one decode attention")
    plain, plain_lse = da.decode_attention_plain(q, k, v, lens,
                                                 with_lse=True)
    kern, lse = da.decode_attention(q, k, v, lens, with_lse=True)
    sync(torch)
    if not bool(torch.isfinite(out).all()):
        fail("parallel: SP decode: non-finite output")
    errs = [float((out.float() - w.float()).abs().max())
            for w in (plain, kern)]
    limit = (PARALLEL_FP32 if dtype_name == "float32" else PARALLEL_BF16)["sp"]
    hold = holds(dtype_name, control, limits_run)
    text = "; ".join(held(f"vs {w} max_abs_err", e, limit, hold)
                     for w, e in zip(("plain", "kernel"), errs))
    lse_err = float((lse - plain_lse).abs().max())
    text += "; " + held("kernel lse vs plain lse max_abs_err", lse_err,
                        SP_LSE_TOL, control is None)
    r = dict(err=max(errs), launched=launched[1])
    if timed:
        r["sp_ms"] = time_ms(torch, lambda: sp_decode.sp_decode_attention(
            q, k, v, lens, mesh), inner=3, reps=5)
        ms = time_ms(torch, lambda: da.decode_attention(
            q, k, v, lens, with_lse=True), inner=5, reps=5)
        plain_ms = time_ms(torch, lambda: da.decode_attention_plain(
            q, k, v, lens, with_lse=True), inner=2, reps=5)
        mask = (torch.arange(smax, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kt, vt, attn_mask=mask), inner=2, reps=5)
        del kt, vt
        es = q.element_size()
        n_kv = sum(min(max(n, 0), smax) for n in DECODE_LONG_LENGTHS)
        nbytes = (n_kv * Hkv * 2 * D * es + 2 * q.numel() * es
                  + 4 * B * Hq + 4 * B)
        bound_ms, bound_by = bound(nbytes, n_kv * Hq * 4.0 * D)
        r.update(max_abs_err=float((kern.float() - plain.float()).abs()
                                   .max()),
                 ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=bound_ms, bound_by=bound_by)
        text += (f" | SP {r['sp_ms']:.4f} ms, its decode kernel call (with "
                 f"the lse) {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                 f"library(SDPA, no lse) {library_ms:.4f} ms, bound "
                 f"{bound_ms:.5f} ms ({bound_by}, {nbytes} B)")
    say("parallel", f"SP decode q {(B, Hq, D)} k/v {(B, smax, Hkv, D)} "
        f"lengths {DECODE_LONG_LENGTHS} {dtype_name} seed {seed}"
        f"{f' control {control}' if control else ''}: {text}")
    return r


def pipeline_case(torch, dtype_name: str, mesh, seed: int, control=None,
                  limits_run=False) -> dict:
    """``pipeline_forward`` with qwen2-0.5b FULL's 24 decoder layers as
    the one stage (RMSNorm and flash kernels), 4 microbatches of (2,
    1024).  Two comparisons with the same layers run without the
    pipeline:

    * the schedule check, against the layers run over each microbatch in
      turn.  At world size 1 this makes the same stage calls on the same
      microbatches, so it reads 0 unless the schedule loses, repeats or
      reorders a microbatch (the skip_microbatch control); fp32 at the
      CPU test's rtol = atol = 2e-5 elementwise.
    * against the layers run once over the whole batch.  The CPU tests
      hold this at 2e-5 elementwise.  On the card the plain layers miss
      it too, between two plain runs (the whole batch against each
      microbatch in turn): cuBLAS takes other fp32 algorithms for 4x the
      rows in some products (on an H100, h @ wk and h @ wv, N 128, and
      the down projection, K 4864, differ bitwise in ~95% of elements;
      RMSNorm, flash and the other products are bit-equal).  So fp32
      holds the pipeline's share of elements beyond 2e-5 to the plain
      microbatches' share, and max_abs_err / max|x| to
      PARALLEL_*["pipeline_whole"], a limit of the card's own.  The
      plain reading and the bitwise shares, op by op of the first layer
      and for the whole layer, are printed beside it.

    Returns the pipeline run's launches."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch import configs as C
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.layers import rms_norm
    from repro_torch.models import transformer as T
    from repro_torch.parallel.pipeline import pipeline_forward
    cfg = dataclasses.replace(C.get_config(PIPE["arch"]), dtype=dtype_name)
    n_micro, mb, S = PIPE["n_micro"], PIPE["mb"], PIPE["seq"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = T.init_params(gen, cfg, device=DEVICE)
    toks = torch.randint(0, cfg.vocab_size, (n_micro * mb, S), generator=gen,
                         device=DEVICE)
    calls = [0]

    def layers(blocks, h):
        calls[0] += 1
        if control == "skip_microbatch" and calls[0] == 2:
            return h
        pos = torch.arange(S, device=DEVICE).expand(h.shape[0], S)
        for blk in blocks:
            h = T._block_apply(cfg, blk, h, pos)
        return h

    def beyond(a, b, lim):
        """The share of elements of ``a`` beyond rtol = atol = ``lim`` of
        ``b``."""
        return float(((a - b).abs() > lim + lim * b.abs()).float().mean())

    with torch.no_grad():
        x = params.embed[toks].reshape(n_micro, mb, S, -1)
        reset_counts()
        with parallel_control(control):
            out = pipeline_forward(layers, params.blocks, x, mesh, 1)
        sync(torch)
        launched = counts()
        each = torch.stack([layers(params.blocks, xm) for xm in x])
        whole = layers(params.blocks, x.reshape(n_micro * mb, S, -1)
                       ).reshape(out.shape)
        # which op of the first layer depends on the number of rows
        blk = params.blocks[0]
        lay, a = blk["l0"], blk["l0"].attn
        xw = x.reshape(n_micro * mb, S, -1)
        hw = rms_norm(xw, lay.norm1)
        qkv = [(hw @ a[w] + a["b" + w[1]]).reshape(
            n_micro * mb, S, -1, cfg.resolved_head_dim) for w in
            ("wq", "wk", "wv")]
        act = F.silu(hw @ lay.ffn["w_gate"]) * (hw @ lay.ffn["w_up"])
        ops = {"rmsnorm": (lambda t: rms_norm(t, lay.norm1), [xw])}
        ops.update({f"h @ {w}": ((lambda t, w=w: t @ a[w]), [hw])
                    for w in ("wq", "wk", "wv", "wo")})
        ops.update({f"h @ {w}": ((lambda t, w=w: t @ lay.ffn[w]), [hw])
                    for w in ("w_gate", "w_up")})
        ops["a @ w_down"] = (lambda t: t @ lay.ffn["w_down"], [act])
        ops["flash"] = (lambda *t: flash_attention(*t, causal=True)[0], qkv)
        ops["layer 0"] = (lambda t: layers(params.blocks[:1], t), [xw])
        bitwise = {name: float((f(*ts) != torch.cat([
            f(*(t[i:i + mb] for t in ts)) for i in range(0, n_micro * mb,
                                                         mb)]))
            .float().mean()) for name, (f, ts) in ops.items()}
    want = (2 * cfg.block_repeat * n_micro, 0, cfg.block_repeat * n_micro,
            0)
    if launched != want and control is None:
        fail(f"parallel: pipeline launches {launched}, expected {want}")
    if not bool(torch.isfinite(out).all()):
        fail("parallel: pipeline: non-finite output")
    scale = float(whole.float().abs().max())
    hold = holds(dtype_name, control, limits_run)
    err = float((out.float() - each.float()).abs().max())
    fp32 = dtype_name == "float32"
    if fp32 and hold:
        lim = PARALLEL_FP32["pipeline"]
        share = beyond(out, each, lim)
        if share:
            fail(f"parallel: pipeline schedule check fp32: {share:.2e} of "
                 f"elements beyond rtol = atol = {lim} of the microbatches "
                 f"run in turn")
        text = (f"schedule check (vs each microbatch in turn) max_abs_err "
                f"{err:.3e} within rtol = atol = {lim} elementwise")
    else:
        text = held("schedule check (vs each microbatch in turn) "
                    "max_abs_err / max|x|", err / scale,
                    PARALLEL_BF16["pipeline"], hold)
    rel = float((out.float() - whole.float()).abs().max()) / scale
    plain_rel = float((each.float() - whole.float()).abs().max()) / scale
    limits = PARALLEL_FP32 if fp32 else PARALLEL_BF16
    text += "; " + held("vs the whole batch in one run max_abs_err / "
                        "max|x|", rel, limits["pipeline_whole"], hold)
    text += (f" (two plain runs, whole batch vs each microbatch: "
             f"{plain_rel:.3e})")
    if fp32:
        lim = PARALLEL_FP32["pipeline"]
        piped, plain = beyond(out, whole, lim), beyond(each, whole, lim)
        if hold and piped > plain:
            fail(f"parallel: pipeline fp32: {piped:.4%} of elements beyond "
                 f"rtol = atol = {lim} of the whole batch, the plain "
                 f"microbatches {plain:.4%}")
        text += (f" | beyond the CPU tests' rtol = atol = {lim} of the whole "
                 f"batch: pipeline {piped:.4%}"
                 f"{' (limit: the plain microbatches)' if hold else ''}, "
                 f"plain microbatches {plain:.4%} | not "
                 f"bit-equal, whole batch vs microbatches, first layer: "
                 + ", ".join(f"{k} {v:.4%}" for k, v in bitwise.items()))
    say("parallel", f"pipeline {PIPE['arch']} FULL {cfg.block_repeat} layers "
        f"as one stage, {n_micro} microbatches of ({mb}, {S}) {dtype_name} "
        f"seed {seed}{f' control {control}' if control else ''}: {text} "
        f"(max|x| {scale:.3e}) | launches rmsnorm {launched[0]}, flash "
        f"{launched[2]}")
    return dict(err=rel, launched=launched)


def padding_case(torch, dtype_name: str, seed: int) -> tuple:
    """qwen1.5-32b FULL width at depth 2, its 40 heads padded to 48
    (``pad_attention_heads``): prompts replayed by ``prefill``, then
    decode steps, padded against unpadded, both through the kernels, held
    to LOGIT_TOL and ARGMAX_FLOOR.  Returns the padded run's launches."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.parallel.padding import pad_attention_heads
    cfg = dataclasses.replace(C.at_depth(C.get_config(PAD["arch"]),
                                         PAD["depth"]), dtype=dtype_name)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = T.init_params(gen, cfg, device=DEVICE)
    padded, pcfg = pad_attention_heads(params, cfg)
    lens = torch.tensor(PAD["lengths"], dtype=torch.int32, device=DEVICE)
    B, S = len(PAD["lengths"]), max(PAD["lengths"])
    toks = torch.randint(0, cfg.vocab_size, (B, S + PAD["steps"]),
                         generator=gen, device=DEVICE, dtype=torch.int32)
    runs = []
    for p, c in ((params, cfg), (padded, pcfg)):
        reset_counts()
        logits, cache = T.prefill(p, c, toks[:, :S], PAD["max_len"],
                                  lengths=lens)
        seen = [logits]
        for s in range(PAD["steps"]):
            logits, cache = T.decode_step(p, c, toks[:, S + s:S + s + 1],
                                          cache)
            seen.append(logits)
        sync(torch)
        runs.append((torch.stack(seen).float(), counts()))
    (plain, _), (pad, launched) = runs
    steps = S + PAD["steps"]
    want = (steps * (2 * cfg.n_layers + 1), steps * cfg.n_layers, 0, 0)
    if launched != want:
        fail(f"parallel: padded decode launches {launched}, expected {want}")
    if not bool(torch.isfinite(pad).all()):
        fail("parallel: padded decode: non-finite logits")
    err = float((pad - plain).abs().max())
    agree = int((pad.argmax(-1) == plain.argmax(-1)).sum())
    rows = pad.shape[0] * pad.shape[1]
    if err > LOGIT_TOL[dtype_name] or agree < ARGMAX_FLOOR[dtype_name] * rows:
        fail(f"parallel: padded logits {err:.3e} (tol "
             f"{LOGIT_TOL[dtype_name]}), argmax {agree}/{rows}")
    say("parallel", f"padding {PAD['arch']} FULL width depth "
        f"{PAD['depth']} ({cfg.n_heads} -> {pcfg.n_heads} q / "
        f"{cfg.n_kv_heads} -> {pcfg.n_kv_heads} kv heads) {dtype_name}: "
        f"{B} prompts (lengths {PAD['lengths']}) replayed, {PAD['steps']} "
        f"steps | logits padded vs unpadded max_abs_err {err:.3e} (tol "
        f"{LOGIT_TOL[dtype_name]}, max|logit| {float(plain.abs().max()):.3e})"
        f", argmax agree {agree}/{rows} | padded run launches rmsnorm "
        f"{launched[0]}, decode {launched[1]} (group "
        f"{pcfg.n_heads // pcfg.n_kv_heads}, D {pcfg.resolved_head_dim})")
    return launched


def compress_case(torch, smi: str) -> None:
    """A full-width fp32 gradient tree (qwen2-0.5b FULL's parameter
    shapes) through ``compress_tree``: every leaf's error within its
    scale (+ 1e-7, the CPU test's bound); one leaf's mean over 64 draws
    within the reference test's unbiasedness bound; the bytes ratio."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.training import compress
    cfg = C.get_config(COMPRESS_ARCH)
    shapes = {n: t.shape for n, t in T.init_params(
        torch.Generator(), cfg, device="meta").named_parameters()}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    grads = {n: torch.randn(s, generator=gen, device=DEVICE) * 1e-2
             for n, s in shapes.items()}
    n_values = sum(g.numel() for g in grads.values())
    sync(torch)
    t0 = time.perf_counter()
    codes, scales = compress.compress_tree(grads, gen)
    sync(torch)
    ms = (time.perf_counter() - t0) * 1e3
    back = compress.decompress_tree(codes, scales)
    worst = 0.0
    for n, g in grads.items():
        e = float((back[n] - g).abs().max())
        s = float(scales[n])
        if not e <= s + 1e-7:
            fail(f"parallel: compress {n}: error {e:.3e} beyond scale {s:.3e}")
        worst = max(worst, e / s)
    del back
    name = "blocks.0.l0.ffn.w_up"
    x = grads[name]
    acc = torch.zeros_like(x)
    for _ in range(64):
        q, s = compress.quantize_int8(x, gen)
        acc += compress.dequantize_int8(q, s)
    bias = float((acc / 64 - x).abs().max())
    scale = float(x.abs().max()) / 127.0
    limit = 4 * scale / math.sqrt(64) + 1e-6
    if not bias < limit:
        fail(f"parallel: compress {name}: mean of 64 draws off by "
             f"{bias:.3e}, limit {limit:.3e}")
    sent = sum(c.numel() for c in codes.values()) + 4 * len(scales)
    say("parallel", f"compress {COMPRESS_ARCH} FULL gradient tree "
        f"({len(grads)} leaves, {n_values} values) fp32 on {smi}: "
        f"compress_tree {ms:.1f} ms wall | worst error / scale {worst:.4f} "
        f"(limit 1 + 1e-7 / scale) | {name} {tuple(x.shape)} mean of 64 "
        f"draws off by {bias:.3e} (limit {limit:.3e}) | bytes {sent} vs "
        f"fp32 {4 * n_values} ({sent / (4 * n_values):.4f}) and bf16 "
        f"{2 * n_values} ({sent / (2 * n_values):.4f})")


def plan_elastic_case(torch) -> None:
    """``plan_to_shardings`` of a world-size-1 scheme (mesh {"data": 1,
    "model": 1}; an 8-device scheme must raise), then qwen2-0.5b FULL's
    parameters through ``reshard_state`` onto the plan's CUDA mesh and
    again (the second gathers the DTensors first), bit-exact."""
    import types

    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.parallel.plan_sharding import plan_to_shardings
    from repro_torch.parallel.sharding import axis_sizes
    from repro_torch.training.elastic import reshard_state
    cfg = C.get_config(COMPRESS_ARCH)
    params = T.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                           cfg, device=DEVICE)
    one = types.SimpleNamespace(model_dp=1, pp_stages=1, stage_devices=1,
                                total_devices=1)
    mat = plan_to_shardings(one, cfg, params, device=DEVICE)
    if axis_sizes(mat.mesh) != {"data": 1, "model": 1} or \
            mat.needs_pipeline or mat.mesh.device_type != DEVICE:
        fail(f"parallel: plan mesh {mat.mesh}")
    try:
        plan_to_shardings(types.SimpleNamespace(
            model_dp=2, pp_stages=1, stage_devices=4, total_devices=8),
            cfg, params, device=DEVICE)
        fail("parallel: an 8-device plan did not raise on one rank")
    except ValueError as e:
        refused = str(e)
    state = {n: p.detach() for n, p in params.named_parameters()}
    t0 = time.perf_counter()
    on = reshard_state(state, mat.param_specs, mat.mesh)
    again = reshard_state(on, mat.param_specs, mat.mesh)
    sync(torch)
    ms = (time.perf_counter() - t0) * 1e3
    bad = [n for n, t in state.items()
           if not torch.equal(again[n].full_tensor(), t)]
    if bad:
        fail(f"parallel: elastic round trip changed {bad[:3]}")
    say("parallel", f"plan/elastic: world-size-1 scheme -> mesh "
        f"{axis_sizes(mat.mesh)} on {mat.mesh.device_type}, "
        f"{len(mat.param_specs)} specs; 8-device scheme refused ("
        f"{refused.split(' — ')[0]}) | {COMPRESS_ARCH} FULL's "
        f"{len(state)} parameters onto the mesh and again in "
        f"{ms:.1f} ms wall, bit-exact")


def parallel_phase(torch, F, smi: str, limits_run: bool = False) -> tuple:
    """The parallel layer (``repro_torch.parallel``, ``training.compress``
    and ``elastic``) at world size 1 through NCCL on the card: EP, SP
    decode, pipeline, padding, compression, plan and elastic resharding
    (one line per case).  ``limits_run`` (``--limits parallel``) reads
    seeds 0-2 and the controls of PARALLEL_CONTROLS in both dtypes and
    holds nothing in bf16.  Destroys its process group at the end.
    Returns (results, the pipeline run's launches, the padded decode
    run's launches, the SP decode run's decode launches)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import make_pp_mesh
    t0 = time.perf_counter()
    cuda = DEVICE == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device(DEVICE, 0) if cuda
                            else None,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), DEVICE)
        pp_mesh = make_pp_mesh(1, tp=1, device=DEVICE)
        seeds = range(3) if limits_run else range(1)
        sp = None
        runs = [(s, None) for s in seeds] + (
            [(0, c) for c in PARALLEL_CONTROLS] if limits_run else [])
        for dtype_name in ("float32", "bfloat16"):
            for seed, control in runs:
                timed = (dtype_name == "bfloat16" and seed == 0
                         and control is None and not limits_run)
                kw = dict(seed=seed, control=control, limits_run=limits_run)
                if control in (None, "drop_expert",
                               "gates_not_renormalised"):
                    for arch, shape in EP_CASES:
                        ep_case(torch, arch, shape, dtype_name, mesh,
                                timed=timed, **kw)
                if control in (None, "skip_last_slot"):
                    r = sp_case(torch, F, dtype_name, mesh, timed=timed,
                                **kw)
                    if timed:
                        sp = r
                if control in (None, "skip_microbatch"):
                    r = pipeline_case(torch, dtype_name, pp_mesh, **kw)
                    if control is None and seed == 0:
                        piped = r["launched"]
                torch.cuda.empty_cache()
            padded = padding_case(torch, dtype_name, 0)
            torch.cuda.empty_cache()
        compress_case(torch, smi)
        plan_elastic_case(torch)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    results = {}
    if not limits_run:
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        results[("decode_attention", SP_DECODE, "sp", "bfloat16")] = sp
        results[("rmsnorm", PIPE_NORM, "bfloat16")] = rmsnorm_case(
            torch, F, PIPE_NORM, "bfloat16", gen)
        results[(PIPE_FLASH, "bfloat16")] = flash_case(
            torch, F, PIPE_FLASH, "bfloat16", gen)
        results[("rmsnorm", PAD_NORM, "bfloat16")] = rmsnorm_case(
            torch, F, PAD_NORM, "bfloat16", gen)
        results[("decode_attention", PAD_DECODE, "bfloat16")] = \
            attention_case(torch, F, PAD_DECODE,
                           [n + PAD["steps"] for n in PAD["lengths"]],
                           "bfloat16", gen)
    say("parallel", f"phase {time.perf_counter() - t0:.1f} s on {smi}")
    return results, piped, padded, None if sp is None else sp["launched"]


# -- 19. fp8 KV caches --------------------------------------------------------

# the e4m3 decode instance (q and output bf16, k/v float8_e4m3fn, head
# dim 128): groups 1/5/8 over 4 slots of 4096, and cold over 32768
FP8_DECODE = tuple((4, 8 * g, 8, 128, 4096) for g in (1, 5, 8))
FP8_DECODE_LONG = tuple((4, 8 * g, 8, 128, 32768) for g in (1, 5, 8))
FP8_LENGTHS = [1, 77, 3000, 4096]
# qwen1.5-32b at full width (d 5120, 40 q and 40 kv heads of 128: group
# 1) served through an fp8 cache of batch 8 x Smax 32768 at 8 layers:
# 21.5 GB of e4m3 K/V (43 GB in bf16), the weights 11.3 GB; the rows'
# lengths spread over the cache, seeded random K/V below them
FP8_SERVE = dict(arch="qwen1.5-32b", depth=8, batch=8, smax=32768,
                 lengths=[32760, 30000, 24576, 16384, 8192, 4096, 1024, 1],
                 steps=4)
FP8_SERVE_DECODE = (8, 40, 40, 128, 32768)
FP8_SERVE_NORM = (8, 1, 5120)


def fp8_attention_case(torch, F, shape, lengths, gen, timed: bool = True,
                       copies: int = 1) -> dict:
    """The e4m3 instance against ``decode_attention_plain`` on the same
    e4m3 bits (seeded K/V cast by ``to_cache_dtype``), held to the bf16
    TOL.  Timed: the kernel beside its plain version, the bf16 instance
    on the exact bf16 upcast of the same cache, and, as context only (no
    PyTorch attention takes e4m3 K/V, so the record's library time is
    none), SDPA on that upcast repeated to Hq heads.  The bound reads the
    cache at one byte a value."""
    from repro_torch.device import to_cache_dtype
    from repro_torch.kernels import decode_attention as da
    B, Hq, Hkv, D, smax = shape
    q, k, v, lens = attention_inputs(torch, B, Hq, Hkv, D, smax, lengths,
                                     torch.bfloat16, gen)
    fp8 = torch.float8_e4m3fn
    k, v = to_cache_dtype(k, fp8), to_cache_dtype(v, fp8)
    before = dict(da.variant_launches)
    got = da.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    key = (D, Hq // Hkv, "e4m3")
    if da.variant_launches.get(key, 0) != before.get(key, 0) + 1:
        fail(f"fp8 decode {shape}: no launch on the {key} instance")
    what = f"decode_attention e4m3 {shape} lengths {lengths}"
    err, differ = compare(torch, got,
                          da.decode_attention_plain(q, k, v, lens),
                          "bfloat16", what)
    if not timed:
        return dict(max_abs_err=err, differ=differ)
    kvs = [(k, v)] + [tuple(to_cache_dtype(torch.randn(
        t.shape, generator=gen, device="cuda"), fp8) for t in (k, v))
        for _ in range(copies - 1)]
    ms = time_ms(torch, in_turn(
        lambda kk, vv: da.decode_attention(q, kk, vv, lens), kvs))
    # the plain version and SDPA take up to ~30 ms a call here: fewer
    # samples keep the phase short (they are context, not the kernel)
    plain_ms = time_ms(torch, in_turn(
        lambda kk, vv: da.decode_attention_plain(q, kk, vv, lens), kvs),
        inner=2, reps=5)
    up = [tuple(t.to(torch.bfloat16) for t in pair) for pair in kvs]
    bf16_ms = time_ms(torch, in_turn(
        lambda kk, vv: da.decode_attention(q, kk, vv, lens), up))
    rep = Hq // Hkv
    sdpa_kvs = [tuple(t.repeat_interleave(rep, dim=2).transpose(1, 2)
                      .contiguous() for t in pair) for pair in up]
    del up
    mask = (torch.arange(smax, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    sdpa_ms = time_ms(torch, in_turn(
        lambda ks, vs: F.scaled_dot_product_attention(
            q[:, :, None, :], ks, vs, attn_mask=mask), sdpa_kvs),
        inner=2, reps=5)
    del kvs, sdpa_kvs
    n_kv = sum(min(max(n, 0), smax) for n in lengths)
    nbytes = n_kv * Hkv * 2 * D + 2 * 2 * B * Hq * D + 4 * B
    bound_ms, bound_by = bound(nbytes, n_kv * Hq * 4.0 * D)
    cold = f"; {copies} caches in turn, read cold" if copies > 1 else ""
    say("fp8", f"decode_attention e4m3 q {(B, Hq, D)} k/v "
        f"{(B, smax, Hkv, D)} lengths {lengths}: max_abs_err {err:.3e} "
        f"({tol_text('bfloat16')}), not bit-equal {differ:.2e} | kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms, bf16 instance on the upcast "
        f"{bf16_ms:.4f} ms, library none (SDPA on the bf16 upcast, context "
        f"only: {sdpa_ms:.4f} ms) bound {bound_ms:.5f} ms ({bound_by}, "
        f"{nbytes} B at 1 B a K/V value{cold})")
    return dict(max_abs_err=err, differ=differ, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                bf16_ms=bf16_ms, sdpa_upcast_ms=sdpa_ms)


def fp8_kernel_cases(torch, F) -> dict:
    """The e4m3 instance at groups 1/5/8: Smax 4096 and cold 32768, timed;
    the split grid's edges at Smax 1000 and the serve shape, untimed."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape in FP8_DECODE:
        results[("decode_attention", shape, "fp8")] = fp8_attention_case(
            torch, F, shape, FP8_LENGTHS, gen)
    for shape in FP8_DECODE_LONG:
        results[("decode_attention", shape, "fp8")] = fp8_attention_case(
            torch, F, shape, DECODE_LONG_LENGTHS, gen, copies=3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, n = 0.0, 0
    for group in (1, 5, 8):
        span, _ = da.split_plan(DECODE_EDGE_SMAX, 8, sms)
        r = fp8_attention_case(torch, F, (4, 2 * group, 2, 128,
                                          DECODE_EDGE_SMAX),
                               [span, span + 1, 3 * span, DECODE_EDGE_SMAX],
                               gen, timed=False)
        worst, n = max(worst, r["max_abs_err"]), n + 1
    say("fp8", f"decode_attention e4m3 split edges: {n} cases (group "
        f"1/5/8, Smax {DECODE_EDGE_SMAX}, lengths span, span + 1, 3 span, "
        f"Smax) all within tolerance, worst max_abs_err {worst:.3e}")
    return results


def fp8_fill(torch, cache: dict, gen, dtype) -> None:
    """Seeded N(0, 1) K/V in every layer of ``cache``, cast by
    ``to_cache_dtype`` one batch row at a time (a row of one layer is
    168 MB of e4m3 here)."""
    from repro_torch.device import to_cache_dtype
    for t in cache_leaves(cache):
        for r in range(t.shape[0]):
            for b in range(t.shape[1]):
                t[r, b].copy_(to_cache_dtype(torch.randn(
                    t.shape[2:], generator=gen, device=DEVICE), dtype))


def fp8_serve_phase(torch, F, smi: str) -> tuple:
    """qwen1.5-32b at full width through an e4m3 KV cache (FP8_SERVE):
    the kernel at the serve shape timed; ``decode_step`` kernels vs plain
    versions on the same cache, held to LOGIT_TOL and ARGMAX_FLOOR, every
    decode launch on the e4m3 instance; the step's device time beside
    that of a bf16 cache of the same shape; the fp8-vs-bf16 cache
    difference of the logits printed, not held.  Returns (results, the
    kernel run's launches)."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spec = FP8_SERVE
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    results = {("decode_attention", FP8_SERVE_DECODE, "fp8"):
               fp8_attention_case(torch, F, FP8_SERVE_DECODE,
                                  spec["lengths"], gen)}
    results[("rmsnorm", FP8_SERVE_NORM, "bfloat16")] = rmsnorm_case(
        torch, F, FP8_SERVE_NORM, "bfloat16", gen)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(
        C.at_depth(C.get_config(spec["arch"]), spec["depth"]),
        dtype="bfloat16")
    params = T.init_params(gen, cfg, device=DEVICE)
    B, steps = spec["batch"], spec["steps"]
    lengths = torch.tensor(spec["lengths"], dtype=torch.int32, device=DEVICE)
    toks = torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    per_step = decode_launches_per_step(cfg)
    # (head dim, group, cache type): (128, 1, "e4m3") at full width
    instance = (cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads, "e4m3")
    runs = {}
    for cache_dtype in (torch.float8_e4m3fn, torch.bfloat16):
        cache = T.init_cache(cfg, B, spec["smax"], device=DEVICE,
                             cache_dtype=cache_dtype)
        fp8_fill(torch, cache, torch.Generator(device=DEVICE).manual_seed(1),
                 cache_dtype)
        gb = sum(t.numel() * t.element_size()
                 for t in cache_leaves(cache)) / 1e9
        out = {}
        for mode in (("kernels", "plain") if cache_dtype ==
                     torch.float8_e4m3fn else ("kernels",)):
            cache["len"] = lengths.clone()
            reset_counts()
            logits = []
            with (plain_kernels() if mode == "plain"
                  else contextlib.nullcontext()):
                for s in range(steps):
                    lg, cache = T.decode_step(params, cfg, toks[s], cache)
                    logits.append(lg.float())
            sync(torch)
            if mode == "kernels":
                launched = counts()
                want = tuple(steps * n for n in per_step)
                if launched != want:
                    fail(f"fp8-serve: launches {launched}, expected {want}")
                inst = decode_instances()
                if cache_dtype == torch.float8_e4m3fn and set(inst) != {
                        instance}:
                    fail(f"fp8-serve: decode launches {inst}, expected all "
                         f"on {instance}")
            elif any(counts()):
                fail("fp8-serve: the plain run launched a kernel")
            out[mode] = torch.stack(logits)
        cache["len"] = lengths.clone()
        step_ms = time_ms(torch, lambda: T.decode_step(params, cfg, toks[0],
                                                       cache),
                          inner=2, reps=3)
        runs[cache_dtype] = dict(out, ms=step_ms, gb=gb, launched=launched)
        del cache
        torch.cuda.empty_cache()
    f8, b16 = runs[torch.float8_e4m3fn], runs[torch.bfloat16]
    kern, plain = f8["kernels"], f8["plain"]
    if not bool(torch.isfinite(kern).all()):
        fail("fp8-serve: non-finite logits")
    err = float((kern - plain).abs().max())
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    if err > LOGIT_TOL["bfloat16"] or agree < ARGMAX_FLOOR["bfloat16"]:
        fail(f"fp8-serve: logits kernels vs plain max abs {err:.3e} (limit "
             f"{LOGIT_TOL['bfloat16']}), argmax agreement {agree:.3f} "
             f"(floor {ARGMAX_FLOOR['bfloat16']})")
    q_err = float((kern - b16["kernels"]).abs().max())
    q_agree = float((kern.argmax(-1) == b16["kernels"].argmax(-1))
                    .float().mean())
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    # a decode step reads the weights once and each row's valid K/V
    n_kv = sum(min(n + 1, spec["smax"]) for n in spec["lengths"])
    kv_gb = n_kv * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * \
        cfg.n_layers / 1e9
    say("fp8-serve", f"{spec['arch']} FULL width ({cfg.n_layers} of "
        f"{C.get_config(spec['arch']).n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads "
        f"of {cfg.resolved_head_dim}) bf16, batch {B} x Smax "
        f"{spec['smax']}, lengths {spec['lengths']}: e4m3 cache "
        f"{f8['gb']:.1f} GB (bf16 {b16['gb']:.1f} GB), weights "
        f"{weights_gb:.1f} GB | {steps} decode steps kernels vs plain: "
        f"logits max abs {err:.3e} (limit {LOGIT_TOL['bfloat16']}), argmax "
        f"agreement {agree:.3f} (floor {ARGMAX_FLOOR['bfloat16']}); "
        f"launches {f8['launched']} ({steps} steps), every decode attention "
        f"on {instance} | fp8 vs bf16 cache (not held): logits max abs "
        f"{q_err:.3e}, argmax agreement {q_agree:.3f} | decode step device "
        f"{f8['ms']:.3f} ms (e4m3 cache) vs {b16['ms']:.3f} ms (bf16 cache); "
        f"reading the weights and the valid K/V once takes "
        f"{(weights_gb + kv_gb) * 1e9 / HBM_BYTES_PER_S * 1e3:.3f} ms "
        f"(e4m3) and "
        f"{(weights_gb + 2 * kv_gb) * 1e9 / HBM_BYTES_PER_S * 1e3:.3f} ms "
        f"(bf16) | phase {time.perf_counter() - t0:.1f} s on {smi}")
    del params
    torch.cuda.empty_cache()
    return results, f8["launched"]


# -- 20. dry-run --------------------------------------------------------------

# the dry-run cell the card runs for real: qwen2-0.5b FULL training at
# batch 8 x 2048 (one microbatch, as the dry-run trains it), on a (1, 1)
# mesh of one NCCL rank
DRYRUN_CELL = dict(arch="qwen2-0.5b", seq=2048, batch=8)
DRYRUN_NORM = (8, 2048, 896)
DRYRUN_FLASH = (8, 2048, 2048, 14, 2, 64, None, 0)


def event_ms(torch, fn) -> float:
    """Device ms of one call between two CUDA events (wall ms on the
    CPU)."""
    if DEVICE != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


@contextlib.contextmanager
def wrapper_calls(calls: dict):
    """Count the calls of each kernel wrapper (also on meta tensors, where
    nothing launches), by module name."""
    mods = kernel_modules()
    names = ("rms_norm", "decode_attention", "flash_attention", "ssd_scan")
    with contextlib.ExitStack() as stack:
        for mod, name in zip(mods, names):
            fn = getattr(mod, name)

            def counting(*a, _fn=fn, _key=mod.__name__, **k):
                calls[_key] = calls.get(_key, 0) + 1
                return _fn(*a, **k)

            stack.enter_context(mock.patch.object(mod, name, counting))
        yield calls


def dryrun_phase(torch, F, smi: str) -> tuple:
    """``launch.dryrun.lower_cell`` at world size 1 (NCCL, a (1, 1) mesh)
    for DRYRUN_CELL, then the same step run for real on the card through
    the kernels, as DTensors on that mesh: the dry-run's per-device bytes
    beside ``max_memory_allocated``, its dot FLOPs beside the step's
    device time (achieved TFLOP/s against the bf16 peak), and the step's
    kernel launches against the wrapper calls the trace made.  The memory
    model's error is printed, not held.  Returns the real step's
    launches and the timed kernel cases at its shapes."""
    import datetime

    import torch.distributed as dist

    from repro_torch import configs as C
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, mesh_context
    from repro_torch.launch.shapes import ShapeCell, input_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import (distribute_params,
                                               param_pspecs,
                                               spec_to_placements)
    from repro_torch.training.optimizer import adamw_init
    t0 = time.perf_counter()
    cuda = DEVICE == "cuda"
    torch.cuda.empty_cache()
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device(DEVICE, 0) if cuda
                            else None,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), DEVICE)
        spec = DRYRUN_CELL
        cell = ShapeCell("train_smoke", spec["seq"], spec["batch"], "train")
        traced = {}
        reset_counts()
        with wrapper_calls(traced):
            rec = dryrun.lower_cell(spec["arch"], cell.name, mesh, cell=cell,
                                    device_bytes=None if cuda else 80e9)
        if any(counts()):
            fail(f"dryrun: the trace launched kernels {counts()}")
        cfg = C.get_config(spec["arch"])
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        params = T.init_params(gen, cfg, device=DEVICE)
        distribute_params(params, param_pspecs(params, cfg, mesh, fsdp=True),
                          mesh)
        opt = adamw_init(params)
        specs = input_specs(cfg, cell)
        from torch.distributed.tensor import distribute_tensor
        batch = {k: distribute_tensor(torch.randint(
            0, cfg.vocab_size, x.shape, generator=gen, device=DEVICE,
            dtype=x.dtype), mesh, spec_to_placements(("data", None), mesh))
            for k, x in specs.items()}
        step = make_train_step(cfg, microbatches=1, remat=True)
        with mesh_context(mesh):
            params, opt, m = step(params, opt, batch)       # warm-up
            sync(torch)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            step_ms = event_ms(torch, lambda: step(params, opt, batch))
        peak = torch.cuda.max_memory_allocated()
        launched = counts()
        loss = float(m["loss"].full_tensor())
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        timed = {("rmsnorm", DRYRUN_NORM, "bfloat16"): rmsnorm_case(
            torch, F, DRYRUN_NORM, "bfloat16", gen),
            (DRYRUN_FLASH, "bfloat16"): flash_case(
                torch, F, DRYRUN_FLASH, "bfloat16", gen)} if cuda else {}
        if not math.isfinite(loss):
            fail(f"dryrun: the real step's loss is {loss}")
        names = [mod.__name__ for mod in kernel_modules()]
        seen = tuple(traced.get(n, 0) for n in names)
        # the trace reaches each wrapper once a call; a real step launches
        # once a call too (the backward is plain PyTorch)
        if launched != seen:
            fail(f"dryrun: the real step launched {launched} (rmsnorm, "
                 f"decode, flash, ssd), the trace called the wrappers "
                 f"{seen} times")
        del params, opt, batch
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    tflops = rec["dot_flops"] / (step_ms * 1e-3) / 1e12
    say("dryrun", f"lower_cell {spec['arch']} train B {spec['batch']} x S "
        f"{spec['seq']} on a (1, 1) NCCL mesh: trace {rec['trace_s']} s, "
        f"dot_flops {rec['dot_flops']:.4e}, argument bytes "
        f"{rec['argument_bytes'] / 1e9:.3f} GB + workspace model "
        f"{rec['workspace_model'] / 1e9:.3f} GB = per-device "
        f"{rec['per_device_bytes'] / 1e9:.3f} GB (fits "
        f"{rec['device_bytes'] / 1e9:.1f} GB: {rec['fits']}) | the step on "
        f"the card: loss {loss:.4f}, max_memory_allocated "
        f"{peak / 1e9:.3f} GB (the model's error "
        f"{(rec['per_device_bytes'] - peak) / peak:+.1%}), device "
        f"{step_ms:.1f} ms, so {tflops:.1f} TFLOP/s of matrix products, "
        f"{tflops / (BF16_FLOPS / 1e12):.1%} of the {BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s bf16 peak; launches {launched} = the trace's wrapper "
        f"calls | phase {time.perf_counter() - t0:.1f} s on {smi}")
    return launched, timed


def phase_seconds(marks: list) -> str:
    """``marks`` ([(phase, perf_counter at its end)], the script's start
    first): each phase's seconds and the whole."""
    return ", ".join(f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in
                     zip(marks, marks[1:])) + \
        f" | total {marks[-1][1] - marks[0][1]:.1f} s"


def main() -> int:
    marks = [("start", time.perf_counter())]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = probe(torch)
    mark("probe")
    build_phase()
    mark("build")
    if sys.argv[1:3] == ["--limits", "parallel"]:
        parallel_phase(torch, F, smi, limits_run=True)
        return 0
    if sys.argv[1:2] == ["--limits"]:
        limits_phase(torch, *sys.argv[2:3])
        return 0
    if sys.argv[1:2] == ["--profile"]:
        profile_phase(torch, F)
        return 0
    results = kernels_phase(torch, F)
    results.update(fp8_kernel_cases(torch, F))
    mark("kernels")
    model_phase(torch)
    mark("model")
    served, serve_report, serve_reqs = serve_phase(torch, smi, search=True)
    mark("serve")
    reduced_phase(torch, smi)
    mark("reduced")
    profiled, profile_results, samples = profile_phase(torch, F)
    results.update(profile_results)
    mark("profile")
    predict_phase(serve_report, serve_reqs, samples, smi)
    mark("predict")
    planned, plan_results = plan_modes_phase(torch, F, samples, smi)
    results.update(plan_results)
    mark("plan-modes")
    results.update(flash_phase(torch, F))
    mark("flash")
    trained = train_phase(torch, smi)
    train_parity_phase(torch)
    mark("train")
    results.update(ssd_phase(torch))
    mark("ssd")
    from repro_torch.kernels import ssd_scan
    mamba = train_phase(torch, smi, MAMBA_TRAIN, "mamba2")
    if ssd_scan.variant_launches["wgmma"] != mamba[3]:
        fail(f"mamba2: {ssd_scan.variant_launches} of {mamba[3]} SSD "
             f"launches were not on the tensor-core kernel")
    train_parity_phase(torch, MAMBA_TRAIN, MAMBA_TRAIN_TOL,
                       MAMBA_PARITY_DEPTH, "mamba2")
    mark("mamba2")
    mixtral = mixtral_phase(torch, smi)
    mark("mixtral")
    ssm_served = ssm_serve_phase(torch, smi)
    mark("ssm-serve")
    gemma_served, gemma_trained = gemma3_phase(torch, smi)
    mark("gemma3")
    deepseek_served, deepseek_results = deepseek_phase(torch, F, smi)
    results.update(deepseek_results)
    mark("deepseek")
    vl_decoded, vl_trained = qwen2vl_phase(torch, smi)
    mark("qwen2-vl")
    seamless_served, seamless_trained = seamless_phase(torch, smi)
    mark("seamless")
    zamba_served, zamba_trained = zamba2_phase(torch, smi)
    mark("zamba2")
    deepseek_trained = deepseek_train_phase(torch, smi)
    mark("deepseek-train")
    parallel_results, piped, padded, sp_launched = parallel_phase(
        torch, F, smi)
    results.update(parallel_results)
    mark("parallel")
    fp8_results, fp8_served = fp8_serve_phase(torch, F, smi)
    results.update(fp8_results)
    mark("fp8-serve")
    dry_launched, dry_results = dryrun_phase(torch, F, smi)
    results.update(dry_results)
    mark("dryrun")

    # one entry per kernel and path: the path's launches, read right after
    # its run, beside the kernel's numbers at that path's bf16 shape
    meta = {
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/rmsnorm.py:26"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cuh",
            "src/repro/kernels/decode_attention/decode_attention.py:76"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:95"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/ssd_scan.py:76"),
    }
    # the mamba2 serve step's RMSNorms run at two widths
    results[("rmsnorm", SSM_SERVE_NORMS, "bfloat16")] = launch_mix(
        results, [(("rmsnorm", shape, "bfloat16"), n)
                  for shape, n in SSM_SERVE_NORMS])
    # gemma3's decode attention runs over rings (local layers) and full
    # caches (global), its flash attention with the window and without:
    # weighted by the launches of each kind of slot
    from repro_torch import configs as C
    gemma = C.get_config("gemma3-12b")
    local = [s.window is not None for s in gemma.block_pattern]
    runs = layer_runs(gemma)
    results[("decode_attention", GEMMA_DECODE, "bfloat16")] = launch_mix(
        results, [(("decode_attention", shape, "bfloat16"),
                   sum(x == want for x in local) * gemma.block_repeat)
                  for shape, want in zip(GEMMA_DECODE, (True, False))])
    results[(GEMMA_FLASH, "bfloat16")] = launch_mix(
        results, [((case, "bfloat16"),
                   sum(n for x, n in zip(local, runs) if x == want))
                  for case, want in zip(GEMMA_FLASH, (True, False))])
    # seamless serving: RMSNorms of the encoder (4 x 1024 rows) and of the
    # decode steps; self- and cross-attention decode, one each a layer.
    # Its training: causal decoder self-attention, and the encoder's and
    # cross-attention's non-causal flash, by their launches a step
    scfg = C.get_config(SEAMLESS)
    enc = encode_launches(scfg)
    results[("rmsnorm", "seamless-serve", "bfloat16")] = launch_mix(
        results, [(("rmsnorm", SEAMLESS_NORM_TRAIN, "bfloat16"), enc[0]),
                  (("rmsnorm", SEAMLESS_NORM_SERVE, "bfloat16"),
                   seamless_served[0] - enc[0])])
    results[("decode_attention", SEAMLESS_DECODE, "bfloat16")] = launch_mix(
        results, [(("decode_attention", shape, "bfloat16"), 1)
                  for shape in SEAMLESS_DECODE])
    self_runs = 2 * scfg.block_repeat          # remat: each layer twice
    results[("seamless-train", "bfloat16")] = launch_mix(
        results, [((SEAMLESS_SELF, "bfloat16"), self_runs),
                  ((SEAMLESS_ENCODE, "non-causal", "bfloat16"),
                   2 * scfg.block_repeat + 2 * enc[1])])
    # zamba2's RMSNorms at d 3584 and at the gated norm's 7168, by their
    # launches: serving ZAMBA_SERVE_NORMS a step; training, per
    # microbatch, 3 runs of each Mamba2 layer (norm1 and the gated norm)
    # and 2 of the shared block (two norms) a repeat, and the final norm
    results[("rmsnorm", ZAMBA_SERVE_NORMS, "bfloat16")] = launch_mix(
        results, [(("rmsnorm", shape, "bfloat16"), n)
                  for shape, n in ZAMBA_SERVE_NORMS])
    zr = ZAMBA_TRAIN["depth"]
    results[("rmsnorm", "zamba2-train", "bfloat16")] = launch_mix(
        results, [(("rmsnorm", QWEN_VL_NORM_TRAIN, "bfloat16"),
                   18 * zr + 4 * zr + 1),
                  (("rmsnorm", ZAMBA_NORM_TRAIN, "bfloat16"), 18 * zr)])
    paths = (
        ("rmsnorm", "serve", ("rmsnorm", (4, 1, 896)), served[0]),
        ("decode_attention", "serve",
         ("decode_attention", (4, 14, 2, 64, 512)), served[1]),
        ("rmsnorm", "train", ("rmsnorm", (4, 1024, 896)), trained[0]),
        ("flash_attention", "train", (FLASH_MAIN,), trained[2]),
        ("rmsnorm", "mamba2_train", ("rmsnorm", (4, 1024, 5120)), mamba[0]),
        ("ssd_scan", "mamba2_train", ("ssd_scan", SSD_MAIN), mamba[3]),
        ("decode_attention", "profile",
         ("decode_attention", PROFILE_DECODE), profiled[1] - profiled[4]),
        ("decode_attention", "profile-mla",
         ("decode_attention", PROFILE_MLA_DECODE), profiled[4]),
        ("flash_attention", "profile", (PROFILE_FLASH,), profiled[2]),
        ("ssd_scan", "profile", ("ssd_scan", PROFILE_SSD), profiled[3]),
        ("decode_attention", "profile-archs",
         ("decode_attention", PROFILE_ARCHS_DECODE), profiled[6]),
        ("flash_attention", "profile-archs", (PROFILE_ARCHS_FLASH,),
         profiled[7]),
        ("ssd_scan", "profile-archs", ("ssd_scan", PROFILE_ARCHS_SSD),
         profiled[8]),
        ("rmsnorm", "mixtral-serve", ("rmsnorm", (4, 1, 4096)), mixtral[0]),
        ("decode_attention", "mixtral-serve",
         ("decode_attention", MIXTRAL_DECODE), mixtral[1]),
        ("rmsnorm", "ssm-serve", ("rmsnorm", SSM_SERVE_NORMS),
         ssm_served[0]),
        ("rmsnorm", "gemma3-serve", ("rmsnorm", GEMMA_NORM_SERVE),
         gemma_served[0]),
        ("decode_attention", "gemma3-serve",
         ("decode_attention", GEMMA_DECODE), gemma_served[1]),
        ("rmsnorm", "gemma3-train", ("rmsnorm", GEMMA_NORM_TRAIN),
         gemma_trained[0]),
        ("flash_attention", "gemma3-train", (GEMMA_FLASH,),
         gemma_trained[2]),
        ("rmsnorm", "deepseek-serve", ("rmsnorm", DEEPSEEK_NORM),
         deepseek_served[0]),
        ("decode_attention", "deepseek-serve",
         ("decode_attention", DEEPSEEK_DECODE), deepseek_served[1]),
        ("rmsnorm", "qwen2-vl-7b", ("rmsnorm", QWEN_VL_NORM_SERVE),
         vl_decoded[0]),
        ("decode_attention", "qwen2-vl-7b",
         ("decode_attention", QWEN_VL_DECODE), vl_decoded[1]),
        ("rmsnorm", "qwen2-vl-train", ("rmsnorm", QWEN_VL_NORM_TRAIN),
         vl_trained[0]),
        ("flash_attention", "qwen2-vl-train", (QWEN_VL_FLASH,),
         vl_trained[2]),
        ("flash_attention", "seamless-encode",
         (SEAMLESS_ENCODE, "non-causal"), seamless_served[2]),
        ("rmsnorm", "seamless-serve", ("rmsnorm", "seamless-serve"),
         seamless_served[0]),
        ("decode_attention", "seamless-serve",
         ("decode_attention", SEAMLESS_DECODE), seamless_served[1]),
        ("rmsnorm", "seamless-train", ("rmsnorm", SEAMLESS_NORM_TRAIN),
         seamless_trained[0]),
        ("flash_attention", "seamless-train", ("seamless-train",),
         seamless_trained[2]),
        ("rmsnorm", "zamba2-serve", ("rmsnorm", ZAMBA_SERVE_NORMS),
         zamba_served[0]),
        ("decode_attention", "zamba2-serve",
         ("decode_attention", ZAMBA_DECODE), zamba_served[1]),
        ("rmsnorm", "zamba2-train", ("rmsnorm", "zamba2-train"),
         zamba_trained[0]),
        ("flash_attention", "zamba2-train", (ZAMBA_FLASH,),
         zamba_trained[2]),
        ("ssd_scan", "zamba2-train", ("ssd_scan", ZAMBA_SSD),
         zamba_trained[3]),
        ("rmsnorm", "deepseek-train", ("rmsnorm", DEEPSEEK_NORM_TRAIN),
         deepseek_trained[0]),
        ("flash_attention", "deepseek-train", (DEEPSEEK_FLASH, "mla"),
         deepseek_trained[2]),
        ("rmsnorm", "parallel-pipeline", ("rmsnorm", PIPE_NORM), piped[0]),
        ("flash_attention", "parallel-pipeline", (PIPE_FLASH,), piped[2]),
        ("rmsnorm", "parallel-padding", ("rmsnorm", PAD_NORM), padded[0]),
        ("decode_attention", "parallel-padding",
         ("decode_attention", PAD_DECODE), padded[1]),
        ("decode_attention", "parallel-sp",
         ("decode_attention", SP_DECODE, "sp"), sp_launched),
        ("rmsnorm", "fp8-serve", ("rmsnorm", FP8_SERVE_NORM), fp8_served[0]),
        ("decode_attention", "fp8-serve",
         ("decode_attention", FP8_SERVE_DECODE, "fp8"), fp8_served[1]),
        ("rmsnorm", "dryrun-train", ("rmsnorm", DRYRUN_NORM),
         dry_launched[0]),
        ("flash_attention", "dryrun-train", (DRYRUN_FLASH,),
         dry_launched[2]),
        ("decode_attention", "plan-modes",
         ("decode_attention", PLAN_DECODE), planned[1]),
        ("flash_attention", "plan-modes", (PLAN_FLASH,), planned[2]),
    )
    kernels = []
    for name, path, key, n in paths:
        # the bf16 entry at the path's shape; the fp8 path's own key
        r = results[key] if key[-1] == "fp8" else results[(*key, "bfloat16")]
        source, replaces = meta[name]
        if key[-1] == "fp8":              # the e4m3 instance's own file
            source = "src/repro_torch/kernels/csrc/decode_attention_fp8.cu"
        kernels.append(dict(
            name=f"{name}/{path}", route="cuda", source=source,
            replaces=replaces, launches=n, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                 "bound_ms", "max_abs_err")):
            fail(f"kernels: non-finite number in {k}")
    mark("record")
    say("phases", "seconds by phase: " + phase_seconds(marks))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
