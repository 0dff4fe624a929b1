"""Parallel Scheme Generator — the paper's Algorithm 1 (§3.2.2).

Hierarchical top-down enumeration:

  model-level DP (replicas)  ->  pipeline stages  ->  per-cell cell-level DP
  ->  intra-cell TP/EP via Parallel Templates

with even-partitioning (divisor) constraints at every level.  The output is
a list of logical ``ParallelScheme``s — no physical devices assigned yet;
the Device Mapper (core/mapper.py) does that next.

Scaling note (paper challenge 2, "exponentially-growing design space"):
Algorithm 1 as printed iterates over each cell in the block.  For blocks
with many cells (gemma3's 6-layer local:global block has 12) a free per-cell
choice would be |options|^12.  We assign one scheme per cell *type* (all GQA
cells share a scheme, all MLP cells share a scheme, ...), which is exactly
the symmetry the paper's own Transformer-IR argument exploits — cells of the
same type are interchangeable — and keeps enumeration polynomial.

The port's copy of ``repro/core/planner.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Tuple

from .ir import Block, Cell, ModelIR
from .quant import QuantFormat, get_format
from .templates import CellScheme, schemes_for_cell


def divisors(n: int) -> List[int]:
    out = [d for d in range(1, int(n ** 0.5) + 1) if n % d == 0]
    out += [n // d for d in reversed(out) if d * d != n]
    return out


@dataclasses.dataclass(frozen=True)
class ParallelScheme:
    """A logical parallel scheme: the model mapped onto a logical device
    cluster (paper's two-stage mapping, first half)."""

    model: ModelIR
    model_dp: int                       # model replicas
    pp_stages: int                      # pipeline stages per replica
    cell_schemes: tuple                 # tuple[CellScheme] per cell in block
    quant: str = "fp16"

    @property
    def stage_devices(self) -> int:
        return max(s.devices for s in self.cell_schemes)

    @property
    def devices_per_replica(self) -> int:
        return self.stage_devices * self.pp_stages

    @property
    def total_devices(self) -> int:
        return self.devices_per_replica * self.model_dp

    @property
    def blocks_per_stage(self) -> int:
        return self.model.block.repeat // self.pp_stages

    def label(self) -> str:
        cells = ",".join(
            f"{s.cell.kind}:dp{s.dp}x{s.method or 'tp'}{s.shard}"
            for s in self.cell_schemes
        )
        return (f"DP{self.model_dp}xPP{self.pp_stages}x[{cells}]"
                f"@{self.quant}")

    def is_feasible_for_current_systems(self) -> bool:
        """The paper's 'Feasible Optimal' restriction (§4.2): current
        serving systems support uniform DP/PP/TP/EP but NOT cell-level DP
        or per-cell-type heterogeneous sharding."""
        if any(s.dp != 1 for s in self.cell_schemes):
            return False
        shards = {s.shard for s in self.cell_schemes}
        return len(shards) == 1

    # -- memory model ---------------------------------------------------------

    def weight_bytes_per_device(self) -> float:
        q = get_format(self.quant)
        per_block = sum(s.weight_bytes_per_device(q) for s in self.cell_schemes)
        total = per_block * self.blocks_per_stage
        # Embedding on the first stage, LM head on the last, vocab-sharded
        # across the stage's devices.  With PP > 1 each boundary stage holds
        # one table; with PP = 1 the same devices hold both.
        emb = self.model.embed_params() * q.weight_bytes
        if self.pp_stages > 1 and not self.model.tie_embeddings:
            emb /= 2
        total += emb / self.stage_devices
        if self.model.encoder is not None:
            total += (self.model.encoder.weight_bytes(q)
                      * self.model.encoder.repeat) / self.devices_per_replica
        return total

    def kv_bytes_per_token_per_device(self) -> float:
        q = get_format(self.quant)
        per_block = sum(s.kv_bytes_per_token_per_device(q)
                        for s in self.cell_schemes)
        return per_block * self.blocks_per_stage

    def state_bytes_per_seq_per_device(self) -> float:
        q = get_format(self.quant)
        per_block = sum(s.state_bytes_per_seq_per_device(q)
                        for s in self.cell_schemes)
        return per_block * self.blocks_per_stage

    def kv_token_capacity(self, hbm_bytes: float,
                          mem_util: float = 0.90,
                          workspace_frac: float = 0.05,
                          max_sequences: int = 512) -> int:
        """How many KV tokens one replica can hold (drives the Batching
        Module's admission decisions)."""
        budget = hbm_bytes * mem_util
        budget -= self.weight_bytes_per_device()
        budget -= hbm_bytes * workspace_frac
        budget -= self.state_bytes_per_seq_per_device() * max_sequences
        per_tok = self.kv_bytes_per_token_per_device()
        if budget <= 0:
            return 0
        if per_tok <= 0:
            return 10 ** 12  # attention-free: KV is not the binding constraint
        return int(budget / per_tok)


def generate_schemes(model: ModelIR, num_devices: int,
                     quant: str = "fp16",
                     max_model_dp: Optional[int] = None,
                     allow_cell_dp: bool = True,
                     max_schemes: int = 100000) -> List[ParallelScheme]:
    """Algorithm 1: enumerate parallel schemes for ``model`` on a logical
    cluster of ``num_devices`` devices."""
    n = num_devices
    block = model.block
    schemes: List[ParallelScheme] = []

    # Group block cells by type; each group gets one scheme choice.
    type_of_cell: List[int] = []
    groups: List[Cell] = []
    seen: Dict[tuple, int] = {}
    for c in block.cells:
        key = (c.kind, c.name)
        if key not in seen:
            seen[key] = len(groups)
            groups.append(c)
        type_of_cell.append(seen[key])

    for model_dp in divisors(n):                      # model-level DP
        if max_model_dp and model_dp > max_model_dp:
            continue
        m = n // model_dp                             # devices per replica
        for stages in divisors(m):                    # inter-layer (PP)
            if block.repeat % stages != 0:
                continue                              # even layer partitioning
            s = m // stages                           # devices per stage
            # per-cell-type options: cell-DP r (divisor of s) x template
            per_group_options: List[List[CellScheme]] = []
            for gcell in groups:
                opts: List[CellScheme] = []
                dps = divisors(s) if allow_cell_dp else [1]
                for r in dps:
                    opts.extend(schemes_for_cell(gcell, s, r))
                per_group_options.append(opts)
            if any(not o for o in per_group_options):
                continue
            for combo in itertools.product(*per_group_options):
                cell_schemes = tuple(combo[t] for t in type_of_cell)
                schemes.append(ParallelScheme(
                    model=model, model_dp=model_dp, pp_stages=stages,
                    cell_schemes=cell_schemes, quant=quant))
                if len(schemes) >= max_schemes:
                    return schemes
    return schemes


def prefilter_schemes(schemes: List[ParallelScheme], hbm_bytes: float,
                      frac: float = 0.92) -> List[ParallelScheme]:
    """Static weight-memory pre-filter.

    A scheme whose per-device weight bytes alone overflow ``frac`` of the
    device HBM can never simulate feasibly, so it is dropped before the
    (expensive) mapping + trace simulation.  Shared by the colocated search
    path (core/search.py) and the disaggregated per-pool pruning
    (disagg/pools.py) so both reject infeasible plans identically.
    """
    cap = hbm_bytes * frac
    return [s for s in schemes if s.weight_bytes_per_device() < cap]


def heuristic_scheme(model: ModelIR, num_devices: int, cluster=None,
                     quant: str = "fp16") -> ParallelScheme:
    """The baseline plan (paper §4.2): TP within a node, PP across nodes."""
    if cluster is not None and len(cluster.levels) > 1:
        node = cluster.levels[0].group_size
        stages = max(1, num_devices // node)
        while model.block.repeat % stages != 0 and stages > 1:
            stages //= 2
        tp = num_devices // stages
    else:
        tp, stages = num_devices, 1
    cells = []
    for c in model.block.cells:
        opts = schemes_for_cell(c, tp, 1)
        if not opts:
            # fall back to the largest valid TP degree
            for g in sorted(divisors(tp), reverse=True):
                opts = schemes_for_cell(c, g, 1)
                if opts:
                    break
        cells.append(opts[0])
    return ParallelScheme(model=model, model_dp=1, pp_stages=stages,
                          cell_schemes=tuple(cells), quant=quant)
