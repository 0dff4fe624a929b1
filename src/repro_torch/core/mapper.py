"""Device Mapper — logical -> physical device assignment (paper §3.2.3).

The Plan Generator works top-down on a *logical* cluster; the Device Mapper
works bottom-up on the *physical* tree: the most communication-hungry
groups (intra-cell TP/EP groups, which run AllReduce/All-to-All every
layer) are packed into the lowest, highest-bandwidth level first; pipeline
stages (p2p only) next; model replicas (no steady-state traffic in serving)
last.  The result is an ``ExecutionPlan``: the scheme plus concrete device
ids and, per collective group, the network level its traffic crosses.

The port's copy of ``repro/core/mapper.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .cluster import Cluster
from .planner import ParallelScheme


@dataclasses.dataclass(frozen=True)
class GroupPlacement:
    """Physical placement of one communicating group."""

    kind: str                 # "cell" | "stage_p2p" | "replica"
    device_ids: tuple
    span: int                 # devices spanned -> picks the network level

    @property
    def size(self) -> int:
        return len(self.device_ids)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A physically-mapped parallel execution plan — the Batching Module /
    Serving Simulator's unit of evaluation."""

    scheme: ParallelScheme
    cluster: Cluster
    cell_groups: tuple        # one GroupPlacement per cell scheme (stage 0,
                              # replica 0 — stages/replicas are isomorphic)
    stage_span: int           # span of adjacent-stage p2p pairs
    replica_span: int
    device_offset: int = 0    # first physical id (pool partitioning)

    def label(self) -> str:
        return self.scheme.label()

    def collective_span(self, cell_index: int) -> int:
        return self.cell_groups[cell_index].span

    def describe(self) -> str:
        s = self.scheme
        lines = [f"plan {self.label()} on {self.cluster.name}",
                 f"  replicas={s.model_dp} stages={s.pp_stages} "
                 f"stage_devices={s.stage_devices}"]
        for g, cs in zip(self.cell_groups, s.cell_schemes):
            lvl = self.cluster.level_for_group(g.span)
            lines.append(
                f"  {cs.cell.name}[{cs.cell.kind}] dp={cs.dp} "
                f"{cs.method or 'tp'}={cs.shard} -> devices {g.device_ids} "
                f"(level {lvl.name})")
        return "\n".join(lines)


def map_scheme(scheme: ParallelScheme, cluster: Cluster,
               device_offset: int = 0) -> ExecutionPlan:
    """Assign logical devices to physical devices, bottom-up.

    Physical ids are laid out so that consecutive ids are topologically
    close (id // L1.group_size = node index), the standard tree numbering.
    Packing a group into consecutive ids therefore minimizes its span, and
    the bottom-up priority order (cells -> stages -> replicas) matches the
    paper: finer-grained parallelism gets the better links.

    ``device_offset`` places the scheme on the physical id range
    [offset, offset + total_devices) — disaggregated pools partition one
    cluster into contiguous id ranges (disagg/pools.py).
    """
    n_needed = scheme.total_devices
    if device_offset < 0:
        raise ValueError(f"negative device_offset {device_offset}")
    if device_offset + n_needed > cluster.num_devices:
        raise ValueError(
            f"scheme needs {n_needed} devices at offset {device_offset}; "
            f"cluster {cluster.name} has {cluster.num_devices}")

    s_dev = scheme.stage_devices
    l1 = cluster.levels[0].group_size

    # Stage-0/replica-0 cell groups: pack each cell's shard groups into
    # consecutive ids starting at the pool offset.  A cell with dp replicas
    # of width `shard` forms dp groups; the widest communicating unit is
    # `shard`.
    cell_groups: List[GroupPlacement] = []
    for cs in scheme.cell_schemes:
        ids = tuple(range(device_offset, device_offset + cs.shard))
        # span: if the shard group fits in an L1 group it spans `shard`
        # devices at level 1; otherwise it genuinely crosses levels.  An
        # offset pool whose range straddles a group boundary is promoted to
        # the level that actually covers the range.
        span = cs.shard
        if cs.shard > 1:
            for lvl in cluster.levels:
                if ids[0] // lvl.group_size == ids[-1] // lvl.group_size:
                    if lvl is not cluster.levels[0]:
                        span = max(span, lvl.group_size)
                    break
        cell_groups.append(GroupPlacement("cell", ids, span))

    # Adjacent pipeline stages occupy consecutive s_dev-sized chunks; the
    # boundary p2p pair spans the distance between the last device of one
    # chunk and the first of the next.
    if scheme.pp_stages > 1:
        stage_span = s_dev + 1 if s_dev < l1 else 2 * s_dev
        if device_offset % l1:
            # A misaligned pool can put a stage boundary across an L1
            # group even when s_dev < l1; promote the p2p span to the
            # level that covers the worst adjacent-stage boundary pair.
            R = scheme.devices_per_replica
            for r in range(scheme.model_dp):
                for p in range(1, scheme.pp_stages):
                    b = device_offset + r * R + p * s_dev
                    lvl = next(l for l in cluster.levels
                               if (b - 1) // l.group_size
                               == b // l.group_size)
                    if lvl is not cluster.levels[0]:
                        stage_span = max(stage_span, lvl.group_size)
        stage_span = min(stage_span, cluster.num_devices)
    else:
        stage_span = 1

    replica_span = min(scheme.devices_per_replica, cluster.num_devices)

    return ExecutionPlan(scheme=scheme, cluster=cluster,
                         cell_groups=tuple(cell_groups),
                         stage_span=stage_span, replica_span=replica_span,
                         device_offset=device_offset)


def assign_physical_ids(scheme: ParallelScheme, cluster: Cluster
                        ) -> Dict[str, List[Tuple[int, ...]]]:
    """Full physical id assignment for inspection/visualization and the
    locality tests: returns every group's device-id tuple.

    Layout: replica r occupies ids [r*R, (r+1)*R); within a replica, stage
    p occupies the next s_dev ids; within a stage, cell-DP replica q of a
    cell occupies the next `shard` ids.  This is the bottom-up packing
    realized as an id arithmetic scheme.
    """
    R = scheme.devices_per_replica
    s_dev = scheme.stage_devices
    out: Dict[str, List[Tuple[int, ...]]] = {"cell": [], "stage_p2p": [],
                                             "replica": []}
    for r in range(scheme.model_dp):
        base_r = r * R
        out["replica"].append(tuple(range(base_r, base_r + R)))
        for p in range(scheme.pp_stages):
            base_p = base_r + p * s_dev
            for cs in scheme.cell_schemes:
                for q in range(cs.dp):
                    start = base_p + q * cs.shard
                    out["cell"].append(tuple(range(start, start + cs.shard)))
            if p + 1 < scheme.pp_stages:
                out["stage_p2p"].append((base_p + s_dev - 1, base_p + s_dev))
    return out
