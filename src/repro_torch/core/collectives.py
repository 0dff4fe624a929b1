"""Collective-communication cost models (paper §3.5, profiled offline there).

The paper's Offline Profiler measures AllReduce/ReduceScatter/... across data
sizes, device counts and node counts.  We model the same operations with
standard ring/tree algorithm cost formulas parameterized by the cluster's
per-level bandwidth/latency (core/cluster.py).  These analytic curves *are*
the profiling tables' generator (core/profiles.py wraps them in the paper's
grid-plus-linear-interpolation mechanism), and they are cross-checked against
the collective bytes parsed out of real compiled XLA HLO in
tests/test_hlo_analysis.py.

All functions return seconds for ONE collective over ``nbytes`` of payload
(payload = the logical tensor size; algorithm-induced traffic expansion is
applied inside).

The port's copy of ``repro/core/collectives.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import math

from .cluster import Cluster, NetworkLevel


def _level(cluster: Cluster, group_size: int) -> NetworkLevel:
    return cluster.level_for_group(group_size)


def all_reduce_time(nbytes: float, group_size: int, cluster: Cluster) -> float:
    """Ring all-reduce: 2*(n-1)/n * bytes per device over the bottleneck level."""
    if group_size <= 1 or nbytes <= 0:
        return 0.0
    lvl = _level(cluster, group_size)
    traffic = 2.0 * (group_size - 1) / group_size * nbytes
    return (traffic / lvl.bw_per_device + lvl.launch_s
            + 2 * (group_size - 1) * lvl.latency_s)


def all_gather_time(nbytes: float, group_size: int, cluster: Cluster) -> float:
    """Ring all-gather of a total of ``nbytes`` (gathered output size)."""
    if group_size <= 1 or nbytes <= 0:
        return 0.0
    lvl = _level(cluster, group_size)
    traffic = (group_size - 1) / group_size * nbytes
    return (traffic / lvl.bw_per_device + lvl.launch_s
            + (group_size - 1) * lvl.latency_s)


def reduce_scatter_time(nbytes: float, group_size: int, cluster: Cluster) -> float:
    """Ring reduce-scatter of a ``nbytes`` input per device."""
    if group_size <= 1 or nbytes <= 0:
        return 0.0
    lvl = _level(cluster, group_size)
    traffic = (group_size - 1) / group_size * nbytes
    return (traffic / lvl.bw_per_device + lvl.launch_s
            + (group_size - 1) * lvl.latency_s)


def all_to_all_time(nbytes: float, group_size: int, cluster: Cluster) -> float:
    """All-to-all where each device exchanges ``nbytes`` total payload.

    Each device sends (n-1)/n of its payload; on a ring/tree this is the
    cheapest of the big collectives — the reason the paper's simulator
    predicts EP (all-to-all) beating TP (all-reduce) for MoE (Fig. 6
    discussion).
    """
    if group_size <= 1 or nbytes <= 0:
        return 0.0
    lvl = _level(cluster, group_size)
    traffic = (group_size - 1) / group_size * nbytes
    return (traffic / lvl.bw_per_device + lvl.launch_s
            + (group_size - 1) * lvl.latency_s)


def p2p_time(nbytes: float, src_group: int, cluster: Cluster) -> float:
    """Point-to-point send (pipeline-stage boundary).

    ``src_group`` is the span (in devices) of the two communicating stages —
    the Device Mapper places adjacent stages as close as possible, and the
    level is determined by that span.
    """
    if nbytes <= 0:
        return 0.0
    lvl = _level(cluster, max(2, src_group))
    return nbytes / lvl.bw_per_device + lvl.launch_s + lvl.latency_s


def broadcast_time(nbytes: float, group_size: int, cluster: Cluster) -> float:
    """Binomial-tree broadcast."""
    if group_size <= 1 or nbytes <= 0:
        return 0.0
    lvl = _level(cluster, group_size)
    hops = math.ceil(math.log2(group_size))
    return (hops * (nbytes / lvl.bw_per_device) + lvl.launch_s
            + hops * lvl.latency_s)


COLLECTIVE_FNS = {
    "all_reduce": all_reduce_time,
    "all_gather": all_gather_time,
    "reduce_scatter": reduce_scatter_time,
    "all_to_all": all_to_all_time,
    "broadcast": broadcast_time,
}


def collective_time(kind: str, nbytes: float, group_size: int,
                    cluster: Cluster) -> float:
    """Dispatch by collective kind (extensibility hook: register new kinds
    by adding to COLLECTIVE_FNS — 'new parallelism' row of paper Table 5)."""
    try:
        fn = COLLECTIVE_FNS[kind]
    except KeyError:
        raise KeyError(
            f"unknown collective {kind!r}; known: {sorted(COLLECTIVE_FNS)}"
        ) from None
    return fn(nbytes, group_size, cluster)
