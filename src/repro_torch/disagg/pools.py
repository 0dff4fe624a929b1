"""Pool partitioning for disaggregated prefill/decode serving.

A ``DisaggScheme`` splits one physical cluster into a *prefill pool* and a
*decode pool*, each carrying its own ``ParallelScheme`` (so each pool picks
its own DP/PP/TP/quant — the whole point of disaggregation: prefill wants
high TP for low TTFT, decode wants DP-heavy replication for token
throughput).  Pools occupy contiguous physical id ranges — prefill at
[0, P), decode at [P, N) — so the existing bottom-up Device Mapper places
each pool unchanged via its ``device_offset`` and the KV handoff crosses a
well-defined network level of the cluster tree.

Plan enumeration reuses Algorithm 1 per pool and prunes each pool's
candidates with the same static weight-memory pre-filter as the colocated
search path (``planner.prefilter_schemes``), so a pool split that overflows
either pool's HBM is rejected before any simulation.

The port's copy of ``repro/disagg/pools.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..core.batching import BatchingPolicy
from ..core.cluster import Cluster, NetworkLevel, cross_pool_link
from ..core.ir import ModelIR
from ..core.mapper import ExecutionPlan, map_scheme
from ..core.planner import (ParallelScheme, generate_schemes,
                            prefilter_schemes)


@dataclasses.dataclass(frozen=True)
class DisaggScheme:
    """A disaggregated plan: per-pool parallel schemes + transfer mode.

    ``transfer_mode``:
      * ``"layerwise"`` — KV blocks stream to the decode pool as each layer
        finishes prefill; only the last layer's chunk remains on the wire
        when prefill completes (the admission delay the decode pool sees).
      * ``"blocking"``  — the whole cache ships after prefill completes.
    """

    prefill: ParallelScheme
    decode: ParallelScheme
    transfer_mode: str = "layerwise"

    def __post_init__(self):
        if self.transfer_mode not in ("layerwise", "blocking"):
            raise ValueError(
                f"unknown transfer mode {self.transfer_mode!r}")
        if self.prefill.model is not self.decode.model:
            raise ValueError("pools must serve the same model IR")

    @property
    def model(self) -> ModelIR:
        return self.prefill.model

    @property
    def prefill_devices(self) -> int:
        return self.prefill.total_devices

    @property
    def decode_devices(self) -> int:
        return self.decode.total_devices

    @property
    def total_devices(self) -> int:
        return self.prefill_devices + self.decode_devices

    def label(self) -> str:
        return (f"disagg[{self.prefill_devices}P:{self.prefill.label()}"
                f" | {self.decode_devices}D:{self.decode.label()}]"
                f"@{self.transfer_mode}")


@dataclasses.dataclass(frozen=True)
class DisaggPlan:
    """A physically-mapped disaggregated plan: per-pool clusters + per-pool
    ExecutionPlans, joined by the network the KV handoff crosses.

    Two substrates:

      * shared cluster (homogeneous) — both pools are contiguous id ranges
        of ONE cluster (``prefill_cluster is decode_cluster``); the handoff
        crosses the cluster-internal level at ``transfer_span`` and
        ``cross_level`` is None.  This is the shared-cluster path.
      * per-pool clusters (heterogeneous) — each pool is its own cluster
        with its own ``DeviceSpec`` (prefill on compute-heavy parts, decode
        on HBM-bandwidth-heavy parts); the handoff crosses the explicit
        ``cross_level`` (default: ``core.cluster.cross_pool_link``).
    """

    scheme: DisaggScheme
    prefill_cluster: Cluster
    decode_cluster: Cluster
    prefill_plan: ExecutionPlan
    decode_plan: ExecutionPlan
    transfer_span: int        # devices spanned by the in-cluster link
    cross_level: Optional[NetworkLevel] = None   # explicit inter-pool link
    # per-pool batching policies (None = the simulation-wide policy);
    # e.g. chunked prefill only on the prefill pool, or a different
    # max_batch_size per pool — each pool's replicas are engine actors
    # driven by their own SchedulerPolicy, so the pools need not agree
    prefill_policy: Optional[BatchingPolicy] = None
    decode_policy: Optional[BatchingPolicy] = None

    @property
    def homogeneous(self) -> bool:
        return self.prefill_cluster is self.decode_cluster

    @property
    def cluster(self) -> Cluster:
        """The single shared cluster (homogeneous plans only)."""
        if not self.homogeneous:
            raise ValueError(
                "heterogeneous plan has per-pool clusters; use "
                ".prefill_cluster / .decode_cluster")
        return self.prefill_cluster

    def label(self) -> str:
        # per-pool-cluster plans are ALWAYS suffixed with their pool
        # devices — even a same-device island pair is different physics
        # (cross-pool link, separate fabrics) from splitting one shared
        # cluster, and downstream consumers classify families by label
        if self.cross_level is None:
            return self.scheme.label()
        return (f"{self.scheme.label()}"
                f"#{self.prefill_cluster.device.name}"
                f">{self.decode_cluster.device.name}")

    def describe(self) -> str:
        if self.cross_level is not None:
            lvl = self.cross_level
            where = (f"{self.prefill_cluster.name}+"
                     f"{self.decode_cluster.name}")
        else:
            lvl = self.prefill_cluster.level_for_group(self.transfer_span)
            where = self.prefill_cluster.name
        return "\n".join([
            f"disagg plan on {where} "
            f"({self.scheme.prefill_devices} prefill x "
            f"{self.prefill_cluster.device.name} + "
            f"{self.scheme.decode_devices} decode x "
            f"{self.decode_cluster.device.name}, "
            f"KV handoff over {lvl.name}, {self.scheme.transfer_mode})",
            self.prefill_plan.describe(),
            self.decode_plan.describe(),
        ])


def is_mixed_label(label: str) -> bool:
    """True when a plan label names DIFFERENT devices for its two pools.

    The single source of truth for the ``#pre>dec`` suffix
    ``DisaggPlan.label()`` emits — benchmarks and examples classify plan
    families through this helper instead of re-parsing the string.
    Same-device island pairs (``#H200-SXM>H200-SXM``) and unsuffixed
    shared-cluster plans both count as homogeneous.
    """
    if "#" not in label:
        return False
    pre, _, dec = label.rsplit("#", 1)[1].partition(">")
    return pre != dec


def cross_pool_span(cluster: Cluster, prefill_devices: int) -> int:
    """Device span of the prefill->decode KV link, for level lookup.

    The pools abut at physical ids (P-1, P); the handoff crosses the
    smallest tree level whose group contains both ids.  Returns a span that
    ``Cluster.level_for_group`` maps back to exactly that level — this is
    the same level-selection rule the Device Mapper applies to collective
    groups, so KV-transfer traffic is costed with the cluster's own
    bandwidth/latency tables, never a hard-coded link speed.
    """
    src, dst = prefill_devices - 1, prefill_devices
    if dst >= cluster.num_devices:
        raise ValueError("decode pool is empty")
    for lvl in cluster.levels:
        if src // lvl.group_size == dst // lvl.group_size:
            return 2 if lvl is cluster.levels[0] else lvl.group_size
    return cluster.levels[-1].group_size


def map_disagg_scheme(scheme: DisaggScheme, cluster: Optional[Cluster] = None,
                      *, prefill_cluster: Optional[Cluster] = None,
                      decode_cluster: Optional[Cluster] = None,
                      cross_level: Optional[NetworkLevel] = None
                      ) -> DisaggPlan:
    """Map both pools to physical devices.

    With ``cluster``, both pools share one physical cluster: prefill at
    offset 0, decode next (the homogeneous path, unchanged).  With
    ``prefill_cluster``/``decode_cluster``, each pool maps onto its OWN
    cluster at offset 0 and the KV handoff crosses ``cross_level``
    (default: ``cross_pool_link`` of the two clusters).
    """
    if cluster is not None:
        if prefill_cluster is not None or decode_cluster is not None:
            raise ValueError(
                "pass either one shared cluster or per-pool clusters")
        if scheme.total_devices > cluster.num_devices:
            raise ValueError(
                f"disagg scheme needs {scheme.total_devices} devices; "
                f"cluster {cluster.name} has {cluster.num_devices}")
        p = scheme.prefill_devices
        return DisaggPlan(
            scheme=scheme, prefill_cluster=cluster, decode_cluster=cluster,
            prefill_plan=map_scheme(scheme.prefill, cluster,
                                    device_offset=0),
            decode_plan=map_scheme(scheme.decode, cluster, device_offset=p),
            transfer_span=cross_pool_span(cluster, p))
    if prefill_cluster is None or decode_cluster is None:
        raise ValueError("need a shared cluster or BOTH per-pool clusters")
    for pool, c, n in (("prefill", prefill_cluster, scheme.prefill_devices),
                       ("decode", decode_cluster, scheme.decode_devices)):
        if n > c.num_devices:
            raise ValueError(
                f"{pool} pool needs {n} devices; cluster {c.name} has "
                f"{c.num_devices}")
    return DisaggPlan(
        scheme=scheme, prefill_cluster=prefill_cluster,
        decode_cluster=decode_cluster,
        prefill_plan=map_scheme(scheme.prefill, prefill_cluster),
        decode_plan=map_scheme(scheme.decode, decode_cluster),
        transfer_span=2,
        cross_level=cross_level or cross_pool_link(prefill_cluster,
                                                   decode_cluster))


def pool_splits(num_devices: int) -> List[Tuple[int, int]]:
    """All (prefill_devices, decode_devices) partitions of the cluster."""
    return [(p, num_devices - p) for p in range(1, num_devices)]


def generate_disagg_schemes(model: ModelIR,
                            cluster: Optional[Cluster] = None,
                            quant: str = "fp16",
                            decode_quant: Optional[str] = None,
                            feasible_only: bool = True,
                            transfer_mode: str = "layerwise",
                            max_model_dp: Optional[int] = None,
                            max_plans: int = 512,
                            prefill_cluster: Optional[Cluster] = None,
                            decode_cluster: Optional[Cluster] = None
                            ) -> List[DisaggScheme]:
    """Enumerate disaggregated plans: pool split x per-pool Algorithm-1
    schemes, each pool pruned by ITS OWN device's weight-memory pre-filter.

    With one shared ``cluster``, every (prefill, decode) split of its
    devices is enumerated and both pools are filtered against the shared
    device HBM (the homogeneous path).  With per-pool clusters, the
    split is fixed — each pool fills its own cluster — and each pool is
    filtered against its OWN HBM, so e.g. a decode pool of H200s admits
    schemes an H100 pool of the same width would reject.

    ``decode_quant`` lets the decode pool run a different format (e.g. kv8
    to stretch decode KV capacity while prefill stays fp16).  The default
    ``feasible_only=True`` restricts pools to uniform DP/PP/TP schemes —
    the cross-product of two unconstrained cell-DP spaces is rarely worth
    simulating and real disaggregated stacks deploy uniform pools.
    """
    if (prefill_cluster is None) != (decode_cluster is None):
        raise ValueError("need BOTH per-pool clusters (or neither)")
    if prefill_cluster is not None:
        if cluster is not None:
            raise ValueError(
                "pass either one shared cluster or per-pool clusters")
        splits = [(prefill_cluster.num_devices, decode_cluster.num_devices)]
        hbm_pre = prefill_cluster.device.hbm_bytes
        hbm_dec = decode_cluster.device.hbm_bytes
    else:
        if cluster is None:
            raise ValueError("need a shared cluster or per-pool clusters")
        splits = pool_splits(cluster.num_devices)
        hbm_pre = hbm_dec = cluster.device.hbm_bytes
    out: List[DisaggScheme] = []
    per_pool_cache: dict = {}

    def pool_candidates(n: int, q: str, hbm: float) -> List[ParallelScheme]:
        key = (n, q, hbm)
        if key not in per_pool_cache:
            cands = generate_schemes(model, n, quant=q,
                                     allow_cell_dp=not feasible_only,
                                     max_model_dp=max_model_dp)
            if feasible_only:
                cands = [s for s in cands
                         if s.is_feasible_for_current_systems()]
            per_pool_cache[key] = prefilter_schemes(cands, hbm)
        return per_pool_cache[key]

    for p, d in splits:
        for pre in pool_candidates(p, quant, hbm_pre):
            for dec in pool_candidates(d, decode_quant or quant, hbm_dec):
                out.append(DisaggScheme(prefill=pre, decode=dec,
                                        transfer_mode=transfer_mode))
                if len(out) >= max_plans:
                    return out
    return out
