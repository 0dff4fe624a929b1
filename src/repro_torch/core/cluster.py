"""Device-cluster abstraction for APEX (paper §2.2, §3.2.3).

A cluster is a tree: devices at the leaves, interconnect levels above them.
Bandwidth and latency are uniform within a level (paper Fig. 1).  Level 1 is
the fastest/lowest (e.g. NVLink within a node, an ICI ring group on a TPU
pod); higher levels span more devices at lower bandwidth (InfiniBand across
nodes, DCN across pods).

The paper models GPU clusters; §2.2 notes ASIC clusters (TPU, Gaudi) use
tree-based topologies as well and "can be abstracted similarly" — we ship a
TPU v5e preset built on the hardware constants used by the roofline analysis
(197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).  Every preset's
numbers are data-sheet constants the planner ranks plans with, not
measurements; the port runs on none of the TPU presets.

The port's copy of ``repro/core/cluster.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """A single accelerator's capabilities.

    ``peak_flops`` maps dtype name -> peak dense FLOP/s.  ``hbm_bytes`` is
    usable memory capacity; ``hbm_bw`` is peak HBM bandwidth in bytes/s.
    ``idle_power_w`` / ``peak_power_w`` feed the energy model (core/energy.py).
    ``base_freq_ghz`` is the frequency the peak numbers are quoted at; the
    energy model scales rates linearly and power super-linearly with
    frequency (paper Table 4 explores 0.8 GHz vs 2.0 GHz).
    """

    name: str
    peak_flops: dict
    hbm_bytes: float
    hbm_bw: float
    idle_power_w: float
    peak_power_w: float
    base_freq_ghz: float = 2.0

    def flops(self, dtype: str) -> float:
        if dtype not in self.peak_flops:
            raise KeyError(
                f"{self.name} has no peak-FLOPs entry for dtype {dtype!r}; "
                f"known: {sorted(self.peak_flops)}"
            )
        return self.peak_flops[dtype]


@dataclasses.dataclass(frozen=True)
class NetworkLevel:
    """One level of the interconnect tree.

    ``group_size``: number of *devices* spanned by one group at this level
    (cumulative — level 2's group_size counts all devices under one level-2
    switch, not the number of level-1 groups).
    ``bw_per_device``: per-device injection bandwidth in bytes/s at this
    level (the number ring-collective models divide by).
    ``latency_s``: per-hop software+wire latency.
    """

    name: str
    group_size: int
    bw_per_device: float
    latency_s: float
    # Per-collective software launch overhead (NCCL kernel launch, group
    # sync). GPUs pay ~10 us per op; TPU collectives are compiled into the
    # XLA program and pay far less. This term is what makes high-degree TP
    # lose to DP-heavy hybrids on decode (paper §4.2.1's "incorporating DP
    # often yields performance benefits").
    launch_s: float = 8e-6


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A tree-topology device cluster."""

    name: str
    device: DeviceSpec
    levels: tuple  # tuple[NetworkLevel, ...], innermost first
    num_devices: int

    def __post_init__(self):
        if not self.levels:
            raise ValueError("cluster needs at least one network level")
        sizes = [l.group_size for l in self.levels]
        if sizes != sorted(sizes):
            raise ValueError(f"levels must be ordered innermost-first: {sizes}")
        if self.levels[-1].group_size < self.num_devices:
            raise ValueError(
                f"outermost level spans {self.levels[-1].group_size} devices "
                f"< cluster size {self.num_devices}"
            )

    # -- topology queries ---------------------------------------------------

    def level_for_group(self, group_size: int) -> NetworkLevel:
        """Smallest level whose group covers ``group_size`` devices.

        The Device Mapper (core/mapper.py) packs communicating groups
        bottom-up, so a group of size g lands on the first level with
        group_size >= g.
        """
        if group_size <= 1:
            return self.levels[0]
        for lvl in self.levels:
            if lvl.group_size >= group_size:
                return lvl
        raise ValueError(
            f"group of {group_size} devices exceeds cluster {self.name} "
            f"({self.num_devices} devices)"
        )

    def level_index_for_group(self, group_size: int) -> int:
        lvl = self.level_for_group(group_size)
        return self.levels.index(lvl)

    @property
    def total_hbm_bytes(self) -> float:
        return self.device.hbm_bytes * self.num_devices

    @property
    def total_flops(self) -> dict:
        return {k: v * self.num_devices for k, v in self.device.peak_flops.items()}

    def describe(self) -> str:
        lines = [f"cluster {self.name}: {self.num_devices} x {self.device.name}"]
        for i, lvl in enumerate(self.levels):
            lines.append(
                f"  L{i + 1} {lvl.name}: groups of {lvl.group_size}, "
                f"{lvl.bw_per_device / 1e9:.0f} GB/s/dev, "
                f"{lvl.latency_s * 1e6:.1f} us"
            )
        return "\n".join(lines)


def cross_pool_link(prefill: "Cluster", decode: "Cluster",
                    name: str = "cross-pool") -> NetworkLevel:
    """The network level joining two heterogeneous device pools.

    Each pool injects onto the shared fabric through its own outermost
    level; the joint link can move bytes no faster than the slower side, so
    its per-device bandwidth is the MIN of the two pools' outermost
    injection bandwidths, and latency/launch take the worse of the two.
    Pass an explicit ``NetworkLevel`` to ``map_disagg_scheme`` instead when
    the deployment's inter-pool wire is known (e.g. a dedicated RDMA
    fabric slower than either pool's scale-out network).
    """
    a, b = prefill.levels[-1], decode.levels[-1]
    return NetworkLevel(
        name=name,
        group_size=prefill.num_devices + decode.num_devices,
        bw_per_device=min(a.bw_per_device, b.bw_per_device),
        latency_s=max(a.latency_s, b.latency_s),
        launch_s=max(a.launch_s, b.launch_s),
    )


def host_link(name: str = "host-pcie",
              bw_bytes_s: float = 64e9,
              latency_s: float = 2e-6,
              launch_s: float = 1e-5) -> NetworkLevel:
    """The device<->host-DRAM link one device swaps KV over.

    Defaults model a PCIe Gen5 x16 endpoint (~64 GB/s per direction).
    This is the link the ``swap`` preemption mechanism prices its KV
    round trips on (engine ``SwapPolicy``); group_size=1 because a swap
    is a single device-local DMA, not a collective.
    """
    return NetworkLevel(name=name, group_size=1, bw_per_device=bw_bytes_s,
                        latency_s=latency_s, launch_s=launch_s)


# ---------------------------------------------------------------------------
# Device presets
# ---------------------------------------------------------------------------

H100 = DeviceSpec(
    name="H100-SXM",
    peak_flops={"fp16": 989e12, "bf16": 989e12, "fp8": 1979e12, "fp32": 67e12},
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    idle_power_w=90.0,
    peak_power_w=700.0,
    base_freq_ghz=2.0,
)

H200 = DeviceSpec(
    name="H200-SXM",
    peak_flops={"fp16": 989e12, "bf16": 989e12, "fp8": 1979e12, "fp32": 67e12},
    hbm_bytes=141e9,
    hbm_bw=4.8e12,
    idle_power_w=95.0,
    peak_power_w=700.0,
    base_freq_ghz=2.0,
)

# TPU v5e — the production dry-run / roofline target. Constants match the
# roofline analysis: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s per ICI link.
TPU_V5E = DeviceSpec(
    name="TPU-v5e",
    peak_flops={"bf16": 197e12, "fp16": 197e12, "int8": 394e12, "fp8": 394e12,
                "fp32": 49e12},
    hbm_bytes=16e9,
    hbm_bw=819e9,
    idle_power_w=60.0,
    peak_power_w=220.0,
    base_freq_ghz=1.7,
)


# ---------------------------------------------------------------------------
# Cluster presets (the paper's three evaluation clusters + our TPU target)
# ---------------------------------------------------------------------------

def h100_node(num_gpus: int = 8) -> Cluster:
    """Single-node H100 cluster (paper §4.2.1): NVLink all-to-all."""
    return Cluster(
        name=f"h100x{num_gpus}",
        device=H100,
        levels=(
            NetworkLevel("nvlink", num_gpus, 450e9, 2e-6, launch_s=10e-6),
        ),
        num_devices=num_gpus,
    )


def h100_multinode(num_nodes: int = 2, gpus_per_node: int = 8) -> Cluster:
    """Multi-node H100 cluster (paper §4.2.2): NVLink in-node, IB across."""
    n = num_nodes * gpus_per_node
    return Cluster(
        name=f"h100x{gpus_per_node}x{num_nodes}nodes",
        device=H100,
        levels=(
            NetworkLevel("nvlink", gpus_per_node, 450e9, 2e-6, launch_s=10e-6),
            NetworkLevel("infiniband", n, 50e9, 10e-6, launch_s=25e-6),
        ),
        num_devices=n,
    )


def h200_node(num_gpus: int = 8) -> Cluster:
    """Single-node H200 cluster (paper §4.2.3): more HBM, same compute."""
    return Cluster(
        name=f"h200x{num_gpus}",
        device=H200,
        levels=(
            NetworkLevel("nvlink", num_gpus, 450e9, 2e-6, launch_s=10e-6),
        ),
        num_devices=num_gpus,
    )


def tpu_v5e_pod(chips: int = 256, ring_group: int = 16) -> Cluster:
    """TPU v5e pod slice, modeled as a 2-level tree over ICI ring groups.

    A v5e pod is a 2D torus; collectives run ring algorithms along torus
    axes, so a 16-chip ring group is the level-1 "fast" domain (one torus
    row) and the full slice is level 2 (both axes). Paper §2.2 sanctions the
    tree abstraction for TPU clusters.
    """
    return Cluster(
        name=f"tpu-v5e-{chips}",
        device=TPU_V5E,
        levels=(
            NetworkLevel("ici-ring", ring_group, 50e9, 1e-6, launch_s=2e-6),
            NetworkLevel("ici-2d", chips, 50e9, 2e-6, launch_s=3e-6),
        ),
        num_devices=chips,
    )


def tpu_v5e_multipod(pods: int = 2, chips_per_pod: int = 256) -> Cluster:
    """Multi-pod v5e: pods joined over DCN (25 GB/s/device effective)."""
    n = pods * chips_per_pod
    return Cluster(
        name=f"tpu-v5e-{chips_per_pod}x{pods}pods",
        device=TPU_V5E,
        levels=(
            NetworkLevel("ici-ring", 16, 50e9, 1e-6, launch_s=2e-6),
            NetworkLevel("ici-2d", chips_per_pod, 50e9, 2e-6, launch_s=3e-6),
            NetworkLevel("dcn", n, 25e9, 20e-6, launch_s=30e-6),
        ),
        num_devices=n,
    )


# The host's CPU — used by the fidelity experiments where the simulator
# (with MEASURED op tables) predicts the real engine running on the same
# silicon.  Peak numbers are rough (they only feed MFU/energy
# bookkeeping; timing comes from measured tables).
CPU_LOCAL = DeviceSpec(
    name="cpu-local",
    peak_flops={"fp32": 5e10, "bf16": 5e10, "fp16": 5e10, "fp8": 5e10},
    hbm_bytes=8e9,
    hbm_bw=20e9,
    idle_power_w=20.0,
    peak_power_w=65.0,
    base_freq_ghz=2.5,
)


def cpu_local() -> Cluster:
    return Cluster(
        name="cpu-local",
        device=CPU_LOCAL,
        levels=(NetworkLevel("shm", 1, 10e9, 1e-6, launch_s=1e-6),),
        num_devices=1,
    )


CLUSTER_PRESETS = {
    "cpu-local": cpu_local,
    "h100x8": h100_node,
    "h100x16-2node": h100_multinode,
    "h200x8": h200_node,
    "tpu-v5e-256": tpu_v5e_pod,
    "tpu-v5e-512-2pod": tpu_v5e_multipod,
}


def get_cluster(name: str) -> Cluster:
    """Resolve a preset cluster by name (extensibility hook, paper Table 5)."""
    if name not in CLUSTER_PRESETS:
        raise KeyError(f"unknown cluster {name!r}; known: {sorted(CLUSTER_PRESETS)}")
    return CLUSTER_PRESETS[name]()
