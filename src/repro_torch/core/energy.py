"""Power / energy model (paper §4.2.4, Table 4).

The paper profiles per-operation energy and observes that (a) energy-optimal
plans differ from latency-optimal ones, and (b) lowering GPU frequency to
0.8 GHz cuts energy up to 45% at a TTFT/TPOT cost.  We model device power as

    P(util, f) = P_idle + (P_peak - P_idle) * util * (f / f_base)^2

(dynamic power ~ f * V^2 with V ~ f — the standard CMOS scaling argument),
while compute/bandwidth rates scale ~ f.  Energy per op = P * time.  This
reproduces the paper's qualitative structure: downclocking stretches time by
f_base/f but cuts dynamic power by (f/f_base)^2, netting ~f energy savings
on compute-bound ops, less on memory-bound ones.

The port's copy of ``repro/core/energy.py``, whose results it gives bit
for bit; it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .cluster import DeviceSpec


@dataclasses.dataclass
class PowerModel:
    device: DeviceSpec
    freq_ghz: Optional[float] = None

    @property
    def freq_ratio(self) -> float:
        if self.freq_ghz is None:
            return 1.0
        return self.freq_ghz / self.device.base_freq_ghz

    def power(self, utilization: float) -> float:
        """Watts at the given compute utilization in [0, 1]."""
        u = min(max(utilization, 0.0), 1.0)
        dyn = (self.device.peak_power_w - self.device.idle_power_w)
        return self.device.idle_power_w + dyn * u * self.freq_ratio ** 2

    def energy(self, time_s: float, utilization: float) -> float:
        """Joules consumed by ONE device over ``time_s``."""
        return self.power(utilization) * time_s
