"""Simulator profile tables measured on the card by the port's profiler.

``TorchMeasuredBackend`` is the ``ProfileBackend`` of ``repro.core`` over
``repro_torch.core.profiles.MeasuredBackend``: one clock of that
profiler's two, ``"wall"`` (the reference's: host clock around a
synchronised call) or ``"device"`` (CUDA events), with energy from the
simulator's own ``PowerModel`` at utilization 0.7, as the reference's
``MeasuredBackend`` charges it.

One ``measure`` call of the profiler gives both clocks; the backends of a
``sibling`` pair share its samples, so one profiling pass fills the wall
and the device tables.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

from repro.core.cluster import h100_node
from repro.core.energy import PowerModel
from repro.core.profiles import ProfileBackend

from repro_torch.core.profiles import MeasuredBackend

CLOCKS = ("wall", "device")
UTILIZATION = 0.7


def _checked(clock: str) -> str:
    if clock not in CLOCKS:
        raise ValueError(f"clock must be one of {CLOCKS}, got {clock!r}")
    return clock


class TorchMeasuredBackend(ProfileBackend):
    """Profile samples timed on ``device`` (CUDA unless the caller passes
    ``device="cpu"``), read on ``clock``; energy for ``h100_node(1)``'s
    device."""

    def __init__(self, clock: str = "wall", device=None, repeats: int = 3):
        self.clock = _checked(clock)
        self.power = PowerModel(h100_node(1).device)
        self.timer = MeasuredBackend(device, repeats)
        # (op, axes, x) -> (wall_s, device_s)
        self.samples: Dict[tuple, Tuple[float, float]] = {}

    def sibling(self, clock: str) -> "TorchMeasuredBackend":
        """A backend on ``clock`` that shares this one's profiler and
        samples."""
        other = copy.copy(self)
        other.clock = _checked(clock)
        return other

    def sample(self, op: str, axes: tuple, x: float) -> Tuple[float, float]:
        """``(wall_s, device_s)`` of one sample, timed on first use."""
        key = (op, tuple(axes), float(x))
        if key not in self.samples:
            self.samples[key] = self.timer.measure(op, tuple(axes), x)
        return self.samples[key]

    def measure(self, op: str, axes: tuple, x: float) -> Tuple[float, float]:
        wall, device = self.sample(op, axes, x)
        t = wall if self.clock == "wall" else device
        return t, self.power.energy(t, UTILIZATION)
