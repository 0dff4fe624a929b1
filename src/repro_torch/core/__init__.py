"""Counterparts of ``repro/core`` that run ops on a device.

The simulator itself (``repro/core``) is plain Python and is not ported;
only its one device-facing piece is: ``profiles.MeasuredBackend``, the
offline profiler that times the ops the simulator's tables price.
"""

from .profiles import MeasuredBackend

__all__ = ["MeasuredBackend"]
