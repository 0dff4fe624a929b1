"""Device traces: a ``torch.profiler`` capture of a stretch of the run,
reduced to plain arrays that the metric readers read.

``Capture`` records CUDA activity between ``start()`` and ``stop()``,
and with ``host=True`` every host op too (which doubles a decode step's
host time, so a capture that reads the device's idle share leaves them
out: its host events are then the CUDA runtime's calls alone).  ``stop`` synchronises the device first, so every kernel of
the stretch has ended, and reads the profiler's raw events (not its
per-op tree, which costs minutes at 100,000 kernels):

  * ``kernels``: every device activity (kernels, copies, sets) as name,
    start and duration in ns on the profiler's clock, and the
    correlation id of the host call that launched it;
  * ``launch_at``: host start (ns) of each launch call, by correlation id;
  * ``host``: every host event, name, start and end (ns);
  * ``window``: the start and end (ns) of the ``bench.window`` range that
    spans the capture, or, where the capture holds no host ranges, of its
    first and last event.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "bench.window"
# host events of the CUDA runtime and driver, whose correlation ids are
# those of the device activities they launch
RUNTIME = ("cuda", "cu")
# the label of idle time under no host event, and how far back to look
# for an enclosing one
OUTSIDE = "(host, between recorded calls)"
NEST = 64


@dataclass
class Trace:
    kernel_names: List[str]
    kernel_start: np.ndarray
    kernel_dur: np.ndarray
    kernel_corr: np.ndarray
    launch_at: Dict[int, int]
    host_names: List[str]
    host_start: np.ndarray
    host_end: np.ndarray
    window: Tuple[int, int]
    steps: int = 1

    # -- readings ------------------------------------------------------------

    def busy_ns(self) -> float:
        """Nanoseconds of the window in which some device activity ran."""
        t0, t1 = self.window
        if not len(self.kernel_start):
            return 0.0
        s = np.clip(self.kernel_start, t0, t1)
        e = np.clip(self.kernel_start + self.kernel_dur, t0, t1)
        order = np.argsort(s)
        s, e = s[order], e[order]
        run_end = np.maximum.accumulate(e)
        # an interval starts a new run where it begins after every
        # earlier interval has ended
        new = np.empty(len(s), bool)
        new[0] = True
        new[1:] = s[1:] > run_end[:-1]
        starts = s[new]
        ends = np.append(run_end[np.flatnonzero(new)[1:] - 1], run_end[-1])
        return float((ends - starts).sum())

    def window_ns(self) -> float:
        return float(self.window[1] - self.window[0])

    def gaps(self) -> List[Tuple[int, int]]:
        """The idle stretches of the window (start, end) in ns."""
        t0, t1 = self.window
        if not len(self.kernel_start):
            return [(t0, t1)]
        s = np.clip(self.kernel_start, t0, t1)
        e = np.clip(self.kernel_start + self.kernel_dur, t0, t1)
        order = np.argsort(s)
        s, e = s[order], e[order]
        run_end = np.maximum.accumulate(e)
        out = []
        if s[0] > t0:
            out.append((t0, int(s[0])))
        idx = np.flatnonzero(s[1:] > run_end[:-1])
        out += [(int(run_end[i]), int(s[i + 1])) for i in idx]
        if run_end[-1] < t1:
            out.append((int(run_end[-1]), t1))
        return out

    def kernel_ns(self, match) -> Tuple[float, int]:
        """(total ns, count) of the device activities whose lower-cased
        name contains ``match`` (a string, or any of a tuple)."""
        words = (match,) if isinstance(match, str) else tuple(match)
        tot, n = 0.0, 0
        for name, d in zip(self.kernel_names, self.kernel_dur):
            low = name.lower()
            if any(w in low for w in words):
                tot += float(d)
                n += 1
        return tot, n

    def in_range_ns(self, range_name: str) -> float:
        """ns of device activity launched from inside a host range
        ``range_name``."""
        iv = sorted((int(s), int(e)) for n, s, e in zip(
            self.host_names, self.host_start, self.host_end)
            if n == range_name)
        if not iv:
            return 0.0
        starts = np.array([a for a, _ in iv])
        ends = np.array([b for _, b in iv])
        tot = 0.0
        for corr, d in zip(self.kernel_corr, self.kernel_dur):
            at = self.launch_at.get(int(corr))
            if at is None:
                continue
            j = np.searchsorted(starts, at, side="right") - 1
            if j >= 0 and at <= ends[j]:
                tot += float(d)
        return tot

    def top_kernels(self, n: int = 10) -> List[list]:
        """[name, seconds] of the n device activities that took most."""
        by: Dict[str, float] = {}
        for name, d in zip(self.kernel_names, self.kernel_dur):
            by[name] = by.get(name, 0.0) + float(d)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def top_gaps(self, n: int = 10) -> List[list]:
        """[host activity, seconds] of the idle time, summed by the name
        of the innermost host event under each gap's middle (the one that
        began last), or ``OUTSIDE`` where none is."""
        gaps = self.gaps()
        if not gaps:
            return []
        order = np.argsort(self.host_start)
        hs, he = self.host_start[order], self.host_end[order]
        names = [self.host_names[i] for i in order]
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) // 2
            j = int(np.searchsorted(hs, mid, side="right")) - 1
            label = OUTSIDE
            for k in range(j, max(j - NEST, -1), -1):
                if he[k] >= mid:
                    label = names[k]
                    break
            by[label] = by.get(label, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


class Capture:
    """Profile the stretch between ``start()`` and ``stop()``."""

    def __init__(self, device, host: bool = False):
        self.device = device
        self.host = host
        self.prof = None
        self.trace: Optional[Trace] = None

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = []
        if self.host or self.device.type != "cuda":
            acts.append(ProfilerActivity.CPU)
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self._range = record_function(WINDOW)
        self._range.__enter__()

    def stop(self, steps: int = 1) -> Trace:
        self._sync()
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.trace = reduce(self.prof, steps)
        self.prof = None
        return self.trace


def reduce(prof, steps: int) -> Trace:
    """The raw events of a stopped profiler as a ``Trace``."""
    k_names, k_start, k_dur, k_corr = [], [], [], []
    launch_at: Dict[int, int] = {}
    h_names, h_start, h_end = [], [], []
    window = None
    events = prof.profiler.kineto_results.events()
    device = [str(e.device_type()).split(".")[-1].upper()
              in ("CUDA", "PRIVATEUSE1") for e in events]
    # a host range (record_function) has a device-side copy of the same
    # name that spans kernels and is none itself
    ranges = {e.name() for e, dev in zip(events, device)
              if not dev and e.is_user_annotation()}
    for e, dev in zip(events, device):
        start, dur = e.start_ns(), e.duration_ns()
        if dev:
            if e.name() in ranges:
                continue
            k_names.append(e.name())
            k_start.append(start)
            k_dur.append(dur)
            k_corr.append(e.correlation_id() or e.linked_correlation_id())
            continue
        name = e.name()
        if name == WINDOW:
            window = (start, start + dur)
        if name.startswith(RUNTIME) and e.correlation_id():
            launch_at.setdefault(int(e.correlation_id()), start)
        h_names.append(name)
        h_start.append(start)
        h_end.append(start + dur)
    if window is None:
        ends = [e.start_ns() + e.duration_ns() for e in events]
        if not ends:
            raise RuntimeError("the profile holds no event")
        window = (min(e.start_ns() for e in events), max(ends))
    return Trace(k_names, np.array(k_start, np.int64),
                 np.array(k_dur, np.int64), np.array(k_corr, np.int64),
                 launch_at, h_names, np.array(h_start, np.int64),
                 np.array(h_end, np.int64), window, steps)
