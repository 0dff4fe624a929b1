"""Spans of the port's layers, recorded while a ``torch.profiler`` profile
is recording.

``span(name, rid=..., step=...)`` is a context manager.  While no profile
records, it returns one shared object that does nothing: the cost is one
read of the profiler's Python flag, with no allocation, no clock read and
no host range.  An operator who profiles the program gets its
ranges with no setting of their own.  While a profile records, a span

  * enters a host range of that name (``torch._C._profiler.
    _RecordFunctionFast``, the range ``torch.compile`` enters), so a
    capture that records host events shows the span as an op of that
    name.  A capture of device activity alone records no host range, and
    there the range costs under a microsecond, where
    ``torch.profiler.record_function`` costs 7-12 us a call on the H100's
    host whether or not anything records it;
  * on exit, appends its row to a bounded in-memory buffer: its name,
    start and end in ns from ``time.time_ns()`` (the clock of the
    profiler's events), the index of the span that encloses it on the
    same thread, and its ids (``rid``: the request it serves; ``step``:
    the engine iteration).

``spans(t0_ns, t1_ns)`` returns the recorded spans that overlap a window,
``clear()`` empties the buffer.  Nothing is written anywhere: a
profiler's own trace export already shows the ranges.

The names, by layer (``serving/engine.py``, ``models/transformer.py``,
``layers/moe.py``, ``kernels/*.py``):

  * ``engine.iteration`` (step), ``engine.admit`` (rid), one
    ``engine.replay_step`` (rid) per step of a prompt's replay,
    ``engine.upload``, ``engine.readback``, ``engine.retire``;
  * ``model.decode_step``, ``model.attention`` (a layer's mixer: GQA,
    MLA or SSM), ``model.head``;
  * ``moe_forward``;
  * ``kernel.rmsnorm``, ``kernel.decode_attention``,
    ``kernel.flash_attention``, ``kernel.ssd_scan`` (each ctypes launch).

A decode step that replays a captured CUDA graph (the serving engine's,
on a card) runs no Python inside the step: of the model's spans it
opens ``model.decode_step`` alone.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

# spans kept, the newest: some 90 an engine step
CAPACITY = 1 << 17


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    # index of the enclosing span on the same thread, -1 at the top
    parent: int
    ids: dict
    # this span's own index, in the order spans were entered
    index: int


# rows of (name, start_ns, end_ns, parent, rid, step, index); a deque's
# append is atomic, so threads need no lock to add to it
_rows = collections.deque(maxlen=CAPACITY)
_index = itertools.count()
_local = threading.local()


class _Off:
    """What ``span`` returns while no profile records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "rid", "step", "index", "parent", "start", "range",
                 "stack")

    def __init__(self, name: str, rid: Optional[int], step: Optional[int]):
        self.name = name
        self.rid = rid
        self.step = step

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else -1
        self.index = next(_index)
        stack.append(self.index)
        self.range = _RecordFunctionFast(self.name)
        # the stamps bracket the range, so the span holds the profiler's
        # event of the same name
        self.start = time.time_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.range.__exit__(*exc)
        finally:
            end = time.time_ns()
            self.stack.pop()
            _rows.append((self.name, self.start, end, self.parent, self.rid,
                          self.step, self.index))
        return False


def span(name: str, rid: Optional[int] = None, step: Optional[int] = None):
    """A range named ``name``, recorded while a profile records (see the
    module's docstring); ``rid`` and ``step`` are kept in its ``ids``
    where given."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, rid, step)


def spans(t0_ns: Optional[int] = None,
          t1_ns: Optional[int] = None) -> List[Span]:
    """The recorded spans that overlap ``[t0_ns, t1_ns]`` (either end
    open where None), by start, an enclosing span before the spans it
    encloses."""
    out = []
    for name, start, end, parent, rid, step, index in list(_rows):
        if (t0_ns is None or end >= t0_ns) and (t1_ns is None
                                                or start <= t1_ns):
            ids = {k: v for k, v in (("rid", rid), ("step", step))
                   if v is not None}
            out.append(Span(name, start, end, parent, ids, index))
    out.sort(key=lambda s: (s.start_ns, s.index))
    return out


def clear() -> None:
    """Empty the buffer."""
    _rows.clear()
