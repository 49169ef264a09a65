"""The port's span layer: named host ranges that record only while a
``torch.profiler`` session records.

``span(name)`` marks a phase of the program (a training step, a fit's
histogram call).  With no profiler on it reads one flag and returns a
shared no-op context, so the spans can sit on every hot path.  With a
profiler on, a span

- opens ``torch.profiler.record_function(name)``, so that the range lands
  in the exported trace as a ``user_annotation`` event;
- keeps a record of its name, its start and end (``time.time_ns()``, the
  clock of the Chrome trace's ``ts`` plus ``baseTimeNanoseconds``) and the
  name of its parent, the innermost span open on its thread;
- adds to its name's aggregate: count, host seconds and self seconds (its
  seconds less those of the spans it holds).

A span counts only where the profiler was on both when it was entered and
when it exited: one cut by a profiled window's edge, or one that holds the
profiler's own stop and export, is left out.  ``snapshot()`` returns the
aggregates and the last ``MAX_RECORDS`` records; ``reset()`` clears them.

Every range the port opens goes through ``span``.  The names, by phase:

- ``train.schedule`` (the learning rate and the batch rows) and
  ``train.step`` (``train.forward``, ``train.backward``, ``train.optimizer``
  inside it; ``adam.moments`` and ``adam.update`` inside the last), a step;
  a step replayed from a captured graph holds ``train.replay`` instead, and
  the call that captures it ``train.capture`` before that;
  ``train.readback``, ``train.log``, a chunk; ``train.validate``
  (``train.validate.batch``), a validation; ``train.checkpoint``, a save;
- ``gbt.grad`` (the per-tree kernel K5's call: masks, g, h, shifts) and
  ``gbt.leaves`` (K6's: leaf weights, margins), a tree iteration of a fit;
  ``gbt.hist`` (the histogram kernel's call), ``gbt.split`` (the epilogue)
  and ``gbt.route`` (the routing kernel's call), a level;
- ``dl.step`` (``dl.seed``, one seed's forward and backward, and
  ``dl.optimizer`` inside it), a stacked step of the DL classifier's
  seeds; ``dl.validate`` (the AUC pass and its wait) and ``dl.select``
  (the best snapshot and the early-stopping counters), an epoch;
- ``gather and loss``, ``dropout`` and ``upsample`` inside the models.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Deque, Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

__all__ = ["span", "snapshot", "reset", "SpanRecord", "SpanStats", "Snapshot", "MAX_RECORDS"]

MAX_RECORDS = 100_000

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int  # time.time_ns() as the span was entered
    end_ns: int  # and as it exited
    parent: Optional[str]  # the innermost span open around it on its thread


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0  # host seconds inside the span
    self_s: float = 0.0  # of which no counted child span held


class Snapshot(NamedTuple):
    stats: Dict[str, SpanStats]
    records: List[SpanRecord]


_lock = threading.Lock()
_stats: Dict[str, SpanStats] = {}
_records: Deque[SpanRecord] = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()


def _open_spans() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "parent", "child_ns", "start_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        self.child_ns = 0
        stack.append(self)
        self._range = record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _open_spans().pop()
        if not _profiling():  # the profiler stopped inside the span
            return
        ns = end_ns - self.start_ns
        parent = self.parent
        if parent is not None:
            parent.child_ns += ns
        with _lock:
            stats = _stats.get(self.name)
            if stats is None:
                stats = _stats[self.name] = SpanStats()
            stats.count += 1
            stats.total_s += ns * 1e-9
            stats.self_s += (ns - self.child_ns) * 1e-9
            _records.append(SpanRecord(self.name, self.start_ns, end_ns, parent.name if parent is not None else None))


def span(name: str):
    """A context that marks ``name`` while a ``torch.profiler`` session
    records, and does nothing otherwise (see the module docstring)."""
    if not _profiling():
        return _OFF
    return _Span(name)


def snapshot() -> Snapshot:
    """A copy of every name's aggregate and of the kept records."""
    with _lock:
        return Snapshot({k: SpanStats(v.count, v.total_s, v.self_s) for k, v in _stats.items()}, list(_records))


def reset() -> None:
    with _lock:
        _stats.clear()
        _records.clear()
