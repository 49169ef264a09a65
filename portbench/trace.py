"""The device trace of a ``--trace 1`` run.

A driver opens and closes sub-windows of its timed window with
``Tracer.start``/``Tracer.stop``; each is a ``torch.profiler`` run of CPU
and CUDA activity between two synchronisations, exported as a Chrome trace
under the run's scratch directory and read back here.  What the readers
get is a ``Trace``: every device operation (name, start, duration), the
seconds the device was busy (the union of its operations' intervals) and
the sub-windows' wall seconds, and the device's idle gaps named by the
innermost host operation running at each gap's middle.
"""

from __future__ import annotations

import json
import os
import time
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")


@dataclass
class Trace:
    ops: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start us, duration us)
    busy_s: float = 0.0
    window_s: float = 0.0
    gaps: Dict[str, float] = field(default_factory=lambda: defaultdict(float))  # host op -> idle seconds
    windows: int = 0

    def device_seconds(self, match=lambda name: True) -> float:
        return sum(d for name, _, d in self.ops if match(name)) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, d in self.ops:
            by_name[name] += d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _union(spans) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def read_chrome_trace(events, trace: Trace) -> None:
    """Add one exported sub-window's events to ``trace``: device operations,
    busy seconds, and the idle gaps between the first and the last host
    event, each named by the innermost host operation at its middle."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            dev.append((e.get("name", "?"), start, dur))
        elif cat in HOST_CATEGORIES:
            host.append((start, start + dur, e.get("name", "?")))
    trace.ops.extend(dev)
    busy = _union((s, s + d) for _, s, d in dev)
    trace.busy_s += sum(b - a for a, b in busy) / 1e6
    if not host:
        return
    lo, hi = min(h[0] for h in host), max(h[1] for h in host)
    host.sort()
    starts = [h[0] for h in host]
    edges = [lo] + [x for span in busy for x in span] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        k = bisect_right(starts, mid)
        inner = [(h[1] - h[0], h[2]) for h in host[max(0, k - 200):k] if h[1] >= mid]
        name = min(inner)[1] if inner else "host outside any op"
        trace.gaps[name] += (b - a) / 1e6


class Tracer:
    """Profiles the sub-windows a driver marks, where ``enabled``."""

    def __init__(self, enabled: bool, device, scratch: str):
        self.enabled = enabled
        self.device = device
        self.scratch = scratch
        self.trace = Trace()
        self._prof = None
        self._t0 = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once during set-up, so that its own
        first start (CUPTI's) is not paid inside the timed window."""
        if self.enabled:
            import torch

            self.start()
            torch.zeros(1, device=self.device).add_(1)
            self.stop(keep=False)

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._sync()
        self._prof = profile(activities=activities)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, keep: bool = True) -> None:
        if self._prof is None:
            return
        self._sync()
        wall = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.stop()
        if not keep:
            return
        path = os.path.join(self.scratch, f"trace-{self.trace.windows}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
        os.remove(path)
        events = events["traceEvents"] if isinstance(events, dict) else events
        read_chrome_trace(events, self.trace)
        self.trace.window_s += wall
        self.trace.windows += 1
