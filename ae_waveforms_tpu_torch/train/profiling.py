"""Tracing/profiling hooks (the port of the JAX package's
``train/profiling.py``).

The reference has wall-clock timers only (run_train.py:270-271, :338-340);
this module keeps those (the loop logs per-chunk/epoch timings) and adds
device profiling: ``trace(dir)`` wraps a region in ``torch.profiler`` (the
CPU, and CUDA activity where a card is present) and exports a Chrome trace,
viewable in Perfetto or chrome://tracing; ``Timer`` provides the coarse
host-side timers.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["trace", "Timer"]


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the region into ``log_dir/trace.json`` when ``log_dir`` is
    set; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
