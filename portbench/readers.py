"""Arithmetic the per-layer readers share.  Each returns None where the
run recorded nothing to read, never 0 for a share."""

from __future__ import annotations

from typing import Optional

from portbench.counts import peaks


def idle_share(run) -> Optional[float]:
    """The traced sub-windows' share of wall time in which no operation ran
    on the device, in %."""
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run, flops_key: str = "model_flops", wall_key: str = "wall_s") -> Optional[float]:
    """Operations recorded over wall seconds recorded, as a % of the card's
    float32 peak."""
    flops, wall = run.records.get(flops_key), run.records.get(wall_key)
    if not flops or not wall or run.device_name not in peaks.PEAKS:
        return None
    return 100.0 * flops / wall / peaks.peak(run.device_name)["float32"]


def roofline(run, launches, kernel: str, count) -> Optional[float]:
    """Σ of each traced launch's least time (``count(**launch)`` gives its
    bytes and operations) over the traced device time of the kernels whose
    name holds ``kernel``, in %."""
    seconds = run.trace.device_seconds(lambda name: kernel in name) if run.trace is not None else 0.0
    if not launches or seconds <= 0 or run.device_name not in peaks.PEAKS:
        return None
    least = sum(peaks.least_seconds(*count(**launch), run.device_name) for launch in launches)
    return 100.0 * least / seconds
