"""Arithmetic the readers of the program's spans share.

The spans are ``ae_waveforms_tpu_torch.train.profiling``'s: host ranges
the program opens around its phases, which record only while a
``torch.profiler`` session records, so in a ``--trace 1`` run the traced
sub-windows hold them all.  ``snapshot()`` gives each span name's count
and host seconds.  A program without that layer gives nothing to read,
and each reader then returns None."""

from __future__ import annotations

from typing import Dict, Optional


def span_stats() -> Dict[str, object]:
    """Each span name's aggregate (``count``, ``total_s``, ``self_s``), or
    {} where the program records no spans."""
    try:
        from ae_waveforms_tpu_torch.train import profiling
    except ImportError:
        return {}
    snapshot = getattr(profiling, "snapshot", None)
    return dict(snapshot().stats) if snapshot is not None else {}


def mean_ms(*names: str) -> Optional[float]:
    """Mean host milliseconds of a span of any of ``names``, over their
    counts together; None where none was counted."""
    stats = span_stats()
    counted = [stats[n] for n in names if n in stats and stats[n].count > 0]
    if not counted:
        return None
    return 1e3 * sum(s.total_s for s in counted) / sum(s.count for s in counted)


def share_of_window(run, *names: str) -> Optional[float]:
    """Σ host seconds of the spans of ``names`` over the traced
    sub-windows' wall seconds, in %; None where none was counted."""
    stats = span_stats()
    counted = [stats[n] for n in names if n in stats and stats[n].count > 0]
    if not counted or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * sum(s.total_s for s in counted) / run.trace.window_s
