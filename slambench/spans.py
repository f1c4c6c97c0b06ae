"""The program's span log, as the ``program_span`` readers see it.

While a profiler runs, the port records spans at its layer boundaries in
``lidar_slam_tpu_torch.utils.profiling.SPANS``: each with a ``name``, a
``tag``, a ``req``, ``start_ns`` and ``end_ns`` on ``time.time_ns()``'s
clock (kineto's) and the index of its ``parent``; and counters by name.
A ``--trace 1`` run profiles one stretch (``kinds/replay.py`` the first
window session, ``kinds/paced_stream.py`` the whole window), so the log
holds that stretch alone, read in the same process once it has closed. A
program that keeps no such log reads as None, and so does each metric
that would read it.
"""

from __future__ import annotations

from slambench.trace import _merge


def log():
    """The program's span log, or None where it keeps none."""
    try:
        from lidar_slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "SPANS", None)


def closed(name: str, tag=None) -> list:
    """The log's closed spans called ``name`` (with ``tag``, if given)."""
    spans = log()
    if spans is None:
        return []
    return [s for s in spans.spans if s.name == name and s.end_ns is not None
            and (tag is None or s.tag == tag)]


def counter(name: str):
    """The log's counter ``name``, or None where it was never counted."""
    spans = log()
    return None if spans is None else spans.counters.get(name)


def union_ns(intervals) -> int:
    """The length (ns) of the union of (start, end) intervals, those that
    end after they start (the union ``trace.py`` takes of the device's
    operations)."""
    return sum(e - s for s, e in _merge((s, e) for s, e in intervals
                                        if e > s))
