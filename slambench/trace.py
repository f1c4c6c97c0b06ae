"""The traced window of a ``--trace 1`` run: ``torch.profiler`` (CUPTI on the
card) over a stretch of the run, reduced to what the per-layer readers and
the result line need: the device's busy seconds (the union of every device
operation's interval), the window's length, device seconds by operation
name, and the device's idle gaps, each named by the innermost host operation
that covers its middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass

SHORT_GAP_NS = 10_000   # shorter idle gaps are launch latency, not named


@dataclass
class TraceSummary:
    window_s: float                 # host clock length of the traced window
    busy_s: float                   # union of device operations, seconds
    device_s_by_name: dict          # device seconds by operation name
    device_ops: int                 # device operations in the window
    idle_by_host: dict              # idle seconds by the host op covering it


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events, t0_ns: int, t1_ns: int) -> TraceSummary:
    """``events``: (name, is_device, start_ns, end_ns) tuples on one clock
    with ``t0_ns``/``t1_ns``, the window's ends."""
    dev, host = [], []
    by_name: dict = defaultdict(float)
    events = [ev for ev in events if ev[3] > ev[2]]
    # the window spans the host clock's ends and every traced event
    t0_ns = min([t0_ns] + [ev[2] for ev in events])
    t1_ns = max([t1_ns] + [ev[3] for ev in events])
    for name, is_dev, s, e in events:
        if is_dev:
            dev.append((s, e))
            by_name[name] += (e - s) * 1e-9
        else:
            host.append((s, e, name))
    busy = _merge(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps, prev = [], t0_ns
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1_ns > prev:
        gaps.append((prev, t1_ns))
    host.sort()
    starts = [h[0] for h in host]
    idle: dict = defaultdict(float)
    for gs, ge in gaps:
        if ge - gs < SHORT_GAP_NS:
            idle["device: between operations, under 10 us"] += (ge - gs) * 1e-9
            continue
        mid = (gs + ge) // 2
        best = None
        # the innermost host op covering the gap's middle, among the last
        # few that started before it (host ops nest)
        for s, e, name in host[max(0, bisect.bisect_right(starts, mid) - 64):
                               bisect.bisect_right(starts, mid)]:
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        idle[best[2] if best else "host: between traced ops"] += (
            ge - gs) * 1e-9
    return TraceSummary(window_s=(t1_ns - t0_ns) * 1e-9, busy_s=busy_s,
                        device_s_by_name=dict(by_name), device_ops=len(dev),
                        idle_by_host=dict(idle))


class Tracer:
    """``with Tracer(on): ...``: profile the block when ``on``; afterwards
    ``summary`` is its ``TraceSummary`` (None when off). The block's end
    waits for the device."""

    def __init__(self, on: bool):
        self.on, self.summary, self._prof = on, None, None

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        import torch

        torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            from torch.autograd import DeviceType

            events = [(ev.name(), ev.device_type() == DeviceType.CUDA,
                       ev.start_ns(), ev.end_ns())
                      for ev in self._prof.profiler.kineto_results.events()]
            self.summary = reduce_events(events, self._t0, t1)
        self._prof = None
        return False


def breakdown(summary: TraceSummary) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten host activities under which the device idled
    longest, each with its seconds."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(summary.device_s_by_name),
            "idle_gaps": top(summary.idle_by_host)}
