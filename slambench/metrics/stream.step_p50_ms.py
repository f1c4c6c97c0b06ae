"""``stream.step_p50_ms``: layer ``models.scan_matcher`` (the captured step
and its one host sync a scan). The median over the window's scans
of the time from the step loop taking a scan off the queue to its pose on
the host (``run_streaming_slam``'s latencies)."""

from slambench.harness import percentile


def read(data: dict):
    ms = data.get("step_ms")
    return percentile(ms, 50) if ms else None
