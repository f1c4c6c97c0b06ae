"""``stream.step_p95_ms``: layer ``models.scan_matcher`` (the captured step
and its one host sync a scan). The 95th percentile over the window's scans
of the time from the step loop taking a scan off the queue to its pose on
the host (``run_streaming_slam``'s latencies)."""

from slambench.harness import percentile


def read(data: dict):
    ms = data.get("step_ms")
    return percentile(ms, 95) if ms else None
