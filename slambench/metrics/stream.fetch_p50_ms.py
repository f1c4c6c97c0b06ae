"""``stream.fetch_p50_ms``: layer ``io.server`` (the streaming I/O). The
median over the window's scans of the time from a row's due release to the
step loop taking it off the prefetch queue (the
``dequeued`` of ``run_streaming_slam``'s latencies): the server's release,
the relay, HTTP, JSON parsing and the wait in the queue."""

from slambench.harness import percentile


def read(data: dict):
    ms = data.get("fetch_ms")
    return percentile(ms, 50) if ms else None
