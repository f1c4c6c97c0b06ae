"""``stream.sync_wait_p50_ms``: layer ``models.scan_matcher`` (the captured
step and its one host sync a scan). The median over the traced window's
scans of the step's device wait, the ``sync`` span tagged ``step`` around
``StepFn``'s 16-byte read of the pose and the keyframe test
(``slambench/spans.py``): the part of ``stream.step_p50_ms`` spent waiting
for the card."""

from slambench import spans
from slambench.harness import percentile


def read(data: dict):
    waits = spans.closed("sync", tag="step")
    if not waits:
        return None
    return percentile([1e-6 * (s.end_ns - s.start_ns) for s in waits], 50)
