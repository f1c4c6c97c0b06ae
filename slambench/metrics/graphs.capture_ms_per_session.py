"""``graphs.capture_ms_per_session``: layer ``utils.graphs`` captures
(warm-up, capture, instantiation). The host milliseconds of the traced
stretch's ``graphs.capture`` spans, summed, over its ``session`` spans
(``slambench/spans.py``): what capturing a session's CUDA graphs anew costs
each session."""

from slambench import spans


def read(data: dict):
    sessions = spans.closed("session")
    if not sessions:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns
                      for s in spans.closed("graphs.capture")) / len(sessions)
