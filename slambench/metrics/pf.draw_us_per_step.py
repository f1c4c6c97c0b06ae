"""``pf.draw_us_per_step``: layer ``models.fastslam`` ``PfStepFn`` (the
step's eager draws and copies outside the graph). The host microseconds of
one ``pf.draw`` span (``slambench/spans.py``): a captured step's proposal
noise and resampling offset drawn from the session's generator and copied
into its static buffers, their sum over their count in the traced
stretch."""

from slambench import spans


def read(data: dict):
    draws = spans.closed("pf.draw")
    if not draws:
        return None
    return 1e-3 * sum(s.end_ns - s.start_ns for s in draws) / len(draws)
