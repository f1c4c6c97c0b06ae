"""``alloc.segments_per_session``: layer PyTorch's caching allocator under a
session. The segments the allocator made (its ``cudaMalloc`` calls) over
the traced stretch's ``session`` spans, the program's ``alloc.segments``
counter, over their count (``slambench/spans.py``)."""

from slambench import spans


def read(data: dict):
    sessions = spans.closed("session")
    made = spans.counter("alloc.segments")
    if not sessions or made is None:
        return None
    return made / len(sessions)
