"""``graph.host_ms_per_chunk``: layer ``models.graph_slam`` host path
(eager launches and bookkeeping). The traced stretch's ``session`` spans,
less the union of the ``sync`` (device waits), ``graphs.replay`` and
``graphs.capture`` spans inside them, in milliseconds over its ``stage``
spans tagged ``frontend_chunk`` (``GraphSlam.timer``'s stages;
``slambench/spans.py``): the host time a chunk of graph SLAM spends neither
waiting for the card nor launching or capturing a graph."""

from slambench import spans

NOT_HOST = ("sync", "graphs.replay", "graphs.capture")


def read(data: dict):
    sessions = spans.closed("session")
    chunks = spans.closed("stage", tag="frontend_chunk")
    if not sessions or not chunks:
        return None
    inner = [s for name in NOT_HOST for s in spans.closed(name)]
    host = 0
    for ses in sessions:
        cut = [(max(s.start_ns, ses.start_ns), min(s.end_ns, ses.end_ns))
               for s in inner if s.thread == ses.thread]
        host += (ses.end_ns - ses.start_ns) - spans.union_ns(cut)
    return 1e-6 * host / len(chunks)
