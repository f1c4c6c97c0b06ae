"""``graphs.launch_us_per_replay``: layer ``utils.graphs`` replays. The host
microseconds of one ``graphs.replay`` span (``slambench/spans.py``), one
``cudaGraphLaunch`` with its IF and WHILE nodes: their sum over their count
in the traced stretch."""

from slambench import spans


def read(data: dict):
    replays = spans.closed("graphs.replay")
    if not replays:
        return None
    return 1e-3 * sum(s.end_ns - s.start_ns for s in replays) / len(replays)
