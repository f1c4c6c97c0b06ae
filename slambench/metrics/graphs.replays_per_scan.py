"""``graphs.replays_per_scan``: layer ``utils.graphs`` replays. The traced
stretch's ``graphs.replay`` spans (``slambench/spans.py``), one
``cudaGraphLaunch`` each, over the scans it mapped: an exact count, which
the profiler does not stretch, of the graph launches a scan takes."""

from slambench import spans


def read(data: dict):
    replays = spans.closed("graphs.replay")
    scans = data.get("scans_traced")
    if not replays or not scans:
        return None
    return len(replays) / scans
