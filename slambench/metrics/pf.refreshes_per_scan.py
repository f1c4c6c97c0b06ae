"""``pf.refreshes_per_scan``: layer ``models.fastslam`` ``PfStepFn`` refresh
arm (raster and K1 in the IF node). The program's ``pf.refreshes`` counter
(``slambench/spans.py``), the traced session's keyframe refreshes, over the
scans it mapped: an exact count, which a change that maps differently
moves."""

from slambench import spans


def read(data: dict):
    made = spans.counter("pf.refreshes")
    scans = data.get("scans_traced")
    if made is None or not scans:
        return None
    return made / scans
