"""``replay.device_ms_per_scan``: layer ``utils.graphs`` and the captured
steps (the step and the driver loop). The device's busy milliseconds (the
union of every device operation in the profiler's trace) over the traced
session, over the scans it completed."""


def read(data: dict):
    tr, scans = data.get("trace"), data.get("scans_traced")
    if tr is None or not scans or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / scans
