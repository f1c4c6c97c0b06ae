"""``replay.device_idle_pct``: layer ``device`` (the H100). The share of the
traced session's window in which no operation ran on the device: 1 less
the union of the profiler's device intervals over the window."""


def read(data: dict):
    tr = data.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
