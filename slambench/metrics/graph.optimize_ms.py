"""``graph.optimize_ms``: layer ``models.posegraph.OptimizeFn``. The host
milliseconds of one pose-graph optimize (ten Gauss-Newton replays, ending
in a device sync), from ``GraphSlam.timer``'s ``optimize`` stage: its
seconds over its calls, summed over the window's sessions."""


def read(data: dict):
    timer = data.get("timer")
    if not timer or not timer["counts"].get("optimize"):
        return None
    return 1e3 * timer["totals"]["optimize"] / timer["counts"]["optimize"]
