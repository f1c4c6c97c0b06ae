"""``graph.backend_share_pct``: layer ``models.graph_slam`` ``_Backend`` and
``models.posegraph``. The share of ``GraphSlam.timer``'s seconds (every
stage ends in a device sync) spent outside the frontend's chunks, summed
over the window's sessions: keyframe fetches and rasters, closure
matching, the optimize and the feedback."""

FRONTEND = "frontend_chunk"


def read(data: dict):
    timer = data.get("timer")
    if not timer or not timer["totals"]:
        return None
    total = sum(timer["totals"].values())
    backend = total - timer["totals"].get(FRONTEND, 0.0)
    return 100.0 * backend / total if total > 0 else None
