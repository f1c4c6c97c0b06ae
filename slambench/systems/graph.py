"""Graph SLAM with loop closure as the benchmark runs it.

A replay session is a fresh ``models.graph_slam.GraphSlam(...).run`` on the
whole log: the captured fidelity frontend in chunks, keyframe rasters, closure
matching on K2's volumes, fine refinement and the pose-graph optimize, with
the frontend rebuilt after a solve that moves a keyframe. What a session
produced is its path, its accepted closures and its optimized keyframe
poses, each held to the plain reference (``reference/graph.py``) run on the
same log. ``GraphSlam.timer``'s stage seconds are kept for the per-layer
readers.

The frontend is the fidelity step, exact; the solve is float32 with float64
sums in the program and float64 in the reference, so paths and keyframe
poses after the first solve may differ by the solve's rounding, and the
limits on them come from readings (PERF.md). The backend is held to the
reference's backend run on the session's own keyframes, so that a frontend
that moved one step after a solve does not count as a wrong closure.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.systems.fidelity import program_config


class Program:
    """The program for ``config`` on ``device``."""

    def __init__(self, config: dict, device: str):
        from lidar_slam_tpu_torch.models import graph_slam

        self.gs = graph_slam
        self.cfg = program_config(config)
        self.lc = graph_slam.LoopClosureConfig(**config["loop_closure"])
        self.max_keyframes = config["max_keyframes"]
        self.chunk = config["chunk_size"]
        self.device = device

    def replay(self, ranges: np.ndarray) -> dict:
        g = self.gs.GraphSlam(self.cfg, self.lc, self.max_keyframes,
                              device=self.device)
        path, kf_poses = g.run(ranges, chunk_size=self.chunk)
        # the session's outputs on the host; the store (128 MB) goes with g
        return {"path": path, "kf_poses": kf_poses,
                "kf_times": list(g.kf_times), "closures": list(g.closures),
                "weak_closures": list(g.weak_closures),
                "timer": (dict(g.timer.totals), dict(g.timer.counts))}

    def stream(self, url: str, n_scans: int, latencies: list) -> dict:
        raise NotImplementedError("graph SLAM has no streaming entry")


def to_host(out: dict) -> dict:
    return out


def reference(config: dict, ranges: np.ndarray, device,
              dtype=torch.float32, outputs=()) -> dict:
    """The plain reference on ``ranges``: the whole graph mode (its path),
    and its backend alone on the keyframes of each distinct session in
    ``outputs`` (its closures and optimized keyframe poses on those
    keyframes), with the kernel work of a session
    (``roofline.least_seconds``'s form)."""
    from slambench.reference import graph

    # the solve's precision: float64 for the float32 reference, bfloat16
    # for the control
    gn = np.float64 if dtype == torch.float32 else "bfloat16"
    args = (config["slam"], config["loop_closure"], config["max_keyframes"],
            config["chunk_size"], device, dtype, gn)
    whole = graph.run_graph(ranges, *args)
    follow = {}
    for o in outputs:
        key = tuple(o["kf_times"])
        if key not in follow:
            follow[key] = graph.follow_backend(
                ranges, list(key), o["path"][list(key)], *args)
    back = next(iter(follow.values()), whole)
    g, lc = config["slam"]["grid"], config["loop_closure"]
    s, fs = lc["raster_size"], lc["fine_size"]
    work = {"fields": [(g["coarse_size"], g["coarse_size"],
                        whole["refreshes"]),
                       (g["fine_size"], g["fine_size"], whole["refreshes"]),
                       (s, s, back["fields_made"]), (fs, fs, back["refined"])],
            "volumes": [(lc["n_theta"], n, lc["window_half"], s)
                        for n in back["vol_beams"]]}
    return {"path": whole["path"], "kf_poses": whole["kf_poses"],
            "kf_times": whole["kf_times"], "closures": whole["closures"],
            "weak_closures": [], "follow": follow, "work": work}


def compare(config: dict, outs: list[dict], ref: dict) -> list:
    """(name, value, limit), each the widest over the sessions:

    - ``path_gap_m``: the path's xy gap from the reference's whole run, scan
      by scan. The frontend is exact until a solve rebuilds its map; the
      program's float32 solve and the reference's float64 one then differ
      by their rounding, which can move a later match by one step (PERF.md);
    - ``keyframe_gap_m`` and ``closures_differ``: the session's optimized
      keyframe poses (xy) and closures against the reference's backend run
      on the session's own keyframes (their scans and frontend poses), so a
      frontend one step apart does not make them differ."""
    lim = config["limits"]
    path_gap = kf_gap = closures = 0.0
    for o in outs:
        if o["path"].shape != ref["path"].shape:
            path_gap = float("inf")
        else:
            path_gap = max(path_gap, float(np.nan_to_num(np.abs(
                o["path"][:, :2] - ref["path"][:, :2]), nan=np.inf).max()))
        back = ref["follow"][tuple(o["kf_times"])]
        closures = max(closures, float(len(
            set(map(tuple, o["closures"])) ^ set(back["closures"]))
            + len(o["weak_closures"])))
        if o["kf_poses"].shape != back["kf_poses"].shape:
            kf_gap = float("inf")
        else:
            kf_gap = max(kf_gap, float(np.nan_to_num(np.abs(
                o["kf_poses"][:, :2] - back["kf_poses"][:, :2]),
                nan=np.inf).max()))
    return [("path_gap_m", path_gap, lim["path_gap_m"]),
            ("keyframe_gap_m", kf_gap, lim["keyframe_gap_m"]),
            ("closures_differ", closures, lim["closures_differ"])]
