"""The fidelity scan-to-map pipeline as the benchmark runs it.

A replay session is ``models.scan_matcher.run_scan`` on the whole log (the
captured step, no host read a scan); a streamed session is
``io.server.run_streaming_slam`` (the captured step with one host read a
scan). What a session produced is its path and its final state's point map
and distance fields; each is held to the plain reference
(``reference/fidelity.py``) run on the same rows.

The configuration states float32 and the reference program's trajectory bit
for bit, so every comparison is exact: limit 0.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def program_config(config: dict):
    from lidar_slam_tpu_torch.config import SlamConfig

    return SlamConfig.from_json(json.dumps(config["slam"]))


class Program:
    """The program for ``config`` on ``device``."""

    def __init__(self, config: dict, device: str):
        self.cfg = program_config(config)
        self.device = device

    def replay(self, ranges: np.ndarray) -> dict:
        from lidar_slam_tpu_torch.models import scan_matcher

        path, state = scan_matcher.run_scan(ranges, self.cfg,
                                            device=self.device)
        return _outputs(path, state)

    def stream(self, url: str, n_scans: int, latencies: list) -> dict:
        from lidar_slam_tpu_torch.io import server

        path, state = server.run_streaming_slam(
            url, n_scans, self.cfg, device=self.device, latencies=latencies)
        return _outputs(torch.as_tensor(path), state)


def _outputs(path, state) -> dict:
    """A session's outputs, still where the program left them."""
    return {"path": path, "map_xy": state.pmap.xy, "map_size": state.pmap.size,
            "coarse": state.coarse_metric, "fine": state.fine_metric}


def to_host(out: dict) -> dict:
    """A session's outputs as NumPy, the map cut to its size."""
    host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}
    size = int(host.pop("map_size"))
    host["map_xy"] = host["map_xy"][:size]
    return host


def reference(config: dict, ranges: np.ndarray, device,
              dtype=torch.float32, outputs=()) -> dict:
    """The plain reference's outputs on ``ranges``, and the kernel work a
    session of them needs (``roofline.least_seconds``'s form). Every
    session maps the same rows, so ``outputs`` changes nothing here."""
    from slambench.reference import fidelity

    path, st, refreshes = fidelity.Fidelity(config["slam"], device,
                                            dtype).run(ranges)
    coarse, fine = fidelity.final_fields(st)
    g = config["slam"]["grid"]
    work = {"fields": [(g["coarse_size"], g["coarse_size"], refreshes),
                       (g["fine_size"], g["fine_size"], refreshes)],
            "volumes": []}
    return {"path": path,
            "map_xy": st.map_xy.to(torch.float32).cpu().numpy(),
            "coarse": coarse, "fine": fine, "work": work}


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    if a.shape != b.shape:
        return float("inf")
    if not a.size:
        return 0.0
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float(np.nan_to_num(d, nan=np.inf).max())


def compare(config: dict, outs: list[dict], ref: dict) -> list:
    """(name, value, limit) of every number compared: the widest gap over
    the sessions between each output and the reference's."""
    lim = config["limits"]
    rows = {"path_gap": 0.0, "map_points_gap": 0.0, "map_xy_gap": 0.0,
            "field_gap": 0.0}
    for o in outs:
        rows["path_gap"] = max(rows["path_gap"], _gap(o["path"], ref["path"]))
        rows["map_points_gap"] = max(rows["map_points_gap"], float(abs(
            len(o["map_xy"]) - len(ref["map_xy"]))))
        n = min(len(o["map_xy"]), len(ref["map_xy"]))
        rows["map_xy_gap"] = max(rows["map_xy_gap"], _gap(
            o["map_xy"][:n], ref["map_xy"][:n]))
        rows["field_gap"] = max(rows["field_gap"],
                                _gap(o["coarse"], ref["coarse"]),
                                _gap(o["fine"], ref["fine"]))
    return [(k, v, lim[k]) for k, v in rows.items()]
