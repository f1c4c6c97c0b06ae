"""The 1024-particle filter as the benchmark runs it.

A replay session is ``models.fastslam.run_pf`` on the whole log with the
configuration's ``pf_seed``: the captured step (one graph a scan, the
keyframe refresh in an IF node, no host read a scan), its proposal noise
and resampling offsets drawn from the session's own generator on the card.
What a session produced is its path, its final particles and log weights,
its point map and its fine distance field; each is held to the plain
reference (``reference/pf.py``), which draws the same numbers from the same
seed on the same device and runs the filter with no code of the program.

The configuration states float32 with the particle reductions rounded
through float64, which makes every decision (the volume is exact on the
field's lattice, the argmins and the resampling take rounded values) the
same in the program and the reference, so every comparison is exact:
limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.systems.fidelity import _gap, program_config


class Program:
    """The program for ``config`` on ``device``."""

    def __init__(self, config: dict, device: str):
        self.cfg = program_config(config)
        self.seed = int(config["pf_seed"])
        self.device = device

    def replay(self, ranges: np.ndarray) -> dict:
        from lidar_slam_tpu_torch.models import fastslam

        path, state = fastslam.run_pf(ranges, self.cfg, seed=self.seed,
                                      device=self.device)
        return {"path": path, "poses": state.poses, "logw": state.logw,
                "map_xy": state.pmap.xy, "map_size": state.pmap.size,
                "fine": state.fine_metric}

    def stream(self, url: str, n_scans: int, latencies: list) -> dict:
        raise NotImplementedError("the particle filter has no streaming "
                                  "entry")


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
    session of them needs (``roofline.least_seconds``'s form): a fine field
    a keyframe refresh and a volume a scan after the first. Every session
    maps the same rows from the same seed, so ``outputs`` changes nothing
    here."""
    from slambench.reference import pf

    ref = pf.ParticleFilter(config["slam"], config["pf_seed"], device, dtype)
    out = ref.run(ranges)
    g, pc = config["slam"]["grid"], config["slam"]["particles"]
    out["work"] = {
        "fields": [(g["fine_size"], g["fine_size"], ref.refreshes)],
        "volumes": [(pc["vol_theta_bins"], n, pc["vol_half"], g["fine_size"])
                    for n in ref.vol_beams]}
    out["refreshes"], out["resamples"] = ref.refreshes, ref.resamples
    return out


def compare(config: dict, outs: list[dict], ref: dict) -> list:
    """(name, value, limit) of every number compared, each the widest over
    the sessions: the path's x and y (``path_gap_m``) and heading
    (``heading_gap_rad``), the final particles' x and y in particle order
    (``particles_gap_m``), the point map's size (``map_points_gap``) and
    the final fine field (``field_gap``)."""
    lim = config["limits"]
    rows = {"path_gap_m": 0.0, "heading_gap_rad": 0.0,
            "particles_gap_m": 0.0, "map_points_gap": 0.0, "field_gap": 0.0}
    for o in outs:
        for name, gap in (
                ("path_gap_m", _gap(o["path"][:, :2], ref["path"][:, :2])),
                ("heading_gap_rad", _gap(o["path"][:, 2], ref["path"][:, 2])),
                ("particles_gap_m", _gap(o["poses"][:, :2],
                                         ref["poses"][:, :2])),
                ("map_points_gap", float(abs(len(o["map_xy"])
                                             - len(ref["map_xy"])))),
                ("field_gap", _gap(o["fine"], ref["fine"]))):
            rows[name] = max(rows[name], gap)
    return [(k, v, lim[k]) for k, v in rows.items()]
