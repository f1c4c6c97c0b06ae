"""Hybrid grid + landmark EKF-FastSLAM (counterpart of
``lidar_slam_tpu.models.ekf_hybrid``).

The landmark filter (``models/ekf_slam``) weights particles on corner
landmarks only and drifts through stretches without corners; this model
adds the grid likelihood of the particle filter to every weight:

    log w_p += sum_det loglik_landmark(p, det)  -  avg_edt_dist(p) / temp

Per scan: one correlation volume around the odometry-predicted mean pose
(kernel K2 on CUDA, B=1 T=7 half=6 on the 400^2 fine field with the
default config), the ML-association EKF step with the volume's lookups as
its extra log-likelihood, the weighted mean refined by three argmin passes
over 27 candidates, and on keyframe steps (the reference's mini-update
rule) novel points appended to the shared map and the fine raster and its
EDT rebuilt (kernel K1 at (1, 400, 400)). Detections and scan odometry
come from batched pre-passes over the whole log (``ops/landmarks``;
``ops/scan_odometry.pairwise_odometry``, K1 at (50, 448, 448)).

JAX's ``lax.cond`` on the keyframe test becomes one host branch a scan
(the step's one device->host sync); ``step`` and ``mini_updated`` are host
values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.core import gridmap, se2, sensor
from lidar_slam_tpu_torch.core.gridmap import OccGrid, PointMap
from lidar_slam_tpu_torch.device import constant, resolve_device
from lidar_slam_tpu_torch.models import ekf_slam
from lidar_slam_tpu_torch.models.ekf_slam import (EkfSlamConfig, EkfSlamState,
                                                  ekf_slam_step_ml,
                                                  init_ekf_slam)
from lidar_slam_tpu_torch.models.fastslam import _OFFS27
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor
from lidar_slam_tpu_torch.ops import correlative
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.ops import matching


class HybridState(NamedTuple):
    ekf: EkfSlamState           # particle poses + landmark banks
    pmap: PointMap              # shared world-frame point map
    fine: OccGrid               # fine raster of the local map
    fine_metric: torch.Tensor   # (Sf, Sf) clamped-EDT likelihood field
    step: int
    mini_updated: bool


def init_hybrid(ranges0: torch.Tensor, ekf_cfg: EkfSlamConfig,
                cfg: SlamConfig, seed: int = 0) -> HybridState:
    """Map := scan 0 at the origin; the state lives on ``ranges0``'s
    device."""
    dev = ranges0.device
    scan = sensor.read_scan(ranges0, angles_tensor(cfg, dev), cfg.lidar)
    pose = torch.zeros(3, dtype=torch.float32, device=dev)
    wx, wy = se2.transform_ref(scan.x, scan.y, pose)
    pmap = gridmap.init_point_map(wx, wy, scan.valid, pose,
                                  cfg.map.map_capacity)
    g = cfg.grid
    return HybridState(
        ekf=init_ekf_slam(ekf_cfg, seed, dev), pmap=pmap,
        fine=gridmap.empty_grid(g.fine_size, g.fine_pixel, dev),
        fine_metric=torch.zeros((g.fine_size, g.fine_size),
                                dtype=torch.float32, device=dev),
        step=1, mini_updated=True)


def hybrid_step(state: HybridState, ranges: torch.Tensor, obs: torch.Tensor,
                obs_valid: torch.Tensor, odo: torch.Tensor,
                ekf_cfg: EkfSlamConfig, cfg: SlamConfig,
                angles: torch.Tensor, draws=None, n_det: int | None = None
                ) -> tuple[HybridState, torch.Tensor]:
    """One hybrid step: obs (M, 2) corner detections of this scan (the
    first ``n_det`` valid), odo (3,) its scan-odometry delta. Returns
    (state, estimated pose)."""
    pc, g, m, mc = cfg.particles, cfg.grid, cfg.map, cfg.matcher
    dev = ranges.device
    scan = sensor.read_scan(ranges, angles, cfg.lidar)

    # --- correlation volume(s) around the odometry-predicted mean pose
    mean_pose = ekf_slam._weighted_mean(state.ekf.logw, state.ekf.poses)
    c, s = ekf_slam._cos_sin(mean_pose[2])
    base = torch.stack([mean_pose[0] + c * odo[0] + s * odo[1],
                        mean_pose[1] - s * odo[0] + c * odo[1],
                        mean_pose[2] + odo[2]])
    vols = correlative.build_cascade(
        state.fine_metric, state.fine, scan.x, scan.y, scan.valid, base,
        n_theta=pc.vol_theta_bins, theta_step=mc.fine_r, half=pc.vol_half,
        levels=pc.cascade_levels)

    def grid_loglik(poses):
        d, _ = correlative.lookup_cascade(vols, poses)
        return -correlative.true_div(d, pc.score_temperature)

    ekf2, _ = ekf_slam_step_ml(state.ekf, obs, obs_valid, ekf_cfg, odo=odo,
                               aux_loglik_fn=grid_loglik, draws=draws,
                               n_det=n_det)

    # --- estimate: weighted mean + three 27-candidate argmin refinements
    est_pose = ekf_slam._weighted_mean(ekf2.logw, ekf2.poses)
    steps = np.asarray([mc.fine_t, mc.fine_t, mc.fine_r], np.float32)
    offs = constant(tuple(map(tuple, (_OFFS27 * steps).tolist())), dev)
    for _ in range(3):
        cands = est_pose[None, :] + offs
        d, _ = correlative.lookup_cascade(vols, cands)
        est_pose = cands[torch.argmin(d).view(1)][0]   # no host sync

    # --- keyframe refresh of the shared map; the step's one host sync
    dp = torch.abs(est_pose - state.pmap.keyframe_pose)
    moved = state.step == 1 or bool(
        ((dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt)
         | (dp[2] > m.mini_update_dr)).item())
    pmap, fine, fine_metric = state.pmap, state.fine, state.fine_metric
    if moved:
        wx, wy = se2.transform_ref(scan.x, scan.y, est_pose)
        if state.step == 1:
            novel = scan.valid   # the field is still empty: seed from all
        else:
            _, hits, inb = matching.score_candidates(
                state.fine_metric, state.fine, scan.x, scan.y, scan.valid,
                est_pose[None])
            novel = (hits[0] > m.new_point_threshold) & inb[0]
        pmap = gridmap.append_points(state.pmap, wx, wy, novel, est_pose)
        local = gridmap.extract_local_map(pmap, wx, wy, scan.valid,
                                          g.border_size)
        min_xy, max_xy = gridmap.local_bounds(local)
        fine = gridmap.rasterize(local, g.fine_pixel, g.fine_size, min_xy,
                                 max_xy, g.margin_pixels)
        fine_metric = edt_ops.edt(fine.occ, int(g.max_dist_px))

    return HybridState(ekf=ekf2, pmap=pmap, fine=fine,
                       fine_metric=fine_metric, step=state.step + 1,
                       mini_updated=moved), est_pose


def run_ekf_hybrid(ranges_all: np.ndarray, ekf_cfg: EkfSlamConfig,
                   cfg: SlamConfig | None = None, seed: int = 0,
                   max_range: float = 12.0,
                   device: str | torch.device = "cuda", draws=None,
                   **extract_kw) -> tuple[torch.Tensor, HybridState]:
    """Whole-log hybrid run: raw (T, N) ranges -> (path (T, 3) on
    ``device``, final state). Corner detections and scan odometry come
    from batched pre-passes; the detection counts reach the host in one
    copy. ``draws``: per-step (noise, u0) for steps 1..T-1."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.ops import landmarks as lm_ops
    from lidar_slam_tpu_torch.ops.scan_odometry import pairwise_odometry

    cfg = cfg or DEFAULT_CONFIG
    dev = resolve_device(device)
    ranges = torch.as_tensor(np.asarray(ranges_all, np.float32), device=dev)
    angles = angles_tensor(cfg, dev)
    det = lm_ops.extract_corners(
        ranges, angles, range_min=cfg.lidar.range_min,
        usable_range=cfg.lidar.usable_range, max_range=max_range,
        **extract_kw)
    odo_all = pairwise_odometry(ranges, angles, cfg.lidar)
    counts = det.count.cpu().numpy()            # one copy for the whole log
    state = init_hybrid(ranges[0], ekf_cfg, cfg, seed)
    ests = []
    for t in range(1, ranges.shape[0]):
        state, est = hybrid_step(
            state, ranges[t], det.rb[t], det.valid[t], odo_all[t - 1],
            ekf_cfg, cfg, angles, None if draws is None else draws[t - 1],
            n_det=int(counts[t]))
        ests.append(est)
    return ekf_slam._path(ests, dev), state
