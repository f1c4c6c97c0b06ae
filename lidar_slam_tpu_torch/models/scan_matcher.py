"""The single-hypothesis scan-to-map SLAM pipeline, fidelity mode
(counterpart of ``lidar_slam_tpu.models.scan_matcher``).

Per scan: gate/convert, keyframe-gated local-map raster + EDT (kernel K1 on
CUDA), constant-velocity prediction, two-stage correlative match (coarse or
fine grid, then fine), and the mini-update rule appending novel points.

JAX's ``lax.cond`` branches become host branches: ``mini_updated`` is a host
bool carried in the state, and ``moved`` costs one device->host sync per
scan. ``step`` is a host int. Everything else stays on the state's device.

Reference quirks kept (required for trajectory parity):
- the scan's world-frame transform is cached across steps and is stale at
  map-update time when the step began with ``mini_updated`` set
  (main.c:867 writes it with the pre-match pose; main.c:944-945 reuse it);
- the map update takes beams by position in the *last* candidate's in-bounds
  compaction, with the *best* candidate's count (main.c:941-948);
- the first matcher stage runs on the coarse grid only on keyframe steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.core import gridmap, se2, sensor
from lidar_slam_tpu_torch.core.gridmap import OccGrid, PointMap
from lidar_slam_tpu_torch.device import resolve_device
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.ops import matching


class SlamState(NamedTuple):
    pose: torch.Tensor           # (3,) current pose (path[t-1])
    prev_pose: torch.Tensor      # (3,) path[t-2], constant-velocity prior
    step: int                    # scan index of the *next* scan
    mini_updated: bool
    pmap: PointMap
    coarse: OccGrid
    fine: OccGrid
    coarse_metric: torch.Tensor  # (Sc, Sc) f32 EDT likelihood field
    fine_metric: torch.Tensor    # (Sf, Sf) f32
    scan_wx: torch.Tensor        # (N,) cached world-frame scan (stale by design)
    scan_wy: torch.Tensor


def angles_tensor(cfg: SlamConfig, device) -> torch.Tensor:
    return torch.as_tensor(sensor.beam_angles(cfg.lidar), device=device)


def init_state(ranges0: torch.Tensor, cfg: SlamConfig,
               pose0=(0.0, 0.0, 0.0)) -> SlamState:
    """Initialise from scan 0 (main.c:842-857): map := scan 0."""
    dev = ranges0.device
    scan = sensor.read_scan(ranges0, angles_tensor(cfg, dev), cfg.lidar)
    pose = torch.tensor(pose0, dtype=torch.float32, device=dev)
    wx, wy = se2.transform_ref(scan.x, scan.y, pose)
    pmap = gridmap.init_point_map(wx, wy, scan.valid, pose,
                                  cfg.map.map_capacity)
    g = cfg.grid
    return SlamState(
        pose=pose, prev_pose=pose.clone(), step=1, mini_updated=True,
        pmap=pmap,
        coarse=gridmap.empty_grid(g.coarse_size, g.coarse_pixel, dev),
        fine=gridmap.empty_grid(g.fine_size, g.fine_pixel, dev),
        coarse_metric=torch.zeros((g.coarse_size, g.coarse_size),
                                  dtype=torch.float32, device=dev),
        fine_metric=torch.zeros((g.fine_size, g.fine_size),
                                dtype=torch.float32, device=dev),
        scan_wx=wx, scan_wy=wy)


def slam_step(state: SlamState, ranges: torch.Tensor, cfg: SlamConfig,
              angles: torch.Tensor, pose_to_host: bool = False
              ) -> tuple[SlamState, torch.Tensor | np.ndarray]:
    """Process one scan; returns (new_state, pose). With ``pose_to_host``
    the pose comes back as a numpy array in the same device->host copy as
    the keyframe test, so a host loop that needs every pose pays one sync a
    scan, not two."""
    g, m, mc = cfg.grid, cfg.map, cfg.matcher
    scan = sensor.read_scan(ranges, angles, cfg.lidar)

    # --- keyframe-gated map refresh (main.c:865-872)
    if state.mini_updated:
        scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, state.pose)
        local = gridmap.extract_local_map(state.pmap, scan_wx, scan_wy,
                                          scan.valid, g.border_size)
        coarse, fine = gridmap.rasterize_dual(local, g)
        coarse_metric = edt_ops.edt(coarse.occ, int(g.max_dist_px))
        fine_metric = edt_ops.edt(fine.occ, int(g.max_dist_px))
    else:
        coarse, fine = state.coarse, state.fine
        coarse_metric, fine_metric = state.coarse_metric, state.fine_metric
        scan_wx, scan_wy = state.scan_wx, state.scan_wy

    # --- constant-velocity prediction (main.c:875-898)
    guess = (state.pose + (state.pose - state.prev_pose) if state.step > 1
             else state.pose)

    # --- two-stage correlative matching (main.c:901-918)
    wt, wr = int(mc.window_t), int(mc.window_r)
    pen = float(mc.window_penalty_px)
    if state.mini_updated:
        m1 = matching.fast_match(coarse_metric, coarse, scan.x, scan.y,
                                 scan.valid, guess, mc.coarse_t, mc.coarse_r,
                                 wt, wr, pen)
    else:
        m1 = matching.fast_match(fine_metric, fine, scan.x, scan.y,
                                 scan.valid, guess, mc.coarse_t, mc.coarse_r,
                                 wt, wr, pen)
    m2 = matching.fast_match(fine_metric, fine, scan.x, scan.y, scan.valid,
                             m1.pose, mc.fine_t, mc.fine_r, wt, wr, pen)
    new_pose = m2.pose

    # --- mini-update rule (main.c:928-961); the one host sync of the step
    dp = torch.abs(new_pose - state.pmap.keyframe_pose)
    test = ((dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt)
            | (dp[2] > m.mini_update_dr))
    if pose_to_host:
        host = torch.cat([new_pose, test.to(new_pose.dtype)[None]]).cpu()
        moved, out_pose = bool(host[3]), host[:3].numpy()
    else:
        moved, out_pose = bool(test.item()), new_pose
    pmap = state.pmap
    if moved:
        # Without a refresh this step the C code re-transforms the scan with
        # the new pose (main.c:935-937); after one, the cached pre-match
        # transform is (mis)used as it is.
        if not state.mini_updated:
            scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, new_pose)
        j = torch.arange(scan_wx.shape[0], device=scan_wx.device)
        select = (j < m2.best_count) & (m2.last_hits > m.new_point_threshold)
        pmap = gridmap.append_points(state.pmap, scan_wx, scan_wy, select,
                                     new_pose)

    new_state = SlamState(
        pose=new_pose, prev_pose=state.pose, step=state.step + 1,
        mini_updated=moved, pmap=pmap, coarse=coarse, fine=fine,
        coarse_metric=coarse_metric, fine_metric=fine_metric,
        scan_wx=scan_wx, scan_wy=scan_wy)
    return new_state, out_pose


def _as_ranges(ranges_all, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ranges_all, np.float32),
                           device=resolve_device(device))


def run_host_loop(ranges_all: np.ndarray, cfg: SlamConfig,
                  device: str | torch.device = "cuda"
                  ) -> tuple[np.ndarray, SlamState]:
    """Streaming driver: one scan at a time, each pose copied to the host
    as it is produced. Returns (path (T, 3) numpy, final state)."""
    ranges = _as_ranges(ranges_all, device)
    angles = angles_tensor(cfg, ranges.device)
    state = init_state(ranges[0], cfg)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, ranges.shape[0]):
        state, pose = slam_step(state, ranges[t], cfg, angles,
                                pose_to_host=True)
        poses.append(pose)
    return np.stack(poses), state


def run_scan(ranges_all: np.ndarray, cfg: SlamConfig,
             device: str | torch.device = "cuda"
             ) -> tuple[torch.Tensor, SlamState]:
    """Whole-dataset driver: poses stay on the device until the end.
    Returns (path (T, 3) tensor on ``device``, final state)."""
    ranges = _as_ranges(ranges_all, device)
    angles = angles_tensor(cfg, ranges.device)
    state = init_state(ranges[0], cfg)
    poses = [state.pose]
    for t in range(1, ranges.shape[0]):
        state, pose = slam_step(state, ranges[t], cfg, angles)
        poses.append(pose)
    return torch.stack(poses), state
