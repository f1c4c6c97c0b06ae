"""Submap SLAM: the scan-to-map pipeline over a tiled submap atlas
(counterpart of ``lidar_slam_tpu.models.submap_slam``).

The per-scan structure of ``models/scan_matcher`` with the point map
replaced by a ``core.submap.SubmapAtlas``: on keyframe steps the local map
is gathered from the K nearest submaps and rastered at both resolutions
(kernel K1 at (1, 200, 200) and (1, 400, 400) on CUDA); the two-stage
correlative match follows; novel points go into the active submap in its
anchor frame, and a new submap is opened first when the robot has left the
active anchor's neighbourhood or the active submap is nearly full. A
loop-closure correction re-anchors submaps rigidly
(``models/submap_graph_slam``).

JAX's four ``lax.cond``s become host branches. ``mini_updated`` and
``step`` are host values; the keyframe test and the two spawn tests (far
from the anchor, submap full) reach the host in one copy, the step's one
device->host sync. The stale-transform quirk of the fidelity pipeline is
kept: after a refresh the map update reuses the scan transformed with the
pre-match pose.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.core import gridmap, se2, sensor, submap
from lidar_slam_tpu_torch.core.gridmap import OccGrid
from lidar_slam_tpu_torch.core.submap import SubmapAtlas
from lidar_slam_tpu_torch.device import resolve_device, rounded64
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.ops import matching


class SubmapSlamState(NamedTuple):
    pose: torch.Tensor           # (3,)
    prev_pose: torch.Tensor      # (3,) constant-velocity prior
    step: int
    mini_updated: bool
    keyframe_pose: torch.Tensor  # (3,) last map-update pose
    atlas: SubmapAtlas
    coarse: OccGrid
    fine: OccGrid
    coarse_metric: torch.Tensor  # (Sc, Sc) f32
    fine_metric: torch.Tensor    # (Sf, Sf) f32
    scan_wx: torch.Tensor        # (N,) cached world-frame scan
    scan_wy: torch.Tensor


def init_state(ranges0: torch.Tensor, cfg: SlamConfig,
               pose0=(0.0, 0.0, 0.0)) -> SubmapSlamState:
    """Atlas := one submap anchored at ``pose0`` holding scan 0."""
    dev = ranges0.device
    sm, g = cfg.submaps, cfg.grid
    scan = sensor.read_scan(ranges0, angles_tensor(cfg, dev), cfg.lidar)
    pose = torch.tensor(pose0, dtype=torch.float32, device=dev)
    wx, wy = se2.transform_ref(scan.x, scan.y, pose)
    atlas = submap.empty_atlas(sm.n_submaps, sm.submap_capacity, dev)
    atlas = submap.start_submap(atlas, pose)
    atlas = submap.insert_world_points(atlas, wx, wy, scan.valid)
    return SubmapSlamState(
        pose=pose, prev_pose=pose.clone(), step=1, mini_updated=True,
        keyframe_pose=pose.clone(), atlas=atlas,
        coarse=gridmap.empty_grid(g.coarse_size, g.coarse_pixel, dev),
        fine=gridmap.empty_grid(g.fine_size, g.fine_pixel, dev),
        coarse_metric=torch.zeros((g.coarse_size, g.coarse_size),
                                  dtype=torch.float32, device=dev),
        fine_metric=torch.zeros((g.fine_size, g.fine_size),
                                dtype=torch.float32, device=dev),
        scan_wx=wx, scan_wy=wy)


def slam_step(state: SubmapSlamState, ranges: torch.Tensor, cfg: SlamConfig,
              angles: torch.Tensor) -> tuple[SubmapSlamState, torch.Tensor]:
    """One scan; returns (new_state, pose)."""
    g, m, mc, sm = cfg.grid, cfg.map, cfg.matcher, cfg.submaps
    scan = sensor.read_scan(ranges, angles, cfg.lidar)

    # --- keyframe-gated refresh of the local map from the atlas
    if state.mini_updated:
        scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, state.pose)
        local = submap.extract_local_from_atlas(
            state.atlas, state.pose, scan_wx, scan_wy, scan.valid,
            g.border_size, sm.k_nearest)
        coarse, fine = gridmap.rasterize_dual(local, g)
        coarse_metric = edt_ops.edt(coarse.occ, int(g.max_dist_px))
        fine_metric = edt_ops.edt(fine.occ, int(g.max_dist_px))
    else:
        coarse, fine = state.coarse, state.fine
        coarse_metric, fine_metric = state.coarse_metric, state.fine_metric
        scan_wx, scan_wy = state.scan_wx, state.scan_wy

    guess = (state.pose + (state.pose - state.prev_pose) if state.step > 1
             else state.pose)
    if state.mini_updated:
        m1 = matching.fast_match(coarse_metric, coarse, scan.x, scan.y,
                                 scan.valid, guess, mc.coarse_t, mc.coarse_r)
    else:
        m1 = matching.fast_match(fine_metric, fine, scan.x, scan.y,
                                 scan.valid, guess, mc.coarse_t, mc.coarse_r)
    m2 = matching.fast_match(fine_metric, fine, scan.x, scan.y, scan.valid,
                             m1.pose, mc.fine_t, mc.fine_r)
    new_pose = m2.pose

    # --- the keyframe test and the spawn tests: one copy to the host
    atlas = state.atlas
    dp = torch.abs(new_pose - state.keyframe_pose)
    moved = ((dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt)
             | (dp[2] > m.mini_update_dr))
    anchor = atlas.anchors[atlas.active]
    far = rounded64(torch.hypot, new_pose[0] - anchor[0],
                    new_pose[1] - anchor[1]) > sm.spawn_dist
    full = atlas.sizes[atlas.active] >= int(sm.spawn_fill_frac
                                            * sm.submap_capacity)
    moved, far, full = torch.stack([moved, far, full]).tolist()

    kf_pose = state.keyframe_pose
    if moved:
        if not state.mini_updated:
            scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, new_pose)
        j = torch.arange(scan_wx.shape[0], device=scan_wx.device)
        select = (j < m2.best_count) & (m2.last_hits > m.new_point_threshold)
        if far or full:
            atlas = submap.start_submap(atlas, new_pose)
        atlas = submap.insert_world_points(atlas, scan_wx, scan_wy, select)
        kf_pose = new_pose

    new_state = SubmapSlamState(
        pose=new_pose, prev_pose=state.pose, step=state.step + 1,
        mini_updated=moved, keyframe_pose=kf_pose, atlas=atlas,
        coarse=coarse, fine=fine, coarse_metric=coarse_metric,
        fine_metric=fine_metric, scan_wx=scan_wx, scan_wy=scan_wy)
    return new_state, new_pose


def make_step_fn(cfg: SlamConfig, device: str | torch.device = "cuda"):
    """``step(state, ranges) -> (state, pose)`` with the beam angles bound
    on ``device``."""
    angles = angles_tensor(cfg, resolve_device(device))

    def step(state, ranges):
        return slam_step(state, ranges, cfg, angles)

    return step


def _as_ranges(ranges_all, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ranges_all, np.float32),
                           device=resolve_device(device))


def run_host_loop(ranges_all: np.ndarray, cfg: SlamConfig,
                  device: str | torch.device = "cuda"
                  ) -> tuple[np.ndarray, SubmapSlamState]:
    """Streaming run: each pose copied to the host as it is produced.
    Returns (path (T, 3) numpy, final state)."""
    ranges = _as_ranges(ranges_all, device)
    step = make_step_fn(cfg, ranges.device)
    state = init_state(ranges[0], cfg)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, ranges.shape[0]):
        state, pose = step(state, ranges[t])
        poses.append(pose.cpu().numpy())
    return np.stack(poses), state


def run_scan(ranges_all: np.ndarray, cfg: SlamConfig,
             device: str | torch.device = "cuda"
             ) -> tuple[torch.Tensor, SubmapSlamState]:
    """Whole-log run: poses stay on the device until the end. Returns
    (path (T, 3) tensor on ``device``, final state)."""
    ranges = _as_ranges(ranges_all, device)
    step = make_step_fn(cfg, ranges.device)
    state = init_state(ranges[0], cfg)
    poses = [state.pose]
    for t in range(1, ranges.shape[0]):
        state, pose = step(state, ranges[t])
        poses.append(pose)
    return torch.stack(poses), state
