"""Graph SLAM over the submap atlas: loop closures re-anchor submaps rigidly
(counterpart of ``lidar_slam_tpu.models.submap_graph_slam``).

``GraphSlam`` with the submap frontend (``models/submap_slam``). Each submap
is tied to its nearest keyframe when it first appears, by the rigid
relation between the two at that moment; after an optimization every
associated anchor becomes ``compose_ref(kf_pose_i, rel_s)``, so the map
correction rewrites M anchors and no point. Closure matching is the
backend's (kernel K2 batched over candidates, K1 on the keyframe and
refine rasters); the frontend runs K1 on its keyframe rasters.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_tpu_torch.core import submap
from lidar_slam_tpu_torch.models import graph_slam, submap_slam
from lidar_slam_tpu_torch.models.graph_slam import GraphSlam


class SubmapGraphSlam(GraphSlam):
    """GraphSlam with the submap-atlas frontend and anchor feedback."""

    frontend = submap_slam

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # submap slot -> (keyframe index, rigid relation kf -> anchor)
        self.anchor_assoc: dict[int, tuple[int, np.ndarray]] = {}

    def _post_chunk(self, state) -> None:
        """Associate the chunk's new submaps with their nearest keyframes,
        before any optimization of the chunk, while anchor and keyframe
        poses are still in the same frontend frame. One copy of the anchors
        when a submap is new; host numpy after it."""
        n = state.atlas.n_submaps
        if not self.kf_poses or all(s in self.anchor_assoc
                                    for s in range(n)):
            return
        anchors = state.atlas.anchors[:n].cpu().numpy()
        kf = np.stack(self.kf_poses)                       # (K, 3) ref conv
        for s in range(n):
            if s in self.anchor_assoc:
                continue
            d = np.hypot(kf[:, 0] - anchors[s, 0], kf[:, 1] - anchors[s, 1])
            i = int(np.argmin(d))
            self.anchor_assoc[s] = (
                i, graph_slam._np_between_ref(kf[i], anchors[s]))

    def _corrected_anchors(self, anchors: np.ndarray) -> torch.Tensor:
        """Every associated anchor recomputed from the current keyframe
        estimates (host numpy), on the device."""
        anchors = anchors.copy()
        for s, (i, rel) in self.anchor_assoc.items():
            if s >= anchors.shape[0] or i >= len(self.kf_poses):
                continue
            anchors[s] = graph_slam._np_compose_ref(self.kf_poses[i], rel)
        return torch.as_tensor(anchors, device=self.device)

    def _rebuild_frontend(self, state):
        """Fold the optimized keyframes into the live state: re-anchor the
        submaps and re-express the tracked pose relative to the last
        keyframe (the flat-map version's pose math, no point rewrites).
        One copy of the poses and anchors; host numpy; uploads only."""
        fb = torch.cat([torch.stack([state.keyframe_pose, state.pose,
                                     state.prev_pose]),
                        state.atlas.anchors]).cpu().numpy()
        old_last, cur_pose, prev_pose = fb[0], fb[1], fb[2]
        new_last = self.kf_poses[-1]

        def correct(pose):
            z = graph_slam._np_between_ref(old_last, pose)
            return torch.as_tensor(graph_slam._np_compose_ref(new_last, z),
                                   device=self.device)

        atlas = submap.apply_anchor_correction(
            state.atlas, self._corrected_anchors(fb[3:]))
        new_pose = correct(cur_pose)
        return state._replace(pose=new_pose, prev_pose=correct(prev_pose),
                              keyframe_pose=new_pose.clone(),
                              mini_updated=True, atlas=atlas)

    def world_map(self, state) -> np.ndarray:
        """All submap points in the world frame under the current anchors,
        (P, 2) numpy."""
        wx, wy, mask = submap.submap_world_points(state.atlas)
        wx, wy, mask = wx.cpu().numpy(), wy.cpu().numpy(), mask.cpu().numpy()
        return np.stack([wx[mask], wy[mask]], axis=1)
