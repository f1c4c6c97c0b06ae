"""Particle-filter frontend + pose-graph closure feedback (counterpart of
``lidar_slam_tpu.models.pf_graph_slam``).

The particle filter (``models/fastslam.py``, its captured step
``make_pf_step``) runs as the frontend inside the ``GraphSlam``
orchestrator; every accepted closure that moves the graph
re-anchors the whole particle cloud rigidly by the optimized correction
(pose' = opt_k (+) (old_k (-) pose), relative weights kept), rebuilds the
shared point map from the keyframe scans at their optimized poses, and
recomputes the fine raster and its EDT (kernel K1 on CUDA), so a
mis-registration is undone rather than carried: a CUDA graph over static
buffers in the backend's pool (JAX's jitted ``_reraster``), unless
``eager``. The JAX package's docstring records the accuracy envelope of
this design on building-3800.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.core import gridmap, se2
from lidar_slam_tpu_torch.core.gridmap import OccGrid, PointMap
from lidar_slam_tpu_torch.device import resolve_device
from lidar_slam_tpu_torch.models import fastslam
from lidar_slam_tpu_torch.models.graph_slam import (GraphSlam,
                                                    LoopClosureConfig,
                                                    _DeviceKeyframes,
                                                    _rebuilt_map_points)
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.utils import graphs


class _PFFrontend:
    """Gives ``fastslam`` the frontend surface GraphSlam expects.

    ``draws``, if given, is the sequence of per-step ``(noise, u0)`` pairs
    for steps 1..T-1 (as ``fastslam.run_pf`` takes them), so a test can feed
    the port the JAX package's draws."""

    def __init__(self, seed: int = 0, draws=None):
        self._seed = seed
        self._draws = draws
        self._t = 0

    def init_state(self, ranges0: torch.Tensor, cfg: SlamConfig):
        self._t = 0
        return fastslam.init_particles(ranges0, cfg, self._seed)

    def next_draws(self):
        """This step's injected draws (None: the state's generator)."""
        draws = None if self._draws is None else self._draws[self._t]
        self._t += 1
        return draws

    def slam_step(self, state, ranges, cfg, angles):
        return fastslam.pf_step(state, ranges, cfg, angles,
                                draws=self.next_draws())

    def make_step_fn(self, cfg: SlamConfig, device):
        return _PFStep(self, fastslam.make_pf_step(cfg, device))


class _PFStep:
    """``fastslam.PfStepFn`` fed the frontend's draws: ``advance(state,
    ranges) -> state`` (no host read after scan 1), with its ``pose``,
    ``scan`` and ``graphs``."""

    def __init__(self, frontend: _PFFrontend, step: fastslam.PfStepFn):
        self.frontend, self.step = frontend, step

    def advance(self, state, ranges: torch.Tensor):
        return self.step.advance(state, ranges, self.frontend.next_draws())

    @property
    def pose(self) -> torch.Tensor:
        return self.step.pose

    @property
    def scan(self):
        return self.step.scan

    @property
    def graphs(self):
        return self.step.graphs


def _np_correct_cloud(poses: np.ndarray, old_last: np.ndarray,
                      new_last: np.ndarray) -> np.ndarray:
    """Re-anchor (P, 3) reference-convention poses from old_last to new_last:
    pose' = new_last (+) (old_last (-) pose), vectorized host numpy."""
    ct, st = np.cos(old_last[2], dtype=np.float32), np.sin(old_last[2],
                                                           dtype=np.float32)
    dx = poses[:, 0] - old_last[0]
    dy = poses[:, 1] - old_last[1]
    zx = ct * dx - st * dy
    zy = st * dx + ct * dy
    zt = poses[:, 2] - old_last[2]
    ct2, st2 = np.cos(new_last[2], dtype=np.float32), np.sin(
        new_last[2], dtype=np.float32)
    return np.stack([new_last[0] + ct2 * zx + st2 * zy,
                     new_last[1] - st2 * zx + ct2 * zy,
                     new_last[2] + zt], axis=1).astype(np.float32)


def _reraster(pmap: PointMap, kf_x, kf_y, kf_valid, kf_pose,
              cfg: SlamConfig):
    """Fine raster + clamped EDT of the rebuilt map around a keyframe pose
    (the cloud must not score against the stale field after a rewrite)."""
    g = cfg.grid
    wx, wy = se2.transform_ref(kf_x, kf_y, kf_pose)
    local = gridmap.extract_local_map(pmap, wx, wy, kf_valid, g.border_size)
    min_xy, max_xy = gridmap.local_bounds(local)
    fine = gridmap.rasterize(local, g.fine_pixel, g.fine_size, min_xy,
                             max_xy, g.margin_pixels)
    return fine, edt_ops.edt(fine.occ, int(g.max_dist_px))


class _RerasterBufs(NamedTuple):
    """The captured ``_reraster``'s static buffers."""
    store: _DeviceKeyframes
    pmap: PointMap       # the rebuilt map, its keyframe pose the centre
    row: torch.Tensor    # (1,) int64: the keyframe whose scan is the crop
    fine: OccGrid        # the result
    metric: torch.Tensor


class PFGraphSlam(GraphSlam):
    """GraphSlam with the grid particle filter as frontend; weak
    (recovery-tier) closures on by default."""

    def __init__(self, cfg: SlamConfig, lc: LoopClosureConfig | None = None,
                 max_keyframes: int = 512, seed: int = 0,
                 device: str | torch.device = "cuda", draws=None,
                 eager: bool = False):
        if lc is None:
            lc = LoopClosureConfig(weak_closures=True)
        super().__init__(cfg, lc, max_keyframes, device, eager)
        self.frontend = _PFFrontend(seed, draws)
        self._reraster_bufs: _RerasterBufs | None = None

    def _rerastered(self, pmap: PointMap, k: int):
        """``_reraster`` of ``pmap`` around keyframe ``k``'s scan at the
        map's keyframe pose: (fine grid, its EDT), the caller's own
        tensors."""
        if self.eager:
            return _reraster(pmap, self._kf_dx[k], self._kf_dy[k],
                             self._kf_dv[k], pmap.keyframe_pose, self.cfg)
        b = self._reraster_bufs
        if b is None:
            g = self.cfg.grid
            b = self._reraster_bufs = _RerasterBufs(
                store=self._backend.store, pmap=graphs.clone_tree(pmap),
                row=torch.zeros(1, dtype=torch.int64, device=self.device),
                fine=gridmap.empty_grid(g.fine_size, g.fine_pixel,
                                        self.device),
                metric=torch.zeros((g.fine_size, g.fine_size),
                                   device=self.device))
        graphs.copy_into(b.pmap, pmap)
        graphs.upload(b.row, np.asarray([k], np.int64))
        self._backend.graphs.run("reraster", self._reraster_body, b)
        return graphs.clone_tree((b.fine, b.metric))

    def _reraster_body(self, b: _RerasterBufs) -> None:
        s = b.store
        fine, fm = _reraster(b.pmap, s.x.index_select(0, b.row)[0],
                             s.y.index_select(0, b.row)[0],
                             s.valid.index_select(0, b.row)[0],
                             b.pmap.keyframe_pose, self.cfg)
        graphs.copy_into((b.fine, b.metric), (fine, fm))

    def _rebuild_frontend(self, state: fastslam.ParticleState):
        p = state.poses.shape[0]
        fb = torch.cat([state.poses, state.prev_poses,
                        state.pmap.keyframe_pose[None]]).cpu().numpy()
        poses, prev_poses, old_last = fb[:p], fb[p:2 * p], fb[2 * p]
        new_last = np.asarray(self.kf_poses[-1], np.float32)

        k = self._kf_count
        xy, size = _rebuilt_map_points(
            self._kf_x[:k], self._kf_y[:k], self._kf_valid[:k],
            np.stack(self.kf_poses), state.pmap.xy.shape[0])
        dev = self.device
        new_last_t = torch.as_tensor(new_last, device=dev)
        pmap = PointMap(xy=torch.as_tensor(xy, device=dev),
                        size=torch.as_tensor(np.int32(size), device=dev),
                        keyframe_pose=new_last_t)
        fine, fm = self._rerastered(pmap, k - 1)
        return state._replace(
            poses=torch.as_tensor(_np_correct_cloud(poses, old_last,
                                                    new_last), device=dev),
            prev_poses=torch.as_tensor(_np_correct_cloud(
                prev_poses, old_last, new_last), device=dev),
            pmap=pmap, fine=fine, fine_metric=fm, mini_updated=True)


def run_pf_graph(ranges_all: np.ndarray, cfg: SlamConfig,
                 lc: LoopClosureConfig | None = None,
                 max_keyframes: int = 512, seed: int = 0,
                 chunk_size: int | None = None,
                 device: str | torch.device = "cuda", draws=None):
    """PF-frontend graph SLAM over a whole dataset.

    Returns (path (T, 3), optimized keyframe poses, the PFGraphSlam
    instance). The default chunk on CUDA is 128 (the JAX package's TPU
    default: a shorter chunk corrects a mis-registration sooner)."""
    device = resolve_device(device)
    if chunk_size is None and device.type == "cuda":
        chunk_size = 128
    gs = PFGraphSlam(cfg, lc, max_keyframes, seed, device, draws)
    path, opt = gs.run(ranges_all, chunk_size=chunk_size)
    return path, opt, gs
