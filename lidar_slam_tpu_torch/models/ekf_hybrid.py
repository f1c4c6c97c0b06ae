"""Hybrid grid + landmark EKF-FastSLAM (counterpart of
``lidar_slam_tpu.models.ekf_hybrid``).

The landmark filter (``models/ekf_slam``) weights particles on corner
landmarks only and drifts through stretches without corners; this model
adds the grid likelihood of the particle filter to every weight:

    log w_p += sum_det loglik_landmark(p, det)  -  avg_edt_dist(p) / temp

Per scan: one correlation volume around the odometry-predicted mean pose
(kernel K2 on CUDA, B=1 T=7 half=6 on the 400^2 fine field with the
default config), the ML-association EKF step with the volume's lookups as
its extra log-likelihood (kernel K4 on CUDA), the weighted mean refined by
three argmin passes over 27 candidates (one K4 launch), and on keyframe
steps (the reference's mini-update rule) novel points appended to the
shared map and the fine raster and its EDT rebuilt (kernel K1 at
(1, 400, 400)). Detections and scan odometry
come from batched pre-passes over the whole log (``ops/landmarks``;
``ops/scan_odometry.pairwise_odometry``, K1 at (50, 448, 448)).

In the eager ``hybrid_step`` JAX's ``lax.cond`` on the keyframe test
becomes one host branch a scan (the step's one device->host sync); ``step``
and ``mini_updated`` are host values. ``hybrid_step`` is ``hybrid_head``
(up to the test), that sync, and the particle filter's ``pf_refresh`` of
the shared map when the test passed.
``HybridStepFn`` (JAX's jitted ``_run_hybrid_jit``, driven by
``run_ekf_hybrid``) captures both as one CUDA graph for every detection
count over static buffers (``utils/graphs``): the association loop is a
WHILE node over the valid rows, found on the card
(``ekf_slam.DEVICE_LOOP``), and the refresh an IF node on the device test
beside it, so the run reads nothing on the host after its pre-pass
(``hybrid_inputs``) until its end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, SlamConfig
from lidar_slam_tpu_torch.core import gridmap, se2, sensor
from lidar_slam_tpu_torch.core.gridmap import OccGrid, PointMap
from lidar_slam_tpu_torch.device import resolve_device
from lidar_slam_tpu_torch.models import ekf_slam
from lidar_slam_tpu_torch.models.ekf_slam import (EkfSlamConfig, EkfSlamState,
                                                  ekf_slam_step_ml,
                                                  init_ekf_slam)
from lidar_slam_tpu_torch.models.fastslam import (PfHead, pf_refresh,
                                                  refined_estimate,
                                                  stage_draws)
from lidar_slam_tpu_torch.models.scan_matcher import (angles_tensor,
                                                      keyframe_test,
                                                      pose_and_test)
from lidar_slam_tpu_torch.ops import correlative
from lidar_slam_tpu_torch.ops import landmarks as lm_ops
from lidar_slam_tpu_torch.ops.scan_odometry import pairwise_odometry
from lidar_slam_tpu_torch.utils import graphs


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


def hybrid_head(state: HybridState, ranges: torch.Tensor, obs: torch.Tensor,
                obs_valid: torch.Tensor, odo: torch.Tensor,
                ekf_cfg: EkfSlamConfig, cfg: SlamConfig,
                angles: torch.Tensor, draws=None, n_det=None) -> PfHead:
    """A step up to its keyframe test: the volume, the ML step with the grid
    term, the estimate and the test. No host sync. Arguments as
    ``hybrid_step``."""
    pc, mc = cfg.particles, cfg.matcher
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
    est_pose = refined_estimate(
        vols, ekf_slam._weighted_mean(ekf2.logw, ekf2.poses), mc)
    test = keyframe_test(est_pose, state.pmap.keyframe_pose, cfg.map)
    kept = state._replace(ekf=ekf2, step=state.step + 1, mini_updated=False)
    return PfHead(state=kept, scan=scan, est_pose=est_pose, test=test)


def hybrid_step(state: HybridState, ranges: torch.Tensor, obs: torch.Tensor,
                obs_valid: torch.Tensor, odo: torch.Tensor,
                ekf_cfg: EkfSlamConfig, cfg: SlamConfig,
                angles: torch.Tensor, draws=None, n_det: int | None = None
                ) -> tuple[HybridState, torch.Tensor]:
    """One hybrid step: obs (M, 2) corner detections of this scan (the
    first ``n_det`` valid), odo (3,) its scan-odometry delta. Returns
    (state, estimated pose): ``hybrid_head``, the keyframe test on the host
    (the step's one sync; none on the first step, which always refreshes),
    the shared map's refresh (``fastslam.pf_refresh``) if it passed."""
    head = hybrid_head(state, ranges, obs, obs_valid, odo, ekf_cfg, cfg,
                       angles, draws, n_det)
    first = state.step == 1
    if first or bool(head.test.item()):
        return pf_refresh(head, first, cfg), head.est_pose
    return head.state, head.est_pose


class _Static(NamedTuple):
    """The captured hybrid step's static buffers."""
    ranges: torch.Tensor   # (N,)
    obs: torch.Tensor      # (M, 2)
    valid: torch.Tensor    # (M,)
    odo: torch.Tensor      # (3,)
    noise: torch.Tensor    # (P, 3) the step's proposal noise
    u0: torch.Tensor       # () the step's resampling offset
    head: PfHead           # head.state is the step's state
    out: torch.Tensor      # (4,) the estimate and the test


class HybridStepFn(graphs.CapturedStep):
    """``step(state, ranges, obs, valid, odo, n_det=None, draws=None) ->
    (state, pose)``: ``hybrid_step`` as one captured CUDA graph for every
    detection count (``graphs.CapturedStep`` has the conventions): the
    head, whose association loop is a WHILE node over the valid rows of
    ``valid`` (``ekf_slam.DEVICE_LOOP``), and an IF node on the device test
    holding the refresh. A step draws with ``draw`` from the filter's
    generator (or uploads ``draws``) into static buffers and replays the
    graph; ``advance`` returns the device test as the state's
    ``mini_updated``, read back by ``finish`` with the conditional bodies'
    launch counts. Scan 1 (``state.step == 1``, the seed arm) runs eagerly:
    the only step that takes ``n_det``, its detection count (None: its
    valid rows are found on the host)."""

    key = None

    def __init__(self, ekf_cfg: EkfSlamConfig, cfg: SlamConfig,
                 device: str | torch.device = "cuda"):
        super().__init__(device)
        self.ekf_cfg, self.cfg = ekf_cfg, cfg
        self.angles = angles_tensor(cfg, self.device)

    def _eager(self, state: HybridState, ranges, obs, valid, odo,
               n_det=None, draws=None):
        state, self.pose = hybrid_step(state, ranges, obs, valid, odo,
                                       self.ekf_cfg, self.cfg, self.angles,
                                       draws, n_det)
        return state, self.pose

    def _alloc(self, state: HybridState, ranges, obs, *rest, **kw
               ) -> _Static:
        n, p = self.cfg.lidar.n_beams, self.ekf_cfg.n_particles
        f32 = dict(dtype=torch.float32, device=self.device)
        return _Static(
            ranges=torch.zeros(n, **f32), obs=torch.zeros(obs.shape, **f32),
            valid=torch.zeros(obs.shape[:1], dtype=torch.bool,
                              device=self.device),
            odo=torch.zeros(3, **f32), noise=torch.zeros((p, 3), **f32),
            u0=torch.zeros((), **f32),
            head=PfHead(state=state, scan=sensor.empty_scan(n, self.device),
                        est_pose=torch.zeros(3, **f32),
                        test=torch.zeros((), dtype=torch.bool,
                                         device=self.device)),
            out=torch.zeros(4, **f32))

    def _stage(self, state: HybridState, ranges, obs, valid, odo,
               n_det=None, draws=None) -> None:
        b = self.bufs
        for buf, x in ((b.ranges, ranges), (b.obs, obs), (b.valid, valid),
                       (b.odo, odo)):
            buf.copy_(x, non_blocking=True)
        stage_draws(b, state.ekf, draws)

    def _returned(self, state: HybridState):
        b = self.bufs
        st = b.head.state
        return (st._replace(ekf=st.ekf._replace(rng=state.ekf.rng),
                            step=state.step + 1, mini_updated=b.head.test),
                b.head.est_pose, b.head.scan)

    def _body(self, b: _Static) -> None:
        head = hybrid_head(b.head.state, b.ranges, b.obs, b.valid, b.odo,
                           self.ekf_cfg, self.cfg, self.angles,
                           draws=(b.noise, b.u0), n_det=ekf_slam.DEVICE_LOOP)
        graphs.copy_into(b.head, head)
        graphs.cond(b.head.test, lambda: graphs.copy_into(
            b.head.state, pf_refresh(b.head, False, self.cfg)))
        b.out.copy_(pose_and_test(b.head.est_pose, b.head.test))


class HybridInputs(NamedTuple):
    """``run_ekf_hybrid``'s pre-pass over a log of T scans."""
    ranges: torch.Tensor    # (T, N) on the device
    det: lm_ops.LandmarkDetections  # corner detections, rows (T, M)
    odo: torch.Tensor       # (T-1, 3) scan odometry, scan t-1 -> t
    seed_count: int         # scan 1's detections (the eager seed step's)


def hybrid_inputs(ranges_all: np.ndarray, cfg: SlamConfig | None = None,
                  max_range: float = 12.0,
                  device: str | torch.device = "cuda",
                  **extract_kw) -> HybridInputs:
    """The hybrid's pre-pass: corner detections of every scan
    (``ops/landmarks.extract_corners``, one batch) and the scan-odometry
    prior (``ops/scan_odometry.pairwise_odometry``). Its one host read is
    scan 1's detection count, which the eager seed step loops over."""
    cfg = cfg or DEFAULT_CONFIG
    dev = resolve_device(device)
    ranges = torch.as_tensor(np.asarray(ranges_all, np.float32), device=dev)
    angles = angles_tensor(cfg, dev)
    det = lm_ops.extract_corners(
        ranges, angles, range_min=cfg.lidar.range_min,
        usable_range=cfg.lidar.usable_range, max_range=max_range,
        **extract_kw)
    seed_count = int(det.count[1]) if ranges.shape[0] > 1 else 0
    return HybridInputs(ranges, det, pairwise_odometry(ranges, angles,
                                                       cfg.lidar), seed_count)


def run_hybrid_inputs(inputs: HybridInputs, ekf_cfg: EkfSlamConfig,
                      cfg: SlamConfig | None = None, seed: int = 0,
                      draws=None) -> tuple[torch.Tensor, HybridState]:
    """The hybrid filter over a pre-pass's ``inputs`` through
    ``HybridStepFn``: scan 1 eager, then no host read until the final
    state's one read. ``draws``: per-step (noise, u0) for steps 1..T-1.
    Returns (path (T, 3) on the inputs' device, final state)."""
    cfg = cfg or DEFAULT_CONFIG
    ranges, det, odo_all = inputs.ranges, inputs.det, inputs.odo
    state = init_hybrid(ranges[0], ekf_cfg, cfg, seed)
    return graphs.drive(
        HybridStepFn(ekf_cfg, cfg, ranges.device), state, ranges.shape[0],
        lambda t: (ranges[t], det.rb[t], det.valid[t], odo_all[t - 1],
                   inputs.seed_count, None if draws is None else draws[t - 1]))


def run_ekf_hybrid(ranges_all: np.ndarray, ekf_cfg: EkfSlamConfig,
                   cfg: SlamConfig | None = None, seed: int = 0,
                   max_range: float = 12.0,
                   device: str | torch.device = "cuda", draws=None,
                   **extract_kw) -> tuple[torch.Tensor, HybridState]:
    """Whole-log hybrid run: raw (T, N) ranges -> the pre-pass
    (``hybrid_inputs``) -> the filter (``run_hybrid_inputs``). ``draws``:
    per-step (noise, u0) for steps 1..T-1. Returns (path (T, 3) on
    ``device``, final state)."""
    return run_hybrid_inputs(
        hybrid_inputs(ranges_all, cfg, max_range, device, **extract_kw),
        ekf_cfg, cfg, seed, draws)
