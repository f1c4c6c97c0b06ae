"""The single-hypothesis scan-to-map SLAM pipeline, fidelity mode
(counterpart of ``lidar_slam_tpu.models.scan_matcher``).

Per scan: gate/convert, keyframe-gated local-map raster + EDT (kernel K1 on
CUDA), constant-velocity prediction, two-stage correlative match (coarse or
fine grid, then fine), and the mini-update rule appending novel points.

JAX's ``lax.cond`` branches become host branches: ``mini_updated`` is a host
bool carried in the state, and ``moved`` costs one device->host sync per
scan. ``step`` is a host int. Everything else stays on the state's device.
``slam_step`` is ``slam_head`` (up to the keyframe test), the sync, and
``slam_moved`` when the test passed; ``make_step_fn`` (JAX's jitted step,
driven by ``run_scan`` and ``run_host_loop``) replays those arms as CUDA
graphs over static buffers (``utils/graphs``).

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
from lidar_slam_tpu_torch.utils import graphs


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


class StepHead(NamedTuple):
    """A step up to its keyframe test (``slam_head``)."""
    state: SlamState          # the next state if the test fails
    scan: sensor.Scan
    best_count: torch.Tensor  # () i32, the best candidate's in-bounds count
    last_hits: torch.Tensor   # (N,) f32, the last candidate's hits
    test: torch.Tensor        # () bool, the mini-update rule's test


def slam_head(state: SlamState, ranges: torch.Tensor, cfg: SlamConfig,
              angles: torch.Tensor) -> StepHead:
    """A step up to its keyframe test: the keyframe arm if ``state.
    mini_updated``, the two-stage match and the test. No host sync."""
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

    # --- the mini-update rule's test (main.c:928-931)
    dp = torch.abs(new_pose - state.pmap.keyframe_pose)
    test = ((dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt)
            | (dp[2] > m.mini_update_dr))
    kept = SlamState(
        pose=new_pose, prev_pose=state.pose, step=state.step + 1,
        mini_updated=False, pmap=state.pmap, coarse=coarse, fine=fine,
        coarse_metric=coarse_metric, fine_metric=fine_metric,
        scan_wx=scan_wx, scan_wy=scan_wy)
    return StepHead(state=kept, scan=scan, best_count=m2.best_count,
                    last_hits=m2.last_hits, test=test)


def slam_moved(head: StepHead, refreshed: bool, cfg: SlamConfig
               ) -> SlamState:
    """The step's end when the keyframe test passed (main.c:932-961):
    append the novel points. ``refreshed``: the step began with
    ``mini_updated`` and ran the keyframe arm."""
    st, scan, m = head.state, head.scan, cfg.map
    scan_wx, scan_wy = st.scan_wx, st.scan_wy
    if not refreshed:
        # Without a refresh this step the C code re-transforms the scan with
        # the new pose (main.c:935-937); after one, the cached pre-match
        # transform is (mis)used as it is.
        scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, st.pose)
    j = torch.arange(scan_wx.shape[0], device=scan_wx.device)
    select = (j < head.best_count) & (head.last_hits > m.new_point_threshold)
    pmap = gridmap.append_points(st.pmap, scan_wx, scan_wy, select, st.pose)
    return st._replace(mini_updated=True, pmap=pmap, scan_wx=scan_wx,
                       scan_wy=scan_wy)


def slam_step(state: SlamState, ranges: torch.Tensor, cfg: SlamConfig,
              angles: torch.Tensor, pose_to_host: bool = False
              ) -> tuple[SlamState, torch.Tensor | np.ndarray]:
    """Process one scan; returns (new_state, pose): ``slam_head``, the
    keyframe test on the host (the step's one sync), ``slam_moved`` if it
    passed. With ``pose_to_host`` the pose comes back as a numpy array in
    the same device->host copy as the test, so a host loop that needs every
    pose pays one sync a scan, not two."""
    head = slam_head(state, ranges, cfg, angles)
    new_pose = head.state.pose
    if pose_to_host:
        host = pose_and_test(new_pose, head.test).cpu()
        moved, out_pose = bool(host[3]), host[:3].numpy()
    else:
        moved, out_pose = bool(head.test.item()), new_pose
    new_state = (slam_moved(head, state.mini_updated, cfg) if moved
                 else head.state)
    return new_state, out_pose


def pose_and_test(pose: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """(4,) f32: the pose and the keyframe test, for one device->host copy."""
    return torch.cat([pose, test.to(pose.dtype)[None]])


def _as_ranges(ranges_all, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ranges_all, np.float32),
                           device=resolve_device(device))


class _Static(NamedTuple):
    """The captured step's static buffers."""
    ranges: torch.Tensor   # (N,) the scan's ranges
    head: StepHead         # head.state is the step's state
    out: torch.Tensor      # (4,) pose_and_test


class StepFn:
    """``step(state, ranges) -> (state, pose)``: ``slam_step`` as captured
    CUDA graphs (``utils/graphs``), JAX's jitted step with its state donated.

    The arms are graphs: the head with the keyframe arm, the head without
    it, and ``slam_moved`` after each (captured at first use). A step
    replays a head, reads its pose and test in one 16-byte device->host
    copy (the step's one host sync) and replays a ``slam_moved`` if the test
    passed. Scan 1 (``state.step == 1``, whose guess differs) runs eagerly.

    The returned state's tensors are the step's static buffers: they hold
    that state until the next call, which takes it back (JAX's
    ``donate_argnums``); ``graphs.clone_tree`` keeps a copy. A state the
    step did not return is copied into the buffers first. The pose comes
    back on the host (numpy); ``self.pose`` is the same pose on the state's
    device and ``self.scan`` the step's gated scan (None after the eager
    scan 1), valid until the next call. On the CPU the same bodies run
    uncaptured on the same buffers."""

    def __init__(self, cfg: SlamConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.angles = angles_tensor(cfg, self.device)
        self.graphs = graphs.Graphs(self.device)
        self.bufs: _Static | None = None
        self.state: SlamState | None = None   # the state last returned
        self.pose: torch.Tensor | None = None
        self.scan: sensor.Scan | None = None

    def __call__(self, state: SlamState, ranges: torch.Tensor
                 ) -> tuple[SlamState, np.ndarray]:
        if state.step == 1:
            ranges = ranges.to(self.device, non_blocking=True)
            state, pose = slam_step(state, ranges, self.cfg, self.angles,
                                    pose_to_host=True)
            self.pose, self.scan = state.pose, None
            return state, pose
        if state is not self.state:
            self._load(state)
        b = self.bufs
        b.ranges.copy_(ranges, non_blocking=True)
        refreshed = state.mini_updated
        self.graphs.run(("head", refreshed), self._head_body(refreshed), b)
        host = b.out.to("cpu", copy=True)   # a copy on the CPU too
        moved = bool(host[3])
        if moved:
            self.graphs.run(("moved", refreshed),
                            self._moved_body(refreshed), b)
        self.state = b.head.state._replace(step=state.step + 1,
                                           mini_updated=moved)
        self.pose, self.scan = b.head.state.pose, b.head.scan
        return self.state, host[:3].numpy()

    def _load(self, state: SlamState) -> None:
        if self.bufs is None:
            n = self.cfg.lidar.n_beams
            f32 = dict(dtype=torch.float32, device=self.device)
            self.bufs = _Static(
                ranges=torch.zeros(n, **f32),
                head=StepHead(
                    state=graphs.clone_tree(state),
                    scan=sensor.empty_scan(n, self.device),
                    best_count=torch.zeros((), dtype=torch.int32,
                                           device=self.device),
                    last_hits=torch.zeros(n, **f32),
                    test=torch.zeros((), dtype=torch.bool,
                                     device=self.device)),
                out=torch.zeros(4, **f32))
        else:
            graphs.copy_into(self.bufs.head.state, state)

    # The bodies take the buffers and keep the state's host fields of the
    # step they were captured for (step > 1 and the arm's mini_updated).
    def _head_body(self, refreshed: bool):
        def body(b: _Static) -> None:
            st = b.head.state._replace(step=2, mini_updated=refreshed)
            head = slam_head(st, b.ranges, self.cfg, self.angles)
            graphs.copy_into(b.head, head)
            b.out.copy_(pose_and_test(b.head.state.pose, b.head.test))
        return body

    def _moved_body(self, refreshed: bool):
        def body(b: _Static) -> None:
            graphs.copy_into(b.head.state,
                             slam_moved(b.head, refreshed, self.cfg))
        return body


def make_step_fn(cfg: SlamConfig, device: str | torch.device = "cuda"
                 ) -> StepFn:
    """The captured fidelity step (``StepFn``) on ``device``."""
    return StepFn(cfg, device)


def run_host_loop(ranges_all: np.ndarray, cfg: SlamConfig,
                  device: str | torch.device = "cuda"
                  ) -> tuple[np.ndarray, SlamState]:
    """Streaming driver: one scan at a time through ``make_step_fn``, each
    pose copied to the host as it is produced. Returns (path (T, 3) numpy,
    final state)."""
    ranges = _as_ranges(ranges_all, device)
    step = make_step_fn(cfg, ranges.device)
    state = init_state(ranges[0], cfg)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, ranges.shape[0]):
        state, pose = step(state, ranges[t])
        poses.append(pose)
    return np.stack(poses), graphs.clone_tree(state)


def run_scan(ranges_all: np.ndarray, cfg: SlamConfig,
             device: str | torch.device = "cuda"
             ) -> tuple[torch.Tensor, SlamState]:
    """Whole-dataset driver through ``make_step_fn``: each pose is written
    into a (T, 3) tensor on the device. Returns (that path, final state)."""
    ranges = _as_ranges(ranges_all, device)
    step = make_step_fn(cfg, ranges.device)
    state = init_state(ranges[0], cfg)
    path = torch.zeros((ranges.shape[0], 3), dtype=torch.float32,
                       device=ranges.device)
    path[0] = state.pose
    for t in range(1, ranges.shape[0]):
        state, _ = step(state, ranges[t])
        path[t] = step.pose
    return path, graphs.clone_tree(state)
