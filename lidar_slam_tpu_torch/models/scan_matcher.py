"""The single-hypothesis scan-to-map SLAM pipeline, fidelity mode
(counterpart of ``lidar_slam_tpu.models.scan_matcher``).

Per scan: gate/convert, keyframe-gated local-map raster + EDT (kernel K1 on
CUDA), constant-velocity prediction, two-stage correlative match (coarse or
fine grid, then fine), and the mini-update rule appending novel points.

JAX's ``lax.cond`` branches become host branches in the eager step:
``mini_updated`` is a host bool carried in the state, and ``moved`` costs
one device->host sync per scan. ``step`` is a host int. Everything else
stays on the state's device. ``slam_step`` is ``slam_head`` (up to the
keyframe test), the sync, and ``slam_moved`` when the test passed.
``make_step_fn`` (JAX's jitted step) captures the whole step as one CUDA
graph over static buffers (``utils/graphs``) whose branches are
conditional nodes on device bools, as ``lax.cond`` is in JAX: ``run_scan``
(JAX's ``lax.scan`` driver) runs every scan after the first with no host
sync and reads the device once at the end; ``run_host_loop`` and the
streaming server read each pose and test in one 16-byte copy a scan.

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
from lidar_slam_tpu_torch.utils.profiling import session, span


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
    """The beam angle table on ``device``; on the card copied from pinned
    memory, so a run that makes it mid-way does not wait for the device."""
    host = torch.as_tensor(sensor.beam_angles(cfg.lidar))
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


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


def _keyframe_maps(state: SlamState, scan: sensor.Scan, cfg: SlamConfig):
    """The keyframe arm (main.c:865-872): the local map around the scan at
    the pre-match pose, rastered at both resolutions, and their fields (K1
    on CUDA). Returns the state's six map leaves, refreshed."""
    g = cfg.grid
    scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, state.pose)
    local = gridmap.extract_local_map(state.pmap, scan_wx, scan_wy,
                                      scan.valid, g.border_size)
    coarse, fine = gridmap.rasterize_dual(local, g)
    coarse_metric = edt_ops.edt(coarse.occ, int(g.max_dist_px))
    fine_metric = edt_ops.edt(fine.occ, int(g.max_dist_px))
    return coarse, fine, coarse_metric, fine_metric, scan_wx, scan_wy


def map_leaves(state: SlamState):
    """The state's six map leaves, as ``_keyframe_maps`` returns them (a
    submap state's too)."""
    return (state.coarse, state.fine, state.coarse_metric,
            state.fine_metric, state.scan_wx, state.scan_wy)


def _first_match(metric: torch.Tensor, grid: OccGrid, scan: sensor.Scan,
                 guess: torch.Tensor, cfg: SlamConfig) -> matching.MatchResult:
    """The first matcher stage (main.c:901-910), on the coarse grid on a
    keyframe step and on the fine grid otherwise."""
    mc = cfg.matcher
    return matching.fast_match(metric, grid, scan.x, scan.y, scan.valid,
                               guess, mc.coarse_t, mc.coarse_r,
                               int(mc.window_t), int(mc.window_r),
                               float(mc.window_penalty_px))


def _head_end(state: SlamState, scan: sensor.Scan, maps,
              m1_pose: torch.Tensor, cfg: SlamConfig) -> StepHead:
    """The second matcher stage on the fine grid from the first stage's
    pose (main.c:911-918) and the mini-update rule's test (main.c:928-931).
    """
    m, mc = cfg.map, cfg.matcher
    coarse, fine, coarse_metric, fine_metric, scan_wx, scan_wy = maps
    m2 = matching.fast_match(fine_metric, fine, scan.x, scan.y, scan.valid,
                             m1_pose, mc.fine_t, mc.fine_r, int(mc.window_t),
                             int(mc.window_r), float(mc.window_penalty_px))
    new_pose = m2.pose
    test = keyframe_test(new_pose, state.pmap.keyframe_pose, m)
    kept = SlamState(
        pose=new_pose, prev_pose=state.pose, step=state.step + 1,
        mini_updated=False, pmap=state.pmap, coarse=coarse, fine=fine,
        coarse_metric=coarse_metric, fine_metric=fine_metric,
        scan_wx=scan_wx, scan_wy=scan_wy)
    return StepHead(state=kept, scan=scan, best_count=m2.best_count,
                    last_hits=m2.last_hits, test=test)


def slam_head(state: SlamState, ranges: torch.Tensor, cfg: SlamConfig,
              angles: torch.Tensor) -> StepHead:
    """A step up to its keyframe test: the keyframe arm if ``state.
    mini_updated``, the two-stage match and the test. No host sync."""
    scan = sensor.read_scan(ranges, angles, cfg.lidar)
    maps = (_keyframe_maps(state, scan, cfg) if state.mini_updated
            else map_leaves(state))
    # constant-velocity prediction (main.c:875-898)
    guess = (state.pose + (state.pose - state.prev_pose) if state.step > 1
             else state.pose)
    coarse, fine, coarse_metric, fine_metric = maps[:4]
    m1 = (_first_match(coarse_metric, coarse, scan, guess, cfg)
          if state.mini_updated
          else _first_match(fine_metric, fine, scan, guess, cfg))
    return _head_end(state, scan, maps, m1.pose, cfg)


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
        both = pose_and_test(new_pose, head.test)
        with span("sync", tag="step", req=state.step):
            host = both.cpu()
        moved, out_pose = bool(host[3]), host[:3].numpy()
    else:
        with span("sync", tag="step", req=state.step):
            moved = bool(head.test.item())
        out_pose = new_pose
    new_state = (slam_moved(head, state.mini_updated, cfg) if moved
                 else head.state)
    return new_state, out_pose


def keyframe_test(pose: torch.Tensor, keyframe_pose: torch.Tensor,
                  map_cfg) -> torch.Tensor:
    """() bool, the mini-update rule's test (main.c:928-931): ``pose`` is
    further than ``map_cfg``'s ``mini_update_dt`` from ``keyframe_pose`` in
    x or in y, or further than ``mini_update_dr`` in heading."""
    dp = torch.abs(pose - keyframe_pose)
    dt, dr = map_cfg.mini_update_dt, map_cfg.mini_update_dr
    return (dp[0] > dt) | (dp[1] > dt) | (dp[2] > dr)


def pose_and_test(pose: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """(4,) f32: the pose and the keyframe test, for one device->host copy."""
    return torch.cat([pose, test.to(pose.dtype)[None]])


def as_ranges(ranges_all, device) -> torch.Tensor:
    """A log of ranges (T, N) as an f32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(ranges_all, np.float32),
                           device=resolve_device(device))


class _Static(NamedTuple):
    """The captured step's static buffers."""
    ranges: torch.Tensor   # (N,) the scan's ranges
    mini: torch.Tensor     # () bool, the state's mini_updated (JAX's carry)
    m1: torch.Tensor       # (3,) the first matcher stage's pose
    head: StepHead         # head.state is the step's state
    out: torch.Tensor      # (4,) pose_and_test


class StepFn(graphs.CapturedStep):
    """``step(state, ranges) -> (state, pose)``: ``slam_step`` as one
    captured CUDA graph (``graphs.CapturedStep`` has the conventions).

    The graph is the whole step, JAX's ``slam_step`` arm by arm: an IF node
    on the device bool ``mini_updated`` holds the keyframe arm (extract,
    raster, K1 on both grids); IF(``mini_updated``) and IF(``~mini_updated``)
    hold the first match on the coarse or the fine field; the second match
    and the test follow; IF(``test & mini_updated``) and IF(``test &
    ~mini_updated``) hold ``slam_moved`` with and without the refresh; and
    ``mini_updated := test`` on the device. ``advance`` returns the device
    bool as the state's ``mini_updated``; ``step`` reads the pose and the
    test in one 16-byte copy."""

    def __init__(self, cfg: SlamConfig, device: str | torch.device = "cuda"):
        super().__init__(device)
        self.cfg = cfg
        self.angles = angles_tensor(cfg, self.device)

    def _eager(self, state: SlamState, ranges: torch.Tensor):
        ranges = ranges.to(self.device, non_blocking=True)
        state, pose = slam_step(state, ranges, self.cfg, self.angles,
                                pose_to_host=True)
        self.pose = state.pose
        return state, pose

    def _alloc(self, state: SlamState, ranges) -> _Static:
        n = self.cfg.lidar.n_beams
        f32 = dict(dtype=torch.float32, device=self.device)
        flag = dict(dtype=torch.bool, device=self.device)
        return _Static(
            ranges=torch.zeros(n, **f32), mini=torch.zeros((), **flag),
            m1=torch.zeros(3, **f32),
            head=StepHead(state=state, scan=sensor.empty_scan(n, self.device),
                          best_count=torch.zeros((), dtype=torch.int32,
                                                 device=self.device),
                          last_hits=torch.zeros(n, **f32),
                          test=torch.zeros((), **flag)),
            out=torch.zeros(4, **f32))

    def _load_fields(self, state: SlamState) -> None:
        graphs.load_value(self.bufs.mini, state.mini_updated)

    def _stage(self, state: SlamState, ranges: torch.Tensor) -> None:
        self.bufs.ranges.copy_(ranges, non_blocking=True)

    def _returned(self, state: SlamState):
        b = self.bufs
        return (b.head.state._replace(step=state.step + 1,
                                      mini_updated=b.mini),
                b.head.state.pose, b.head.scan)

    def _body(self, b: _Static) -> None:
        """The step on the buffers; the state's host fields are those of a
        step after the first (its guess uses the velocity)."""
        cfg = self.cfg
        st = b.head.state._replace(step=2)
        scan = sensor.read_scan(b.ranges, self.angles, cfg.lidar)
        maps = map_leaves(st)
        graphs.cond(b.mini, lambda: graphs.copy_into(
            maps, _keyframe_maps(st, scan, cfg)))
        guess = st.pose + (st.pose - st.prev_pose)
        coarse, fine, coarse_metric, fine_metric = maps[:4]
        graphs.cond(
            b.mini,
            lambda: b.m1.copy_(_first_match(coarse_metric, coarse, scan,
                                            guess, cfg).pose),
            lambda: b.m1.copy_(_first_match(fine_metric, fine, scan, guess,
                                            cfg).pose))
        graphs.copy_into(b.head, _head_end(st, scan, maps, b.m1, cfg))
        for refreshed in (True, False):
            mini = b.mini if refreshed else torch.logical_not(b.mini)
            graphs.cond(b.head.test & mini,
                        lambda r=refreshed: graphs.copy_into(
                            b.head.state, slam_moved(b.head, r, cfg)))
        b.mini.copy_(b.head.test)
        b.out.copy_(pose_and_test(b.head.state.pose, b.head.test))


def make_step_fn(cfg: SlamConfig, device: str | torch.device = "cuda"
                 ) -> StepFn:
    """The captured fidelity step (``StepFn``) on ``device``."""
    return StepFn(cfg, device)


def over_scans(ranges_all: np.ndarray, cfg: SlamConfig, device,
               make_step=make_step_fn, init=init_state):
    """``graphs.drive``'s arguments for a log of ranges (T, N): a new
    step of ``make_step``, the state ``init`` makes from scan 0, T, and
    scan t's ranges on the device."""
    ranges = as_ranges(ranges_all, device)
    return (make_step(cfg, ranges.device), init(ranges[0], cfg),
            ranges.shape[0], lambda t: (ranges[t],))


def run_host_loop(ranges_all: np.ndarray, cfg: SlamConfig,
                  device: str | torch.device = "cuda"
                  ) -> tuple[np.ndarray, SlamState]:
    """Streaming driver: one scan at a time through ``make_step_fn``, each
    pose copied to the host as it is produced (JAX's ``run_host_loop``).
    Returns (path (T, 3) numpy, final state)."""
    return graphs.host_loop(*over_scans(ranges_all, cfg, device))


def run_scan(ranges_all: np.ndarray, cfg: SlamConfig,
             device: str | torch.device = "cuda"
             ) -> tuple[torch.Tensor, SlamState]:
    """Whole-dataset driver through ``make_step_fn`` (JAX's ``lax.scan``
    over the tour; ``graphs.drive``): scans 2.. with no host sync, the
    poses in a (T, 3) tensor on the device, the final state's host fields
    read back in one read at the end. Returns (that path, final state).
    The call is one ``session`` span."""
    with session("run_scan", device):
        return graphs.drive(*over_scans(ranges_all, cfg, device))
