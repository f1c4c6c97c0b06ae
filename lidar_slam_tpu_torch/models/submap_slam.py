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
device->host sync. ``slam_step`` is ``submap_head`` (up to the tests), that
sync, and ``submap_tail`` when the keyframe test passed; ``make_step_fn``
(JAX's jitted step, driven by ``run_scan`` and ``run_host_loop``) replays
those arms as CUDA graphs over static buffers (``utils/graphs``), with the
atlas's slot ints in a device buffer (``core/submap``). The stale-transform
quirk of the fidelity pipeline is kept: after a refresh the map update
reuses the scan transformed with the pre-match pose.
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
from lidar_slam_tpu_torch.utils import graphs


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


class SubmapHead(NamedTuple):
    """A step up to its tests (``submap_head``)."""
    state: SubmapSlamState    # the next state if the keyframe test fails
    scan: sensor.Scan
    best_count: torch.Tensor  # () i32, the best candidate's in-bounds count
    last_hits: torch.Tensor   # (N,) f32, the last candidate's hits
    tests: torch.Tensor       # (3,) bool: moved, far (from the active
    #                           anchor), full (the active submap)


def submap_head(state: SubmapSlamState, ranges: torch.Tensor, cfg: SlamConfig,
                angles: torch.Tensor, slots: torch.Tensor | None = None
                ) -> SubmapHead:
    """A step up to its tests: the keyframe arm if ``state.mini_updated``,
    the two-stage match, the keyframe test and the spawn tests. No host
    sync. ``slots``: the atlas's slot ints on the device (default
    ``submap.device_slots``)."""
    g, m, mc, sm = cfg.grid, cfg.map, cfg.matcher, cfg.submaps
    atlas = state.atlas
    slots = submap.device_slots(atlas) if slots is None else slots
    scan = sensor.read_scan(ranges, angles, cfg.lidar)

    # --- keyframe-gated refresh of the local map from the atlas
    if state.mini_updated:
        scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, state.pose)
        local = submap.extract_local_from_atlas(
            atlas, state.pose, scan_wx, scan_wy, scan.valid, g.border_size,
            sm.k_nearest, slots)
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

    # --- the keyframe test and the spawn tests
    active = slots[1:2]
    dp = torch.abs(new_pose - state.keyframe_pose)
    moved = ((dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt)
             | (dp[2] > m.mini_update_dr))
    anchor = atlas.anchors.index_select(0, active)[0]
    far = rounded64(torch.hypot, new_pose[0] - anchor[0],
                    new_pose[1] - anchor[1]) > sm.spawn_dist
    full = atlas.sizes.index_select(0, active)[0] >= int(
        sm.spawn_fill_frac * sm.submap_capacity)
    kept = SubmapSlamState(
        pose=new_pose, prev_pose=state.pose, step=state.step + 1,
        mini_updated=False, keyframe_pose=state.keyframe_pose, atlas=atlas,
        coarse=coarse, fine=fine, coarse_metric=coarse_metric,
        fine_metric=fine_metric, scan_wx=scan_wx, scan_wy=scan_wy)
    return SubmapHead(state=kept, scan=scan, best_count=m2.best_count,
                      last_hits=m2.last_hits,
                      tests=torch.stack([moved, far, full]))


def submap_tail(head: SubmapHead, refreshed: bool, write: bool,
                cfg: SlamConfig, slots: torch.Tensor | None = None
                ) -> SubmapSlamState:
    """The step's end when the keyframe test passed: the novel points go
    into the active submap, opened first at that slot when ``write``
    (``submap.spawned`` decides both on the host). ``refreshed``: the step
    ran the keyframe arm. ``slots``: the slot ints after the spawn (default
    ``submap.device_slots`` of ``head.state.atlas``)."""
    st, scan, m = head.state, head.scan, cfg.map
    slots = submap.device_slots(st.atlas) if slots is None else slots
    scan_wx, scan_wy = st.scan_wx, st.scan_wy
    if not refreshed:
        scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, st.pose)
    j = torch.arange(scan_wx.shape[0], device=scan_wx.device)
    select = (j < head.best_count) & (head.last_hits > m.new_point_threshold)
    active = slots[1:2]
    atlas = st.atlas
    if write:
        atlas = submap.open_slot(atlas, st.pose, active)
    atlas = submap.insert_world_points(atlas, scan_wx, scan_wy, select, active)
    return st._replace(mini_updated=True, keyframe_pose=st.pose, atlas=atlas,
                       scan_wx=scan_wx, scan_wy=scan_wy)


def slam_step(state: SubmapSlamState, ranges: torch.Tensor, cfg: SlamConfig,
              angles: torch.Tensor) -> tuple[SubmapSlamState, torch.Tensor]:
    """One scan; returns (new_state, pose): ``submap_head``, the tests on
    the host (the step's one sync), ``submap_tail`` if the keyframe test
    passed."""
    head = submap_head(state, ranges, cfg, angles)
    moved, far, full = head.tests.tolist()
    if not moved:
        return head.state, head.state.pose
    atlas, write = (submap.spawned(state.atlas) if far or full
                    else (state.atlas, False))
    head = head._replace(state=head.state._replace(atlas=atlas))
    new_state = submap_tail(head, state.mini_updated, write, cfg)
    return new_state, new_state.pose


class _Static(NamedTuple):
    """The captured step's static buffers."""
    ranges: torch.Tensor   # (N,) the scan's ranges
    slots: torch.Tensor    # (2,) int64: the atlas's n_submaps and active
    head: SubmapHead       # head.state is the step's state
    out: torch.Tensor      # (6,) f32: the pose and the three tests


class SubmapStepFn:
    """``step(state, ranges) -> (state, pose)``: ``slam_step`` as captured
    CUDA graphs (``utils/graphs``), JAX's jitted step with its state
    donated (``scan_matcher.StepFn`` has the conventions).

    The head is one graph with the keyframe arm and one without; the tail
    one graph for each arm with and without a new submap (captured at first
    use). A step replays a head, reads its pose and tests in one 24-byte
    device->host copy (the step's one host sync) and replays a tail if the
    keyframe test passed. The atlas's ``n_submaps`` and ``active`` stay host
    ints on the state; the bodies read them from a (2,) device buffer, which
    the host rewrites when a spawn or a loaded state changes them, so no
    graph holds a slot. Scan 1 (``state.step == 1``) runs eagerly.
    ``self.pose`` and ``self.scan`` are the step's pose and gated scan on
    the device (``scan`` None after an eager step), valid until the next
    call."""

    def __init__(self, cfg: SlamConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.angles = angles_tensor(cfg, self.device)
        self.graphs = graphs.Graphs(self.device)
        self.bufs: _Static | None = None
        self.state: SubmapSlamState | None = None   # the state last returned
        self.pose: torch.Tensor | None = None
        self.scan: sensor.Scan | None = None

    def __call__(self, state: SubmapSlamState, ranges: torch.Tensor
                 ) -> tuple[SubmapSlamState, np.ndarray]:
        if state.step == 1:
            ranges = ranges.to(self.device, non_blocking=True)
            state, pose = slam_step(state, ranges, self.cfg, self.angles)
            self.pose, self.scan = pose, None
            return state, pose.cpu().numpy()
        if state is not self.state:
            self._load(state)
        b = self.bufs
        b.ranges.copy_(ranges, non_blocking=True)
        refreshed = state.mini_updated
        self.graphs.run(("head", refreshed), self._head_body(refreshed), b)
        host = b.out.to("cpu", copy=True)   # a copy on the CPU too
        moved, far, full = (bool(v) for v in host[3:])
        atlas = state.atlas   # its host ints are the buffer's
        if moved:
            write = False
            if far or full:
                atlas, write = submap.spawned(atlas)
                b.slots.copy_(submap.device_slots(atlas))
            self.graphs.run(("tail", refreshed, write),
                            self._tail_body(refreshed, write), b)
        st = b.head.state
        self.state = st._replace(
            step=state.step + 1, mini_updated=moved,
            atlas=st.atlas._replace(n_submaps=atlas.n_submaps,
                                    active=atlas.active))
        self.pose, self.scan = st.pose, b.head.scan
        return self.state, host[:3].numpy()

    def advance(self, state: SubmapSlamState, ranges: torch.Tensor
                ) -> SubmapSlamState:
        """The step without the pose on the host (``GraphSlam``'s chunk
        loop); it still reads its tests, the spawn decisions being host
        ints."""
        return self(state, ranges)[0]

    def _load(self, state: SubmapSlamState) -> None:
        if self.bufs is None:
            n = self.cfg.lidar.n_beams
            f32 = dict(dtype=torch.float32, device=self.device)
            self.bufs = _Static(
                ranges=torch.zeros(n, **f32),
                slots=submap.device_slots(state.atlas).clone(),
                head=SubmapHead(
                    state=graphs.clone_tree(state),
                    scan=sensor.empty_scan(n, self.device),
                    best_count=torch.zeros((), dtype=torch.int32,
                                           device=self.device),
                    last_hits=torch.zeros(n, **f32),
                    tests=torch.zeros(3, dtype=torch.bool,
                                      device=self.device)),
                out=torch.zeros(6, **f32))
        else:
            graphs.copy_into(self.bufs.head.state, state)
            self.bufs.slots.copy_(submap.device_slots(state.atlas))

    # The bodies take the buffers and keep the state's host fields of the
    # arm they were captured for; the slot ints come from ``slots``.
    def _head_body(self, refreshed: bool):
        def body(b: _Static) -> None:
            st = b.head.state._replace(step=2, mini_updated=refreshed)
            head = submap_head(st, b.ranges, self.cfg, self.angles, b.slots)
            graphs.copy_into(b.head, head)
            b.out.copy_(torch.cat([b.head.state.pose,
                                   b.head.tests.to(torch.float32)]))
        return body

    def _tail_body(self, refreshed: bool, write: bool):
        def body(b: _Static) -> None:
            graphs.copy_into(b.head.state, submap_tail(
                b.head, refreshed, write, self.cfg, b.slots))
        return body


def make_step_fn(cfg: SlamConfig, device: str | torch.device = "cuda"
                 ) -> SubmapStepFn:
    """The captured submap step (``SubmapStepFn``) on ``device``."""
    return SubmapStepFn(cfg, device)


def _as_ranges(ranges_all, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ranges_all, np.float32),
                           device=resolve_device(device))


def run_host_loop(ranges_all: np.ndarray, cfg: SlamConfig,
                  device: str | torch.device = "cuda"
                  ) -> tuple[np.ndarray, SubmapSlamState]:
    """Streaming run through ``make_step_fn``: each pose copied to the host
    as it is produced. Returns (path (T, 3) numpy, final state)."""
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
             ) -> tuple[torch.Tensor, SubmapSlamState]:
    """Whole-log run through ``make_step_fn``: each pose is written into a
    (T, 3) tensor on the device. Returns (that path, final state)."""
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
