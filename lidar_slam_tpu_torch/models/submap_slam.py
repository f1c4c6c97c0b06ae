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

In the eager ``slam_step`` JAX's four ``lax.cond``s are host branches:
``mini_updated`` and ``step`` are host values, and the keyframe test and
the two spawn tests (far from the anchor, submap full) reach the host in
one copy, the step's one device->host sync; the spawn is ``submap.spawned``
on the atlas's host ints. ``make_step_fn`` (JAX's jitted step, driven by
``run_scan``, ``run_host_loop``, the paged loop and the submap-graph
frontend) captures the whole step as one CUDA graph whose branches are
conditional nodes on device bools and whose slot ints live in a device
buffer, as JAX's are: ``run_scan`` reads nothing on the host after scan 1.
The stale-transform quirk of the fidelity pipeline is kept: after a
refresh the map update reuses the scan transformed with the pre-match
pose.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.core import gridmap, se2, sensor, submap
from lidar_slam_tpu_torch.core.gridmap import OccGrid
from lidar_slam_tpu_torch.core.submap import SubmapAtlas
from lidar_slam_tpu_torch.device import rounded64
from lidar_slam_tpu_torch.models import scan_matcher
from lidar_slam_tpu_torch.models.scan_matcher import (angles_tensor,
                                                      keyframe_test,
                                                      map_leaves)
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


def _keyframe_maps(state: SubmapSlamState, scan: sensor.Scan,
                   cfg: SlamConfig, slots: torch.Tensor):
    """The keyframe arm: the local map gathered from the atlas around the
    scan at the pre-match pose, rastered at both resolutions, and their
    fields (K1 on CUDA). Returns the state's six map leaves, refreshed."""
    g = cfg.grid
    scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, state.pose)
    local = submap.extract_local_from_atlas(
        state.atlas, state.pose, scan_wx, scan_wy, scan.valid,
        g.border_size, cfg.submaps.k_nearest, slots)
    coarse, fine = gridmap.rasterize_dual(local, g)
    coarse_metric = edt_ops.edt(coarse.occ, int(g.max_dist_px))
    fine_metric = edt_ops.edt(fine.occ, int(g.max_dist_px))
    return coarse, fine, coarse_metric, fine_metric, scan_wx, scan_wy


def _first_match(metric: torch.Tensor, grid: OccGrid, scan: sensor.Scan,
                 guess: torch.Tensor, cfg: SlamConfig) -> matching.MatchResult:
    """The first matcher stage, on the coarse grid on a keyframe step and
    on the fine grid otherwise."""
    mc = cfg.matcher
    return matching.fast_match(metric, grid, scan.x, scan.y, scan.valid,
                               guess, mc.coarse_t, mc.coarse_r)


def _head_end(state: SubmapSlamState, scan: sensor.Scan, maps,
              m1_pose: torch.Tensor, cfg: SlamConfig, slots: torch.Tensor
              ) -> SubmapHead:
    """The second matcher stage from the first stage's pose, the keyframe
    test and the spawn tests."""
    m, mc, sm = cfg.map, cfg.matcher, cfg.submaps
    coarse, fine, coarse_metric, fine_metric, scan_wx, scan_wy = maps
    m2 = matching.fast_match(fine_metric, fine, scan.x, scan.y, scan.valid,
                             m1_pose, mc.fine_t, mc.fine_r)
    new_pose = m2.pose
    atlas = state.atlas
    active = slots[1:2]
    moved = keyframe_test(new_pose, state.keyframe_pose, m)
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


def submap_head(state: SubmapSlamState, ranges: torch.Tensor, cfg: SlamConfig,
                angles: torch.Tensor, slots: torch.Tensor | None = None
                ) -> SubmapHead:
    """A step up to its tests: the keyframe arm if ``state.mini_updated``,
    the two-stage match, the keyframe test and the spawn tests. No host
    sync. ``slots``: the atlas's slot ints on the device (default
    ``submap.device_slots``)."""
    slots = submap.device_slots(state.atlas) if slots is None else slots
    scan = sensor.read_scan(ranges, angles, cfg.lidar)
    maps = (_keyframe_maps(state, scan, cfg, slots) if state.mini_updated
            else map_leaves(state))
    guess = (state.pose + (state.pose - state.prev_pose) if state.step > 1
             else state.pose)
    coarse, fine, coarse_metric, fine_metric = maps[:4]
    m1 = (_first_match(coarse_metric, coarse, scan, guess, cfg)
          if state.mini_updated
          else _first_match(fine_metric, fine, scan, guess, cfg))
    return _head_end(state, scan, maps, m1.pose, cfg, slots)


def _insert(head: SubmapHead, refreshed: bool, cfg: SlamConfig,
            slots: torch.Tensor) -> SubmapSlamState:
    """The novel points into the active submap (slot ``slots[1]``), the
    keyframe pose moved to the pose. ``refreshed``: the step ran the
    keyframe arm, whose cached pre-match transform of the scan is reused
    (the stale-transform quirk); without it the scan is transformed with
    the new pose."""
    st, scan, m = head.state, head.scan, cfg.map
    scan_wx, scan_wy = st.scan_wx, st.scan_wy
    if not refreshed:
        scan_wx, scan_wy = se2.transform_ref(scan.x, scan.y, st.pose)
    j = torch.arange(scan_wx.shape[0], device=scan_wx.device)
    select = (j < head.best_count) & (head.last_hits > m.new_point_threshold)
    atlas = submap.insert_world_points(st.atlas, scan_wx, scan_wy, select,
                                       slots[1:2])
    return st._replace(mini_updated=True, keyframe_pose=st.pose, atlas=atlas,
                       scan_wx=scan_wx, scan_wy=scan_wy)


def slam_step(state: SubmapSlamState, ranges: torch.Tensor, cfg: SlamConfig,
              angles: torch.Tensor) -> tuple[SubmapSlamState, torch.Tensor]:
    """One scan; returns (new_state, pose): ``submap_head``, the tests on
    the host (the step's one sync), and when the keyframe test passed the
    spawn (``submap.spawned`` on the host ints, then ``open_slot``) and
    the insert."""
    head = submap_head(state, ranges, cfg, angles)
    moved, far, full = head.tests.tolist()
    if not moved:
        return head.state, head.state.pose
    atlas = state.atlas
    if far or full:
        atlas, write = submap.spawned(atlas)
        if write:
            atlas = submap.open_slot(atlas, head.state.pose,
                                     submap.device_slots(atlas)[1:2])
    head = head._replace(state=head.state._replace(atlas=atlas))
    new_state = _insert(head, state.mini_updated, cfg,
                        submap.device_slots(atlas))
    return new_state, new_state.pose


class _Static(NamedTuple):
    """The captured step's static buffers."""
    ranges: torch.Tensor   # (N,) the scan's ranges
    mini: torch.Tensor     # () bool, the state's mini_updated (JAX's carry)
    slots: torch.Tensor    # (2,) int64: the atlas's n_submaps and active
    m1: torch.Tensor       # (3,) the first matcher stage's pose
    head: SubmapHead       # head.state is the step's state
    out: torch.Tensor      # (6,) f32: the pose, mini_updated, n_submaps,
    #                        active


class SubmapStepFn(scan_matcher.StepFn):
    """``step(state, ranges) -> (state, pose)``: ``slam_step`` as one
    captured CUDA graph (``graphs.CapturedStep`` has the conventions).

    The graph is JAX's ``slam_step`` arm by arm, each arm an IF node on a
    device bool: IF(``mini_updated``) the keyframe arm (the atlas's local
    map, rasters, K1 on both grids); IF(``mini_updated``) and
    IF(``~mini_updated``) the first match on the coarse or the fine field;
    the second match and the tests (moved, far, full); ``submap.spawn``
    under ``moved & (far | full)``, its two arms (a new slot, or the full
    pool's) writing the slot buffer, which holds the atlas's
    ``n_submaps`` and ``active`` on the card as JAX's device ints; IF(
    ``moved & mini_updated``) and IF(``moved & ~mini_updated``) the insert
    with and without the refresh; and ``mini_updated := moved``.

    ``advance`` returns the step's device bool as the state's
    ``mini_updated`` and () int64 views of the slot buffer as its atlas's
    ``n_submaps`` and ``active``; ``step`` reads the pose and the three in
    one 24-byte copy. A state the step did not return (the paging's, a
    feedback's) is loaded with its slot ints."""

    def _eager(self, state: SubmapSlamState, ranges: torch.Tensor):
        """Scan 1, eagerly (its one host read: the tests)."""
        ranges = ranges.to(self.device, non_blocking=True)
        state, self.pose = slam_step(state, ranges, self.cfg, self.angles)
        return state, self.pose

    def _alloc(self, state: SubmapSlamState, ranges) -> _Static:
        n = self.cfg.lidar.n_beams
        f32 = dict(dtype=torch.float32, device=self.device)
        return _Static(
            ranges=torch.zeros(n, **f32),
            mini=torch.zeros((), dtype=torch.bool, device=self.device),
            slots=torch.zeros(2, dtype=torch.int64, device=self.device),
            m1=torch.zeros(3, **f32),
            head=SubmapHead(
                state=state, scan=sensor.empty_scan(n, self.device),
                best_count=torch.zeros((), dtype=torch.int32,
                                       device=self.device),
                last_hits=torch.zeros(n, **f32),
                tests=torch.zeros(3, dtype=torch.bool, device=self.device)),
            out=torch.zeros(6, **f32))

    def _load_fields(self, state: SubmapSlamState) -> None:
        super()._load_fields(state)
        ints = (state.atlas.n_submaps, state.atlas.active)
        if isinstance(ints[0], torch.Tensor):
            self.bufs.slots.copy_(torch.stack(ints))
        else:
            graphs.upload(self.bufs.slots, np.asarray(ints, np.int64))

    def _returned(self, state: SubmapSlamState):
        new, pose, scan = super()._returned(state)
        slots = self.bufs.slots
        return new._replace(atlas=new.atlas._replace(
            n_submaps=slots[0], active=slots[1])), pose, scan

    def _decode(self, state: SubmapSlamState, host: torch.Tensor):
        state = super()._decode(state, host)
        return state._replace(atlas=state.atlas._replace(
            n_submaps=int(host[4]), active=int(host[5])))

    def _body(self, b: _Static) -> None:
        """The step on the buffers; the state's host fields are those of a
        step after the first (its guess uses the velocity)."""
        cfg = self.cfg
        st = b.head.state._replace(step=2)
        scan = sensor.read_scan(b.ranges, self.angles, cfg.lidar)
        maps = map_leaves(st)
        graphs.cond(b.mini, lambda: graphs.copy_into(
            maps, _keyframe_maps(st, scan, cfg, b.slots)))
        guess = st.pose + (st.pose - st.prev_pose)
        coarse, fine, coarse_metric, fine_metric = maps[:4]
        graphs.cond(
            b.mini,
            lambda: b.m1.copy_(_first_match(coarse_metric, coarse, scan,
                                            guess, cfg).pose),
            lambda: b.m1.copy_(_first_match(fine_metric, fine, scan, guess,
                                            cfg).pose))
        graphs.copy_into(b.head, _head_end(st, scan, maps, b.m1, cfg,
                                           b.slots))
        moved, far, full = b.head.tests
        new = b.head.state
        submap.spawn(new.atlas, new.pose, b.slots, moved & (far | full))
        for refreshed in (True, False):
            mini = b.mini if refreshed else torch.logical_not(b.mini)
            graphs.cond(moved & mini,
                        lambda r=refreshed: graphs.copy_into(
                            new, _insert(b.head, r, cfg, b.slots)))
        b.mini.copy_(moved)
        b.out.copy_(torch.cat([new.pose, moved.to(torch.float32)[None],
                               b.slots.to(torch.float32)]))


def make_step_fn(cfg: SlamConfig, device: str | torch.device = "cuda"
                 ) -> SubmapStepFn:
    """The captured submap step (``SubmapStepFn``) on ``device``."""
    return SubmapStepFn(cfg, device)


def run_host_loop(ranges_all: np.ndarray, cfg: SlamConfig,
                  device: str | torch.device = "cuda"
                  ) -> tuple[np.ndarray, SubmapSlamState]:
    """Streaming run through ``make_step_fn``: each pose copied to the host
    as it is produced, one read a scan (JAX's ``run_host_loop``). Returns
    (path (T, 3) numpy, final state)."""
    return graphs.host_loop(*scan_matcher.over_scans(
        ranges_all, cfg, device, make_step_fn, init_state))


def run_scan(ranges_all: np.ndarray, cfg: SlamConfig,
             device: str | torch.device = "cuda"
             ) -> tuple[torch.Tensor, SubmapSlamState]:
    """Whole-log run through ``make_step_fn`` (JAX's ``lax.scan`` over the
    tour; ``graphs.drive``): scans 2.. with no host sync, one read at the
    end. Returns (path (T, 3) on the device, final state)."""
    return graphs.drive(*scan_matcher.over_scans(
        ranges_all, cfg, device, make_step_fn, init_state))
