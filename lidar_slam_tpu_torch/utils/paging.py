"""Host paging for the submap atlas: unbounded maps on a bounded device pool
(counterpart of ``lidar_slam_tpu.utils.paging``).

The device atlas holds M submaps; an unbounded environment makes any
number. ``PagedAtlas.manage`` archives cold submaps (anchors far from the
robot) to host memory and reloads them when the trajectory comes back, so
the card holds M * Ns points whatever the tour. It runs between steps at
keyframe rate on host numpy: the atlas comes to the host in one copy and,
when anything changed, goes back in one copy, which the captured step
loads at its next call.

Archived submaps keep their points in the anchor frame, so a pose-graph
correction while one is paged out rewrites only its (3,) anchor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidar_slam_tpu_torch.core import submap as sm
from lidar_slam_tpu_torch.core.submap import SubmapAtlas


@dataclasses.dataclass
class ArchivedSubmap:
    pts: np.ndarray      # (size, 2) anchor-frame points (trimmed)
    anchor: np.ndarray   # (3,)


def _to_host(atlas: SubmapAtlas):
    """(pts, sizes, anchors) as writable numpy arrays, in one copy (the
    sizes are at most the capacity, exact in f32)."""
    m, ns = atlas.pts.shape[:2]
    host = torch.cat([atlas.pts.reshape(-1), atlas.anchors.reshape(-1),
                      atlas.sizes.to(torch.float32)]).cpu().numpy()
    a, b = m * ns * 2, m * ns * 2 + m * 3
    return (host[:a].reshape(m, ns, 2).copy(), host[b:].astype(np.int32),
            host[a:b].reshape(m, 3).copy())


def _to_device(pts, sizes, anchors, n: int, active: int, device
               ) -> SubmapAtlas:
    """The host arrays as an atlas on ``device``, in one copy."""
    m, ns = pts.shape[:2]
    buf = torch.as_tensor(np.concatenate(
        [pts.reshape(-1), anchors.reshape(-1), sizes.astype(np.float32)]),
        device=device)
    a, b = m * ns * 2, m * ns * 2 + m * 3
    return SubmapAtlas(pts=buf[:a].view(m, ns, 2),
                       sizes=buf[b:].to(torch.int32),
                       anchors=buf[a:b].view(m, 3), n_submaps=n,
                       active=active)


class PagedAtlas:
    """Host-side manager pairing a device ``SubmapAtlas`` with an archive.

    Call ``manage(atlas, pose)`` at keyframe rate: it reloads archived
    submaps whose anchors are within ``near_dist`` of the pose and, when the
    device pool is (nearly) full, evicts the furthest non-active residents.
    Returns the atlas, rewritten only if something moved.
    """

    def __init__(self, near_dist: float = 8.0, keep_free: int = 2):
        self.archive: list[ArchivedSubmap] = []
        self.near_dist = near_dist
        self.keep_free = keep_free
        self.pages_out = 0
        self.pages_in = 0

    def _evict(self, pts, sizes, anchors, n, active, pose_xy, want_free):
        """Archive the furthest residents until ``want_free`` slots are
        free; the tail slot moves into the evicted one (the matcher selects
        by anchor distance, so the order in the pool is irrelevant)."""
        m = pts.shape[0]
        while n > m - want_free:
            d = np.hypot(anchors[:n, 0] - pose_xy[0],
                         anchors[:n, 1] - pose_xy[1])
            d[active] = -1.0  # never evict the submap being built
            victim = int(np.argmax(d))
            if d[victim] <= self.near_dist:
                break  # everything resident is hot
            self.archive.append(ArchivedSubmap(
                pts=pts[victim, : sizes[victim]].copy(),
                anchor=anchors[victim].copy()))
            self.pages_out += 1
            last = n - 1
            if victim != last:
                pts[victim] = pts[last]
                sizes[victim] = sizes[last]
                anchors[victim] = anchors[last]
                if active == last:
                    active = victim
            pts[last] = 0.0
            sizes[last] = 0
            n = last
        return n, active

    def manage(self, atlas: SubmapAtlas, pose) -> SubmapAtlas:
        pose = np.asarray(pose)
        pts, sizes, anchors = _to_host(atlas)
        n, active = atlas.n_submaps, atlas.active
        m, cap = pts.shape[0], pts.shape[1]

        # page-in: archived submaps whose anchors came back into range
        near = [i for i, a in enumerate(self.archive)
                if np.hypot(a.anchor[0] - pose[0], a.anchor[1] - pose[1])
                <= self.near_dist]
        changed = False
        for i in sorted(near, reverse=True):
            if n >= m:
                n, active = self._evict(pts, sizes, anchors, n, active,
                                        pose[:2], 1)
                changed = True
                if n >= m:
                    break  # pool saturated with hot submaps
            a = self.archive.pop(i)
            k = min(len(a.pts), cap)
            pts[n] = 0.0
            pts[n, :k] = a.pts[:k]
            sizes[n] = k
            anchors[n] = a.anchor
            n += 1
            self.pages_in += 1
            changed = True

        # page-out: keep headroom so spawns never meet a full pool
        if n > m - self.keep_free:
            n2, active2 = self._evict(pts, sizes, anchors, n, active,
                                      pose[:2], self.keep_free)
            changed |= (n2 != n) or (active2 != active)
            n, active = n2, active2

        if not changed:
            return atlas
        return _to_device(pts, sizes, anchors, n, active, atlas.pts.device)

    def world_points(self, atlas: SubmapAtlas) -> np.ndarray:
        """All map points (resident and archived) in the world frame,
        (P, 2) numpy."""
        wx, wy, mask = sm.submap_world_points(atlas)
        wx, wy, mask = wx.cpu().numpy(), wy.cpu().numpy(), mask.cpu().numpy()
        parts = [np.stack([wx[mask], wy[mask]], axis=1)]
        for a in self.archive:
            ct, st = np.cos(a.anchor[2]), np.sin(a.anchor[2])
            # reference-convention transform (rotation by -theta)
            x = ct * a.pts[:, 0] + st * a.pts[:, 1] + a.anchor[0]
            y = -st * a.pts[:, 0] + ct * a.pts[:, 1] + a.anchor[1]
            parts.append(np.stack([x, y], axis=1))
        return np.concatenate(parts)


def run_host_loop_paged(ranges_all: np.ndarray, cfg, paged: PagedAtlas,
                        manage_every: int = 16,
                        device: str | torch.device = "cuda"):
    """Host loop with paging every ``manage_every`` scans: unbounded maps on
    a fixed device pool (JAX's ``run_host_loop_paged``). The loop drives
    the captured step (``submap_slam.make_step_fn``) and reads one pose a
    scan, with the state's host fields in the same copy; a paged atlas (its
    slot ints included) enters the step through its next call, which loads
    a state it did not return. Returns (path (T, 3) numpy, final state)."""
    from lidar_slam_tpu_torch.models import scan_matcher, submap_slam
    from lidar_slam_tpu_torch.utils import graphs

    ranges = scan_matcher.as_ranges(ranges_all, device)
    step = submap_slam.make_step_fn(cfg, ranges.device)
    state = submap_slam.init_state(ranges[0], cfg)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, ranges.shape[0]):
        state, pose = step(state, ranges[t])
        poses.append(pose)
        if t % manage_every == 0:
            new_atlas = paged.manage(state.atlas, pose)
            if new_atlas is not state.atlas:
                state = state._replace(atlas=new_atlas)
    return np.stack(poses), graphs.clone_tree(step.finish(state))
