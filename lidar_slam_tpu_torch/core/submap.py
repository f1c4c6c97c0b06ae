"""Submap atlas: tiled long-term mapping with rigid loop-closure correction
(counterpart of ``lidar_slam_tpu.core.submap``).

The global map is an atlas of fixed-capacity submaps instead of one point
buffer: each submap stores its points in its anchor's frame and the
anchor's world pose is one (3,) row, so a pose-graph correction moves a
whole submap by rewriting its anchor. The matcher's local map is gathered
from the K nearest submaps by anchor distance, which bounds the per-scan
cost however large the explored area grows; cold submaps can be paged to
host memory (``utils/paging``).

Point storage keeps the JAX package's fixed shapes: (M, Ns, 2) points,
(M,) sizes, (M, 3) anchors on the device. The slot counts ``n_submaps``
and ``active`` are host ints in the eager step, where JAX's
``.at[slot].set(mode="drop")`` on a full pool is a host test
(``spawned``). The device functions index with the same two ints as a (2,)
int64 device tensor, ``slots`` (``device_slots``), through 1-element
slices and ``index_select`` / ``index_copy``: a graph captured with one
slot would replay that slot forever. In a captured step the step's slot
buffer is the authority (JAX's device ints): ``spawn`` reads and writes it
on the card, and the host ints come back when the run reads its state.

Frame convention: anchors are reference-convention poses (rotation by
-theta, ``se2.transform_ref``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_slam_tpu_torch.core import se2
from lidar_slam_tpu_torch.core.gridmap import LocalMap
from lidar_slam_tpu_torch.core.sensor import compact, scatter_rows
from lidar_slam_tpu_torch.device import constant, rounded64
from lidar_slam_tpu_torch.utils import graphs

_BIG = 1e30


class SubmapAtlas(NamedTuple):
    pts: torch.Tensor      # (M, Ns, 2) f32 — points in each anchor's frame
    sizes: torch.Tensor    # (M,) i32
    anchors: torch.Tensor  # (M, 3) f32 — world pose of each anchor
    n_submaps: int         # allocated slots
    active: int            # slot receiving new points
    # (a captured step that read nothing on the host returns the two as ()
    # int64 views of its slot buffer; ``graphs.settle`` reads them back)


def empty_atlas(n_submaps: int, capacity: int, device) -> SubmapAtlas:
    return SubmapAtlas(
        pts=torch.zeros((n_submaps, capacity, 2), dtype=torch.float32,
                        device=device),
        sizes=torch.zeros(n_submaps, dtype=torch.int32, device=device),
        anchors=torch.zeros((n_submaps, 3), dtype=torch.float32,
                            device=device),
        n_submaps=0, active=0)


def world_to_anchor(wx: torch.Tensor, wy: torch.Tensor, anchor: torch.Tensor):
    """Inverse of ``se2.transform_ref``: world -> anchor frame,
    R(theta)(w - t). cos and sin are float64 rounded once, the same f32 on
    every device."""
    dx = wx - anchor[..., 0:1]
    dy = wy - anchor[..., 1:2]
    ct = rounded64(torch.cos, anchor[..., 2:3])
    st = rounded64(torch.sin, anchor[..., 2:3])
    return ct * dx - st * dy, st * dx + ct * dy


def device_slots(atlas: SubmapAtlas) -> torch.Tensor:
    """(2,) int64 on the atlas's device: ``n_submaps`` and ``active``, a
    cached constant (no host->device copy a step; never write to it)."""
    return constant((atlas.n_submaps, atlas.active), atlas.pts.device,
                    torch.int64)


def spawned(atlas: SubmapAtlas) -> tuple[SubmapAtlas, bool]:
    """The host side of ``start_submap``: the atlas with its slot ints after
    a new submap opens, and whether a slot is written. With the pool full
    nothing is written and the last slot stays active (paging evicts cold
    slots before that happens in the paged host loop)."""
    m = atlas.pts.shape[0]
    if atlas.n_submaps >= m:
        return atlas._replace(active=m - 1), False
    return atlas._replace(n_submaps=atlas.n_submaps + 1,
                          active=atlas.n_submaps), True


def open_slot(atlas: SubmapAtlas, anchor: torch.Tensor,
              k: torch.Tensor) -> SubmapAtlas:
    """Slot ``k`` ((1,) int64) emptied and anchored at ``anchor``."""
    return atlas._replace(pts=atlas.pts.index_fill(0, k, 0.0),
                          sizes=atlas.sizes.index_fill(0, k, 0),
                          anchors=atlas.anchors.index_copy(0, k, anchor[None]))


def start_submap(atlas: SubmapAtlas, anchor: torch.Tensor) -> SubmapAtlas:
    """Open a new submap anchored at ``anchor`` and make it active
    (``spawned``, then ``open_slot``)."""
    atlas, write = spawned(atlas)
    if not write:
        return atlas
    return open_slot(atlas, anchor, device_slots(atlas)[1:2])


def spawn(atlas: SubmapAtlas, anchor: torch.Tensor, slots: torch.Tensor,
          when: torch.Tensor) -> None:
    """JAX's ``start_submap`` under the () bool ``when``, in place, on a
    captured step's static atlas and its slot buffer ``slots`` ((2,) int64:
    ``n_submaps`` and ``active``): with n < M slots, slot n opens at
    ``anchor`` and the ints become (n + 1, n) (``open_next_slot``); on a
    full pool nothing is written and the active slot is M - 1
    (``keep_last_slot``, JAX's ``mode="drop"``). Each is a ``graphs.cond``
    arm, so neither ``when`` nor n is read on the host."""
    m = atlas.pts.shape[0]
    room = slots[0] < m
    graphs.cond(when & room, lambda: open_next_slot(atlas, anchor, slots))
    graphs.cond(when & ~room, lambda: keep_last_slot(slots, m))


def open_next_slot(atlas: SubmapAtlas, anchor: torch.Tensor,
                   slots: torch.Tensor) -> None:
    """``spawn``'s arm with room in the pool: slot n emptied and anchored
    at ``anchor``, the ints (n + 1, n); in place."""
    n = slots[0:1]
    atlas.pts.index_fill_(0, n, 0.0)
    atlas.sizes.index_fill_(0, n, 0)
    atlas.anchors.index_copy_(0, n, anchor[None])
    slots.copy_(torch.cat([n + 1, n]))


def keep_last_slot(slots: torch.Tensor, m: int) -> None:
    """``spawn``'s arm on a full pool: the last slot stays active."""
    slots[1:2].fill_(m - 1)


def insert_world_points(atlas: SubmapAtlas, wx: torch.Tensor, wy: torch.Tensor,
                        select: torch.Tensor,
                        k: torch.Tensor | None = None) -> SubmapAtlas:
    """Append the selected world-frame points, in order, to the active
    submap (slot ``k``, (1,) int64; default the atlas's ``active``) in its
    anchor's frame; writes past capacity are dropped and the size saturates
    (``gridmap.append_points``)."""
    k = device_slots(atlas)[1:2] if k is None else k
    ax, ay = world_to_anchor(wx, wy, atlas.anchors.index_select(0, k))
    cap = atlas.pts.shape[1]
    size = atlas.sizes.index_select(0, k)
    pos, _ = compact(select, offset=size, capacity=cap)
    row = scatter_rows(atlas.pts.index_select(0, k)[0], pos,
                       torch.stack([ax[0], ay[0]], 1))
    size = torch.clamp(size + select.sum(), max=cap).to(atlas.sizes.dtype)
    return atlas._replace(pts=atlas.pts.index_copy(0, k, row[None]),
                          sizes=atlas.sizes.index_copy(0, k, size))


def submap_world_points(atlas: SubmapAtlas):
    """All submap points in the world frame: (M, Ns) x, y and mask."""
    wx, wy = se2.transform_ref(atlas.pts[..., 0], atlas.pts[..., 1],
                               atlas.anchors)
    m, ns = atlas.pts.shape[:2]
    dev = atlas.pts.device
    mask = ((torch.arange(ns, device=dev)[None, :] < atlas.sizes[:, None])
            & (torch.arange(m, device=dev)[:, None] < atlas.n_submaps))
    return wx, wy, mask


def nearest_submaps(atlas: SubmapAtlas, pose: torch.Tensor,
                    k_nearest: int,
                    slots: torch.Tensor | None = None) -> torch.Tensor:
    """Indices (K,) of the K nearest allocated submaps by anchor xy
    distance, the active one first (distance forced to -1). Unallocated
    slots tie at +inf; a stable sort orders every tie by slot, as JAX's
    ``top_k`` does (``torch.topk`` leaves ties in no fixed order).
    ``slots``: see the module docstring (default ``device_slots``)."""
    slots = device_slots(atlas) if slots is None else slots
    m = atlas.pts.shape[0]
    diff = atlas.anchors[:, :2] - pose[:2]
    d2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
    d2 = torch.where(torch.arange(m, device=d2.device) < slots[0:1], d2,
                     torch.inf)
    d2 = d2.index_fill(0, slots[1:2], -1.0)
    return torch.sort(d2, stable=True).indices[:k_nearest]


def extract_local_from_atlas(atlas: SubmapAtlas, pose: torch.Tensor,
                             scan_wx: torch.Tensor, scan_wy: torch.Tensor,
                             scan_valid: torch.Tensor, border: float,
                             k_nearest: int,
                             slots: torch.Tensor | None = None) -> LocalMap:
    """The matcher's local map: the K nearest submaps' points in the world
    frame, cropped to the scan's bounding box plus ``border`` (strict
    inequalities, as ``gridmap.extract_local_map``). Capacity K * Ns.
    ``slots``: as ``nearest_submaps``."""
    slots = device_slots(atlas) if slots is None else slots
    idx = nearest_submaps(atlas, pose, k_nearest, slots)   # (K,)
    pts = atlas.pts[idx]                                   # (K, Ns, 2)
    wx, wy = se2.transform_ref(pts[..., 0], pts[..., 1], atlas.anchors[idx])
    ns = pts.shape[1]
    valid = ((torch.arange(ns, device=pts.device)[None, :]
              < atlas.sizes[idx][:, None])
             & (idx[:, None] < slots[0:1]))
    min_x = torch.where(scan_valid, scan_wx, _BIG).min() - border
    min_y = torch.where(scan_valid, scan_wy, _BIG).min() - border
    max_x = torch.where(scan_valid, scan_wx, -_BIG).max() + border
    max_y = torch.where(scan_valid, scan_wy, -_BIG).max() + border
    fx, fy = wx.reshape(-1), wy.reshape(-1)
    inside = (fx > min_x) & (fx < max_x) & (fy > min_y) & (fy < max_y)
    return LocalMap(xy=torch.stack([fx, fy], dim=1),
                    mask=valid.reshape(-1) & inside)


def apply_anchor_correction(atlas: SubmapAtlas,
                            new_anchors: torch.Tensor) -> SubmapAtlas:
    """Move submaps rigidly to pose-graph-optimized anchors (M, 3); slots
    beyond ``n_submaps`` are masked everywhere they are read."""
    return atlas._replace(anchors=new_anchors.to(torch.float32))


def total_points(atlas: SubmapAtlas) -> torch.Tensor:
    m = atlas.pts.shape[0]
    live = torch.arange(m, device=atlas.sizes.device) < atlas.n_submaps
    return torch.where(live, atlas.sizes, 0).sum()
