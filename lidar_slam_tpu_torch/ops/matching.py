"""Correlative scan matching over the EDT likelihood field (counterpart of
``lidar_slam_tpu.ops.matching``).

Reference behaviours kept exactly (they shape the trajectory):
- transposed rotation (main.c:462-463) on the shared trig32 sin/cos;
- roundf cell snapping, then +1 for the reference's 1-based cells
  (main.c:483, 501);
- bounds ``(cx > 1) & (cy > 1) & (cx < n_cols) & (cy < n_rows)`` (main.c:512);
- theta-major, then tx, then ty candidate order and the first minimum of
  the scores (main.c:549) — ``torch.argmin`` returns the first minimum;
- ``last_hits`` compacted from the *last* candidate, ``best_count`` from the
  *best* one (the reference's bestHits aliasing, main.c:515).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.core.gridmap import OccGrid, roundf_like
from lidar_slam_tpu_torch.core.sensor import compact, scatter_rows
from lidar_slam_tpu_torch.core.trig32 import sincos32


class MatchResult(NamedTuple):
    pose: torch.Tensor        # (3,) best candidate pose
    score: torch.Tensor       # () best score
    best_count: torch.Tensor  # () i32 — in-bounds count of the best candidate
    last_hits: torch.Tensor   # (N,) EDT values of the LAST candidate, compacted
    last_inb: torch.Tensor    # (N,) bool — in-bounds & valid, last candidate


def candidate_grid_ref(pose: torch.Tensor, step_t: float, step_r: float,
                       window_t: int = 1, window_r: int = 1) -> torch.Tensor:
    """Candidate poses (nr*nt*nt, 3) in the reference's loop order (theta,
    then tx, then ty); (B, nr*nt*nt, 3) for poses (B, 3)."""
    dev = pose.device
    offs_t = torch.arange(-window_t, window_t + 1, dtype=torch.float32,
                          device=dev)
    offs_r = torch.arange(-window_r, window_r + 1, dtype=torch.float32,
                          device=dev)
    nr, nt = offs_r.shape[0], offs_t.shape[0]
    th = (pose[..., 2:3] + offs_r * step_r)[..., :, None, None]
    tx = (pose[..., 0:1] + offs_t * step_t)[..., None, :, None]
    ty = (pose[..., 1:2] + offs_t * step_t)[..., None, None, :]
    # expand, not repeat_interleave: on CUDA that reads its output size back
    # to the host, one sync per call
    shape = pose.shape[:-1] + (nr, nt, nt)
    return torch.stack([tx.expand(shape), ty.expand(shape), th.expand(shape)],
                       dim=-1).reshape(pose.shape[:-1] + (nr * nt * nt, 3))


def project_scan(scan_x: torch.Tensor, scan_y: torch.Tensor,
                 poses: torch.Tensor, grid: OccGrid):
    """1-based integer cells (C, N) of the scan under each candidate pose;
    (B, C, N) for scans (B, N) and poses (B, C, 3) on one grid."""
    ipixel = float(np.float32(1.0 / grid.pixel))
    px = (scan_x * ipixel)[..., None, :]
    py = (scan_y * ipixel)[..., None, :]
    st, ct = sincos32(poses[..., 2:3])                  # (C, 1)
    sx = px * ct + py * st                              # (C, N)
    sy = (-px) * st + py * ct
    offx = (poses[..., 0:1] - grid.origin[0]) * ipixel
    offy = (poses[..., 1:2] - grid.origin[1]) * ipixel
    cell_x = roundf_like(sx + offx).to(torch.int32) + 1
    cell_y = roundf_like(sy + offy).to(torch.int32) + 1
    return cell_x, cell_y


def score_candidates(metric: torch.Tensor, grid: OccGrid,
                     scan_x: torch.Tensor, scan_y: torch.Tensor,
                     valid: torch.Tensor, poses: torch.Tensor):
    """Scores (C,), gathered hits (C, N) and in-bounds masks (C, N); with a
    leading batch axis on the field (B, S, S), the scan and the poses, the
    same per batch element: (B, C), (B, C, N)."""
    cell_x, cell_y = project_scan(scan_x, scan_y, poses, grid)
    inb = ((cell_x > 1) & (cell_y > 1)
           & (cell_x < grid.n_cols) & (cell_y < grid.n_rows)
           & valid[..., None, :])
    iy = torch.clamp(cell_y - 1, 0, metric.shape[-2] - 1).long()
    ix = torch.clamp(cell_x - 1, 0, metric.shape[-1] - 1).long()
    # a batched field: batch element b gathers from metric[b]
    batch = tuple(torch.arange(b, device=metric.device).view(b, 1, 1)
                  for b in metric.shape[:-2])
    hits = torch.where(inb, metric[batch + (iy, ix)], 0.0)
    return hits.sum(dim=-1), hits, inb


def fast_match(metric: torch.Tensor, grid: OccGrid,
               scan_x: torch.Tensor, scan_y: torch.Tensor, valid: torch.Tensor,
               pose: torch.Tensor, step_t: float, step_r: float,
               window_t: int = 1, window_r: int = 1,
               window_penalty_px: float = 1.0) -> MatchResult:
    """One FastMatch call: first-minimum argmin over the candidate window.

    Windows wider than the reference's +-1 add ``window_penalty_px`` per
    step of L1 offset beyond the inner 3x3x3 (the JAX package's center-bias
    penalty); window 1 is untouched.

    Device dispatcher: on CUDA tensors one launch of kernel K3
    (``ops/cuda_scan_match``), on CPU tensors ``fast_match_plain``. A CUDA
    tensor never reaches the plain version.
    """
    if metric.is_cuda:
        from lidar_slam_tpu_torch.ops import cuda_scan_match

        return cuda_scan_match.fast_match_cuda(
            metric, grid, scan_x, scan_y, valid, pose, step_t, step_r,
            window_t, window_r, window_penalty_px)
    return fast_match_plain(metric, grid, scan_x, scan_y, valid, pose,
                            step_t, step_r, window_t, window_r,
                            window_penalty_px)


def fast_match_plain(metric: torch.Tensor, grid: OccGrid,
                     scan_x: torch.Tensor, scan_y: torch.Tensor,
                     valid: torch.Tensor, pose: torch.Tensor, step_t: float,
                     step_r: float, window_t: int = 1, window_r: int = 1,
                     window_penalty_px: float = 1.0) -> MatchResult:
    """``fast_match`` in plain tensor code: the CPU's path, and what K3 is
    held to with ``torch.equal`` on the card."""
    poses = candidate_grid_ref(pose, step_t, step_r, window_t, window_r)
    scores, hits, inb = score_candidates(metric, grid, scan_x, scan_y, valid,
                                         poses)
    if window_t > 1 or window_r > 1:
        dev = scores.device
        ot = torch.arange(-window_t, window_t + 1, dtype=torch.float32,
                          device=dev).abs()
        orr = torch.arange(-window_r, window_r + 1, dtype=torch.float32,
                           device=dev).abs()
        et = torch.clamp(ot - 1.0, min=0.0)
        excess = (torch.clamp(orr - 1.0, min=0.0)[:, None, None]
                  + et[None, :, None] + et[None, None, :]).reshape(-1)
        scores = scores + float(np.float32(window_penalty_px)) * excess
    # a 1-element index: indexing with a 0-dim CUDA tensor syncs the host
    best = torch.argmin(scores).view(1)
    counts = inb.sum(dim=1).to(torch.int32)
    last_inb = inb[-1]
    pos, _ = compact(last_inb)
    last_hits = scatter_rows(torch.zeros_like(hits[-1]), pos, hits[-1])
    return MatchResult(pose=poses[best][0], score=scores[best][0],
                       best_count=counts[best][0], last_hits=last_hits,
                       last_inb=last_inb)
