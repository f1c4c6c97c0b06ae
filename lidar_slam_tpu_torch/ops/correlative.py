"""Correlation-volume scan scoring (counterpart of
``lidar_slam_tpu.ops.correlative``).

The scan is projected once per theta bin around a base pose; the volume
``scores[t, dy, dx]`` is the summed EDT field under the scan shifted by
(dy, dx) cells at bin t, and ``counts`` the number of in-bounds beams. Any
continuous pose is then scored by trilinear interpolation into the volume,
at a cost independent of the particle count.

The JAX package builds the volume with TPU workarounds for slow gathers and
scatters: a bf16 one-hot histogram correlated over the whole field (Pallas),
or a row-slab gather with a one-hot column matmul, and a one-hot-matmul
lookup. A GPU gathers well, so the port computes the semantics directly:

- ``build_score_volume``: for each (t, beam, dy, dx) the masked field at
  ``(cy0 + dy - half, cx0 + dx - half)``, with the reference bounds
  ``1 <= row < n_rows - 1``, ``1 <= col < n_cols - 1``; cells beyond the
  fixed array read 0, as in the Pallas padding. CUDA tensors go to kernel
  K2 (``ops/cuda_match.py``), which stages the field as integer codes of
  its 2^-10 lattice (2^-(10+l) at cascade level l), CPU tensors to
  ``score_volume_plain``.
- ``lookup_avg_distance``, ``lookup_cascade`` and ``refine_estimate``:
  a direct gather of the 8 trilinear corners. CUDA tensors go to kernel K4
  (``ops/cuda_vol_lookup.py``), one launch a call, unless autograd is to
  record the call; CPU tensors, and poses that record a gradient, to the
  plain versions (``*_plain``).

Loop closure matches a scan against several old keyframes at once: the
volume, the counts and the lookups then carry a leading batch axis, and the
kernel builds the whole batch in one launch.

The count volume stays analytic (it separates into row and column tests).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.core.gridmap import OccGrid, roundf_like
from lidar_slam_tpu_torch.device import constant


class ScoreVolume(NamedTuple):
    scores: torch.Tensor     # (T, W, W) f32 — summed field per offset
    counts: torch.Tensor     # (T, W, W) f32 — in-bounds beams per offset
    base_pose: torch.Tensor  # (3,) pose the volume is centred on
    theta_step: float
    ipixel: float
    half: int                # W = 2*half + 1
    # A batch of volumes (loop closure's candidates) puts a leading axis B
    # on scores/counts (B, T, W, W) and base_pose (B, 3).


# argmin passes of refine_estimate over its candidates (kernel K4 holds the
# same number, REFINE_PASSES in csrc/vol_lookup.cu)
REFINE_PASSES = 3

# values gathered per slice of the plain volume: bounds its temporaries to
# a few tens of MB whatever the batch, bins and window
_PLAIN_SLICE = 1 << 22


def _volume_slice(metric: torch.Tensor, cx0: torch.Tensor, cy0: torch.Tensor,
                  valid: torch.Tensor, n_rows, n_cols, half: int
                  ) -> torch.Tensor:
    s = metric.shape[0]
    offs = torch.arange(2 * half + 1, device=metric.device) - half
    rows = cy0[..., None] + offs                            # (T, N, W)
    cols = cx0[..., None] + offs
    row_ok = ((rows >= 1) & (rows < n_rows - 1) & (rows < s)
              & valid[None, :, None])
    col_ok = (cols >= 1) & (cols < n_cols - 1) & (cols < s)
    vals = metric[rows.clamp(0, s - 1).long()[..., :, None],
                  cols.clamp(0, s - 1).long()[..., None, :]]  # (T, N, W, W)
    ok = row_ok[..., :, None] & col_ok[..., None, :]
    return torch.where(ok, vals, 0.0).sum(dim=1)


def score_volume_plain(metric: torch.Tensor, cx0: torch.Tensor,
                       cy0: torch.Tensor, valid: torch.Tensor,
                       n_rows, n_cols, half: int) -> torch.Tensor:
    """Plain PyTorch version of K2: scores (T, W, W) by direct gather.

    metric (S, S) f32; cx0/cy0 (T, N) i32 base cells (0-based); valid (N,)
    bool; n_rows/n_cols the grid's live extent (int or 0-dim tensor). With a
    leading batch axis — metric (B, S, S), cx0/cy0 (B, T, N), valid (B, N) —
    it returns (B, T, W, W). The gather runs a few theta bins at a time.
    """
    if metric.dim() == 3:
        return torch.stack([
            score_volume_plain(metric[b], cx0[b], cy0[b], valid[b], n_rows,
                               n_cols, half) for b in range(metric.shape[0])])
    t, n = cx0.shape
    step = max(1, _PLAIN_SLICE // max(1, n * (2 * half + 1) ** 2))
    return torch.cat([
        _volume_slice(metric, cx0[a:a + step], cy0[a:a + step], valid,
                      n_rows, n_cols, half) for a in range(0, t, step)])


def score_volume(metric: torch.Tensor, cx0: torch.Tensor, cy0: torch.Tensor,
                 valid: torch.Tensor, n_rows, n_cols, half: int,
                 lattice_bits: int = 10) -> torch.Tensor:
    """Device dispatcher: kernel K2 for CUDA tensors, the plain version for
    CPU tensors. A CUDA tensor never reaches the plain version. The field
    lies on the 2^-lattice_bits lattice (K2 stages it as integer codes)."""
    if metric.is_cuda:
        from lidar_slam_tpu_torch.ops import cuda_match

        return cuda_match.score_volume_cuda(metric, cx0, cy0, valid,
                                            n_rows, n_cols, half,
                                            lattice_bits)
    return score_volume_plain(metric, cx0, cy0, valid, n_rows, n_cols, half)


def count_volume(cx0: torch.Tensor, cy0: torch.Tensor, valid: torch.Tensor,
                 n_rows, n_cols, half: int) -> torch.Tensor:
    """In-bounds beam counts (T, W, W), or (B, T, W, W) for batched inputs:
    the bounds test separates into row and column conditions, so this is a
    small mask product, no kernel."""
    offs = torch.arange(2 * half + 1, device=cx0.device) - half
    rows = cy0[..., None] + offs
    cols = cx0[..., None] + offs
    row_ok = ((rows >= 1) & (rows < n_rows - 1)
              & valid[..., None, :, None]).to(torch.float32)
    col_ok = ((cols >= 1) & (cols < n_cols - 1)).to(torch.float32)
    return torch.einsum("...tnr,...tnc->...trc", row_ok, col_ok)


def base_cells(grid: OccGrid, scan_x: torch.Tensor, scan_y: torch.Tensor,
               base_pose: torch.Tensor, n_theta: int, theta_step: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """0-based base cells (T, N) of the scan at each theta bin; (B, T, N)
    for a batch of scans (B, N) and base poses (B, 3) on one grid."""
    ipixel = float(np.float32(1.0 / grid.pixel))
    t_half = n_theta // 2
    bins = torch.arange(n_theta, dtype=torch.float32, device=scan_x.device)
    thetas = base_pose[..., 2:3] + (bins - t_half) * theta_step
    # cos/sin in float64, rounded once: the same f32 values on every device
    ct = torch.cos(thetas.to(torch.float64)).to(torch.float32)[..., None]
    st = torch.sin(thetas.to(torch.float64)).to(torch.float32)[..., None]
    px = (scan_x * ipixel)[..., None, :]
    py = (scan_y * ipixel)[..., None, :]
    rx = px * ct + py * st                          # reference rotation
    ry = (-px) * st + py * ct
    offx = ((base_pose[..., 0] - grid.origin[0]) * ipixel)[..., None, None]
    offy = ((base_pose[..., 1] - grid.origin[1]) * ipixel)[..., None, None]
    cx0 = roundf_like(rx + offx).to(torch.int32)
    cy0 = roundf_like(ry + offy).to(torch.int32)
    return cx0, cy0


def build_score_volume(metric: torch.Tensor, grid: OccGrid,
                       scan_x: torch.Tensor, scan_y: torch.Tensor,
                       valid: torch.Tensor, base_pose: torch.Tensor,
                       n_theta: int = 9, theta_step: float = 0.004363,
                       half: int = 8, lattice_bits: int = 10) -> ScoreVolume:
    """The (n_theta, W, W) correlation volume around ``base_pose``; with a
    leading batch axis on metric, scan and base pose, B volumes in one
    kernel launch. ``metric`` lies on the 2^-lattice_bits lattice: 10 for
    an EDT field, 10 + l for one min-pooled and divided by 2^l."""
    cx0, cy0 = base_cells(grid, scan_x, scan_y, base_pose, n_theta,
                          theta_step)
    scores = score_volume(metric, cx0, cy0, valid, grid.n_rows, grid.n_cols,
                          half, lattice_bits)
    counts = count_volume(cx0, cy0, valid, grid.n_rows, grid.n_cols, half)
    return ScoreVolume(scores=scores, counts=counts, base_pose=base_pose,
                       theta_step=float(theta_step),
                       ipixel=float(np.float32(1.0 / grid.pixel)), half=half)


def downsample_metric(metric: torch.Tensor, grid: OccGrid, factor: int
                      ) -> tuple[torch.Tensor, OccGrid]:
    """Min-pool the field by ``factor`` for coarse cascade levels, in
    coarse-pixel units; the origin moves to the block centres."""
    s = metric.shape[0]
    if s % factor:
        raise ValueError(f"grid side {s} not divisible by {factor}")
    m2 = metric.reshape(s // factor, factor, s // factor, factor)
    m2 = m2.amin(dim=3).amin(dim=1) / factor
    grid2 = OccGrid(
        occ=grid.occ[::factor, ::factor],
        n_rows=(grid.n_rows + factor - 1) // factor,
        n_cols=(grid.n_cols + factor - 1) // factor,
        origin=grid.origin + float(np.float32(
            0.5 * (factor - 1) * np.float32(grid.pixel))),
        pixel=float(np.float32(grid.pixel) * np.float32(factor)))
    return m2, grid2


def build_cascade(metric: torch.Tensor, grid: OccGrid,
                  scan_x: torch.Tensor, scan_y: torch.Tensor,
                  valid: torch.Tensor, base_pose: torch.Tensor,
                  n_theta: int, theta_step: float, half: int,
                  levels: int) -> list[ScoreVolume]:
    """Score volumes at pixel scales 1x, 2x, 4x, ... around ``base_pose``."""
    vols = [build_score_volume(metric, grid, scan_x, scan_y, valid, base_pose,
                               n_theta=n_theta, theta_step=theta_step,
                               half=half)]
    for lvl in range(1, levels):
        f = 2 ** lvl
        m2, g2 = downsample_metric(metric, grid, f)
        vols.append(build_score_volume(
            m2, g2, scan_x, scan_y, valid, base_pose,
            n_theta=n_theta, theta_step=theta_step * f, half=half,
            lattice_bits=10 + lvl))
    return vols


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` as an IEEE division on every device. PyTorch's CUDA
    ``div`` turns a Python-scalar divisor into a multiplication by its
    reciprocal, which can differ from the CPU's quotient in the last bit; a
    0-dim tensor on ``x``'s device keeps the true division."""
    return x / constant(float(divisor), x.device, x.dtype)


def _base_for(vol: ScoreVolume, poses: torch.Tensor) -> torch.Tensor:
    """The volume's base pose, shaped to broadcast against ``poses``: a
    batched volume's (B, 3) bases meet poses (B, ..., 3)."""
    if vol.scores.dim() == 4:
        b = vol.base_pose.shape[0]
        return vol.base_pose.view((b,) + (1,) * (poses.dim() - 2) + (3,))
    return vol.base_pose


def _fractional_index(vol: ScoreVolume, poses: torch.Tensor):
    t = vol.scores.shape[-3]
    base = _base_for(vol, poses)
    fdx = (poses[..., 0] - base[..., 0]) * vol.ipixel + vol.half
    fdy = (poses[..., 1] - base[..., 1]) * vol.ipixel + vol.half
    fdt = true_div(poses[..., 2] - base[..., 2], vol.theta_step) + t // 2
    return fdt, fdy, fdx


def _window_inside(vol: ScoreVolume, poses: torch.Tensor) -> torch.Tensor:
    """True where a pose lies inside the volume's interpolation window."""
    t = vol.scores.shape[-3]
    fdt, fdy, fdx = _fractional_index(vol, poses)
    w = 2 * vol.half
    return ((fdx >= 0) & (fdx <= w) & (fdy >= 0) & (fdy <= w)
            & (fdt >= 0) & (fdt <= t - 1))


def _on_kernel(poses: torch.Tensor) -> bool:
    """True where K4 runs a lookup: CUDA poses, unless autograd is to record
    their gradient (``grad_refine_steps``), whose backward needs the plain
    version's graph."""
    return poses.is_cuda and not (torch.is_grad_enabled()
                                  and poses.requires_grad)


def lookup_avg_distance(vol: ScoreVolume, poses: torch.Tensor) -> torch.Tensor:
    """``lookup_avg_distance_plain``'s result; on CUDA tensors with no
    gradient to record, one launch of kernel K4."""
    if _on_kernel(poses):
        from lidar_slam_tpu_torch.ops import cuda_vol_lookup

        return cuda_vol_lookup.lookup_avg_distance_cuda(vol, poses)
    return lookup_avg_distance_plain(vol, poses)


def lookup_avg_distance_plain(vol: ScoreVolume, poses: torch.Tensor
                              ) -> torch.Tensor:
    """Average field distance for poses (..., 3) by trilinear interpolation
    of scores and counts (8 direct corner gathers); for a batched volume,
    poses (B, ..., 3) look up volume b.

    Out-of-window poses clamp to the edge: the fractional index itself is
    clamped into the window, so every pose beyond an edge evaluates to
    bit-identical inputs and ties exactly with its neighbours there. The
    JAX package clamps the corner indices instead — the same function — and
    its one-hot contraction happens to tie those poses exactly too; the
    refinement's first-minimum argmin depends on that tie. The gradient
    (``grad_refine_steps``) is the same too: beyond an edge both
    interpolation corners along that axis are the edge cell, so the value
    does not move with the pose there in either form.
    """
    t, w, _ = vol.scores.shape[-3:]
    fdt, fdy, fdx = _fractional_index(vol, poses)
    fdt = torch.clamp(fdt, 0.0, float(t - 1))
    fdy = torch.clamp(fdy, 0.0, float(w - 1))
    fdx = torch.clamp(fdx, 0.0, float(w - 1))
    t0 = torch.floor(fdt)
    y0 = torch.floor(fdy)
    x0 = torch.floor(fdx)
    at_, ay, ax = fdt - t0, fdy - y0, fdx - x0
    t0, y0, x0 = t0.long(), y0.long(), x0.long()
    scores = vol.scores.reshape(-1)
    counts = vol.counts.reshape(-1)
    if vol.scores.dim() == 4:
        b = vol.scores.shape[0]
        boff = (torch.arange(b, device=poses.device) * (t * w * w)).view(
            (b,) + (1,) * (poses.dim() - 2))
    else:
        boff = 0
    num = torch.zeros_like(fdx)
    den = torch.zeros_like(fdx)
    for dt_ in (0, 1):
        for dy_ in (0, 1):
            for dx_ in (0, 1):
                wgt = ((at_ if dt_ else 1 - at_)
                       * (ay if dy_ else 1 - ay)
                       * (ax if dx_ else 1 - ax))
                ti = torch.clamp(t0 + dt_, 0, t - 1)
                yi = torch.clamp(y0 + dy_, 0, w - 1)
                xi = torch.clamp(x0 + dx_, 0, w - 1)
                idx = (ti * w + yi) * w + xi + boff
                num = num + wgt * scores[idx]
                den = den + wgt * counts[idx]
    return num / torch.clamp(den, min=1.0)


def lookup_cascade(vols: list[ScoreVolume], poses: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lookup_cascade_plain``'s result; on CUDA tensors with no gradient
    to record, one launch of kernel K4."""
    if _on_kernel(poses):
        from lidar_slam_tpu_torch.ops import cuda_vol_lookup

        return cuda_vol_lookup.lookup_cascade_cuda(vols, poses)
    return lookup_cascade_plain(vols, poses)


def lookup_cascade_plain(vols: list[ScoreVolume], poses: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Average distance (fine-pixel units) from the finest level whose
    window contains the pose, and the fine-window escape mask."""
    dist = chosen = fine_escape = None
    for lvl, vol in enumerate(vols):
        d = lookup_avg_distance_plain(vol, poses) * (2.0 ** lvl)
        inside = _window_inside(vol, poses)
        if dist is None:
            dist, chosen, fine_escape = d, inside, ~inside
        else:
            dist = torch.where(chosen, dist, d)
            chosen = chosen | inside
    return dist, fine_escape


def refine_estimate(vols: list[ScoreVolume], est_pose: torch.Tensor,
                    offs: torch.Tensor) -> torch.Tensor:
    """``refine_estimate_plain``'s result; on CUDA tensors with no gradient
    to record, one launch of kernel K4 for all the passes."""
    if _on_kernel(est_pose):
        from lidar_slam_tpu_torch.ops import cuda_vol_lookup

        return cuda_vol_lookup.refine_estimate_cuda(vols, est_pose, offs)
    return refine_estimate_plain(vols, est_pose, offs)


def refine_estimate_plain(vols: list[ScoreVolume], est_pose: torch.Tensor,
                          offs: torch.Tensor) -> torch.Tensor:
    """The estimate (3,) moved ``REFINE_PASSES`` times to the first minimum
    of the cascade distance over the candidates ``est_pose + offs`` (offs
    (K, 3)), with no host sync."""
    for _ in range(REFINE_PASSES):
        cands = est_pose[None, :] + offs
        d, _ = lookup_cascade_plain(vols, cands)
        est_pose = cands[torch.argmin(d).view(1)][0]
    return est_pose
