"""Wrapper of kernel K3, the correlative matcher in ``csrc/scan_match.cu``.

Replaces no TPU kernel: ``ops/matching.fast_match`` is plain tensor code in
both packages, which XLA fuses on the TPU. On the card the plain version
is about 118 small PyTorch kernels a call, and a fidelity step makes two
calls; K3 is one launch a call: one thread block cluster with a block for
each heading. A block computes its heading's trig32 sin/cos, tables every
beam's clamped gather column and row under each offset with the bounds
test folded in and sums each of its candidates' hits as integer lattice
codes; the last heading's block compacts the last candidate's hits by a
prefix count; block 0 reads every block's sums through distributed shared
memory and takes the first minimum. ``csrc/scan_match.cu`` has the
details.

The result is ``fast_match``'s bit for bit: the same float32 operations in
the same order, and a candidate's sum of lattice codes exact while it is
below 2^24 (a field value off the 2^-10 lattice, or a sum that reaches
2^24, gives a NaN score instead). ``matching.fast_match`` calls it for CUDA
tensors; the CPU keeps the plain version.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from lidar_slam_tpu_torch import _build
from lidar_slam_tpu_torch.core.gridmap import OccGrid
from lidar_slam_tpu_torch.ops.cuda_match import SMEM_BYTES
from lidar_slam_tpu_torch.ops.cuda_match import _extent
from lidar_slam_tpu_torch.ops.matching import MatchResult

# kernel launches made through this wrapper since the last reset; a replay
# of a captured graph adds the launches it holds (``utils/graphs``)
launches = 0
# the same launches keyed by (C, N, S): candidates, beams, field side
launches_by_shape: collections.Counter = collections.Counter()

WARPS = 32             # the kernel's block: 1024 threads
MAX_CLUSTER = 8        # blocks of a portable cluster: one a heading
MAX_SIDE = 32767       # the gather tables hold int16 cells


def smem_bytes(window_t: int, window_r: int, n: int) -> int:
    """A block's shared memory: per-candidate totals, the warps' prefix
    counts, the extents, the block's minimum, the candidates' coordinates
    and headings, the scan in pixels, the last candidate's hits, the two
    int16 gather tables of the block's headings and the valid flags (the
    formula of ``csrc/scan_match.cu``)."""
    nt, nr = 2 * window_t + 1, 2 * window_r + 1
    headings = -(-nr // min(nr, MAX_CLUSTER))
    return (4 * (3 * nr * nt * nt + WARPS + 6 + 4 * nt + 3 * nr + 3 * n)
            + 4 * headings * nt * n + n)


def launch(metric: torch.Tensor, grid: OccGrid, scan_x: torch.Tensor,
           scan_y: torch.Tensor, valid: torch.Tensor, pose: torch.Tensor,
           step_t: float, step_r: float, window_t: int, window_r: int,
           penalty: float, out: MatchResult) -> None:
    """One raw launch on the current stream into the preallocated ``out``:
    metric (S, S) f32; grid.n_rows/n_cols 0-dim i32 and grid.origin (2,)
    f32, scan_x/scan_y (N,) f32, valid (N,) bool and pose (3,) f32, all
    contiguous on one card. No checks and no count; ``fast_match_cuda`` is
    the checked entry. Allocates and copies nothing, so a CUDA graph can
    capture it."""
    dev = metric.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(metric, grid, scan_x, scan_y, valid, pose, step_t,
                          step_r, window_t, window_r, penalty, out)
    f32 = np.float32
    err = _build.load_kernels().slam_scan_match(
        metric.data_ptr(), metric.shape[-1], grid.n_rows.data_ptr(),
        grid.n_cols.data_ptr(), grid.origin.data_ptr(),
        float(f32(1.0 / grid.pixel)), scan_x.data_ptr(), scan_y.data_ptr(),
        valid.data_ptr(), scan_x.shape[0], pose.data_ptr(),
        float(f32(step_t)), float(f32(step_r)), window_t, window_r,
        float(f32(penalty)), out.pose.data_ptr(),
        out.score.data_ptr(), out.best_count.data_ptr(),
        out.last_hits.data_ptr(), out.last_inb.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "slam_scan_match")


def fast_match_cuda(metric: torch.Tensor, grid: OccGrid,
                    scan_x: torch.Tensor, scan_y: torch.Tensor,
                    valid: torch.Tensor, pose: torch.Tensor, step_t: float,
                    step_r: float, window_t: int = 1, window_r: int = 1,
                    window_penalty_px: float = 1.0) -> MatchResult:
    """``matching.fast_match`` on CUDA tensors as one launch of K3: metric
    (S, S) f32 on the 2^-10 lattice, scan_x, scan_y (N,) f32, valid (N,)
    bool, pose (3,) f32. Raises for anything the kernel does not take; never
    falls back to the plain version."""
    global launches
    n = scan_x.shape[-1]
    if window_t < 0 or window_r < 0:
        raise ValueError(f"windows {window_t}, {window_r} must be >= 0")
    if smem_bytes(window_t, window_r, n) > SMEM_BYTES:
        raise ValueError(f"windows {window_t}, {window_r} at {n} beams do "
                         f"not fit the kernel's shared memory")
    dev = metric.device
    if not metric.is_cuda:
        raise ValueError("fast_match_cuda takes CUDA tensors; CPU tensors "
                         "go through ops.matching.fast_match")
    if metric.dtype != torch.float32 or metric.dim() != 2 \
            or metric.shape[0] != metric.shape[1] \
            or not 1 <= metric.shape[0] <= MAX_SIDE:
        raise ValueError(f"metric must be square f32 (S, S), S <= "
                         f"{MAX_SIDE}, got {metric.dtype} "
                         f"{tuple(metric.shape)}")
    for name, t, dtype, shape in (
            ("scan_x", scan_x, torch.float32, (n,)),
            ("scan_y", scan_y, torch.float32, (n,)),
            ("valid", valid, torch.bool, (n,)),
            ("pose", pose, torch.float32, (3,)),
            ("grid.origin", grid.origin, torch.float32, (2,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("metric", metric), ("scan_x", scan_x),
                    ("scan_y", scan_y), ("valid", valid), ("pose", pose),
                    ("grid.origin", grid.origin)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, metric on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _build.load_kernels()   # built at first use, before anything is allocated
    f32 = dict(dtype=torch.float32, device=dev)
    out = MatchResult(
        pose=torch.empty(3, **f32), score=torch.empty((), **f32),
        best_count=torch.empty((), dtype=torch.int32, device=dev),
        last_hits=torch.empty(n, **f32),
        last_inb=torch.empty(n, dtype=torch.bool, device=dev))
    grid = grid._replace(n_rows=_extent(grid.n_rows, dev),
                         n_cols=_extent(grid.n_cols, dev))
    launch(metric, grid, scan_x, scan_y, valid, pose, step_t, step_r,
           window_t, window_r, window_penalty_px, out)
    launches += 1
    c = (2 * window_r + 1) * (2 * window_t + 1) ** 2
    launches_by_shape[(c, n, metric.shape[-1])] += 1
    return out
