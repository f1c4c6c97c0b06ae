"""Batched scan-to-scan matching (counterpart of
``lidar_slam_tpu.ops.scan_odometry``).

A scan is rastered into a grid centred on its sensor, clamp-EDT'd (kernel K1
on CUDA, batched) and a second scan descends into it from a guess with the
reference's 27-candidate FastMatch walk at halving steps. Pairs are
independent, so a whole batch of them runs at once: ``pairwise_odometry``
matches every consecutive pair of a log, and loop closure re-matches
accepted keyframe pairs on a fine raster with the same descent
(``models/graph_slam._refine_rel_batch``).

The JAX package jits the whole pass and maps a vmapped matcher over padded
chunks with ``lax.map``. Here every scan is read in one batch
(``sensor.read_scans``), the batch is a leading tensor axis, and each chunk
of pairs replays a captured CUDA graph of ``match_batch`` over static
buffers (``PairMatcher``, ``utils/graphs``): one graph for each chunk
width, the full width and the tail, so kernel K1 launches at the eager
shapes, and the graphs are kept for the process as JAX keeps its compiled
pass. Relative poses are in the reference convention (``W_t = W_{t-1} o
delta``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.core import sensor
from lidar_slam_tpu_torch.core.gridmap import OccGrid, roundf_like
from lidar_slam_tpu_torch.device import constant
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.ops import matching
from lidar_slam_tpu_torch.utils import graphs


def _raster_centered(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                     pixel: float, size: int) -> OccGrid:
    """Raster sensor-frame points (..., N) into fixed grids (..., S, S)
    centred on the sensor. Multiplies by the f32 reciprocal of ``pixel``
    as the JAX package does; invalid and out-of-extent points are dropped
    (never wrapped to the opposite edge)."""
    ipixel = float(np.float32(1.0) / np.float32(pixel))
    origin = torch.full((2,), float(np.float32(-0.5 * size * pixel)),
                        dtype=torch.float32, device=x.device)
    col = roundf_like((x - origin[0]) * ipixel).to(torch.int32)
    row = roundf_like((y - origin[1]) * ipixel).to(torch.int32)
    keep = valid & (row >= 0) & (row < size) & (col >= 0) & (col < size)
    lead = x.shape[:-1]
    nb = int(np.prod(lead, dtype=np.int64))
    grid_ix = torch.arange(nb, device=x.device).view(lead + (1,))
    flat = torch.where(keep, (grid_ix * size + row) * size + col,
                       nb * size * size)
    occ = torch.zeros(nb * size * size + 1, dtype=torch.bool, device=x.device)
    occ.index_fill_(0, flat.reshape(-1).to(torch.int64), True)
    n = constant(size, x.device, torch.int32)
    return OccGrid(occ=occ[:-1].view(lead + (size, size)), n_rows=n,
                   n_cols=n, origin=origin, pixel=pixel)


def _descend(metric: torch.Tensor, grid: OccGrid, x: torch.Tensor,
             y: torch.Tensor, valid: torch.Tensor, pose: torch.Tensor,
             iters: int, step_t0: float, step_r0: float) -> torch.Tensor:
    """``iters`` FastMatch calls (window 1) with halving steps, batched:
    metric (B, S, S) on one grid geometry, scans (B, N), poses (B, 3).
    Each call moves to the first minimum of its 27 candidates' summed
    field, as ``matching.fast_match(...).pose`` does."""
    rows = torch.arange(metric.shape[0], device=metric.device)
    st, sr = step_t0, step_r0
    for _ in range(iters):
        cands = matching.candidate_grid_ref(pose, st, sr)     # (B, 27, 3)
        scores, _, _ = matching.score_candidates(metric, grid, x, y, valid,
                                                 cands)
        pose = cands[rows, torch.argmin(scores, dim=-1)]     # first minimum
        st, sr = st * 0.5, sr * 0.5
    return pose


def match_batch(x0: torch.Tensor, y0: torch.Tensor, v0: torch.Tensor,
                x1: torch.Tensor, y1: torch.Tensor, v1: torch.Tensor,
                guesses: torch.Tensor, *, max_range: float, pixel: float,
                size: int, iters: int, step_t0: float, step_r0: float
                ) -> torch.Tensor:
    """Relative poses (B, 3) of scans 1 in the frames of scans 0 (all
    (B, N), sensor frame): points beyond ``max_range`` are gated, scans 0
    rastered and EDT'd in one batch, scans 1 descended from ``guesses``."""
    mr2 = float(np.float32(max_range * max_range))
    a_ok = v0 & (x0 * x0 + y0 * y0 <= mr2)
    b_ok = v1 & (x1 * x1 + y1 * y1 <= mr2)
    grid = _raster_centered(x0, y0, a_ok, pixel, size)
    metric = edt_ops.edt(grid.occ)
    return _descend(metric, grid, x1, y1, b_ok, guesses, iters, step_t0,
                    step_r0)


class _Pairs(NamedTuple):
    """One chunk width's static buffers: scans 0 and 1 of B pairs, (B, N)
    each, and their deltas (B, 3)."""
    x0: torch.Tensor
    y0: torch.Tensor
    v0: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    v1: torch.Tensor
    out: torch.Tensor


class PairMatcher:
    """``matcher(x, y, valid) -> (T-1, 3)``: ``match_batch`` of every
    consecutive pair of T read scans ((T, N) each), ``chunk`` pairs at a
    time, each pair descending from identity; ``match_batch``'s keywords
    are fixed at construction. Each chunk is copied into the static
    buffers of its width and replays that width's captured graph
    (``utils/graphs``; on the CPU the same body runs uncaptured), so a log
    of any length uses two graphs, the full width and the tail's."""

    def __init__(self, device: torch.device, chunk: int, **match_kw):
        self.chunk, self.match_kw = chunk, match_kw
        self.graphs = graphs.Graphs(device)
        self.bufs: dict[int, _Pairs] = {}

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
        n_pairs = x.shape[0] - 1
        out = torch.zeros((max(n_pairs, 0), 3), dtype=torch.float32,
                          device=x.device)
        for a in range(0, n_pairs, self.chunk):
            b = min(a + self.chunk, n_pairs)
            bufs = self._bufs(b - a, x.shape[1])
            for buf, src in zip(bufs, (x[a:b], y[a:b], valid[a:b],
                                       x[a + 1:b + 1], y[a + 1:b + 1],
                                       valid[a + 1:b + 1])):
                buf.copy_(src)
            self.graphs.run(b - a, self._body, bufs)
            out[a:b] = bufs.out
        return out

    def _bufs(self, width: int, n: int) -> _Pairs:
        if width not in self.bufs:
            dev = self.graphs.device

            def zeros(dtype):
                return torch.zeros((width, n), dtype=dtype, device=dev)

            f32 = torch.float32
            self.bufs[width] = _Pairs(
                zeros(f32), zeros(f32), zeros(torch.bool), zeros(f32),
                zeros(f32), zeros(torch.bool),
                torch.zeros((width, 3), dtype=f32, device=dev))
        return self.bufs[width]

    def _body(self, b: _Pairs) -> None:
        guesses = torch.zeros_like(b.out)
        b.out.copy_(match_batch(b.x0, b.y0, b.v0, b.x1, b.y1, b.v1, guesses,
                                **self.match_kw))


@functools.lru_cache(maxsize=None)
def pair_matcher(device: torch.device, chunk: int, max_range: float,
                 pixel: float, size: int, iters: int, step_t0: float,
                 step_r0: float) -> PairMatcher:
    """The process's ``PairMatcher`` for these settings on ``device``: its
    graphs are captured once and replayed by every later log."""
    return PairMatcher(device, chunk, max_range=max_range, pixel=pixel,
                       size=size, iters=iters, step_t0=step_t0,
                       step_r0=step_r0)


def pairwise_odometry(ranges_all: torch.Tensor, angles: torch.Tensor,
                      lidar_cfg, *, max_range: float = 10.0,
                      pixel: float = 0.05, size: int = 448, iters: int = 7,
                      step_t0: float = 0.03, step_r0: float = 0.03,
                      chunk: int = 50) -> torch.Tensor:
    """Relative poses for all consecutive pairs of ``ranges_all`` (T, N).

    Returns (T-1, 3): row t-1 is the delta from scan t-1 to scan t in the
    reference convention, each pair descending from identity. Every scan is
    read in one batch; pairs run ``chunk`` at a time (``PairMatcher``),
    which bounds memory at chunk * size^2 cells."""
    if max_range >= 0.5 * size * pixel:
        raise ValueError(
            f"max_range={max_range} m reaches beyond the centered raster's "
            f"half-extent {0.5 * size * pixel:.2f} m (size={size}, "
            f"pixel={pixel}); widen the grid or lower max_range")
    scans = sensor.read_scans(ranges_all, angles, lidar_cfg)
    matcher = pair_matcher(ranges_all.device, chunk, max_range, pixel, size,
                           iters, step_t0, step_r0)
    return matcher(scans.x, scans.y, scans.valid)


def reach_clip_fraction(deltas: np.ndarray, step_t0: float = 0.03,
                        step_r0: float = 0.03) -> float:
    """Fraction of pair deltas on the descent's reach boundary (>= 95% of
    its ~+-2*step0 per axis): the motion probably exceeded the envelope and
    was clipped. Host-side diagnostic."""
    deltas = np.asarray(deltas)
    if deltas.size == 0:
        return 0.0
    near_t = np.abs(deltas[:, :2]).max(axis=1) >= 1.9 * step_t0
    near_r = np.abs(deltas[:, 2]) >= 1.9 * step_r0
    return float(np.mean(near_t | near_r))
