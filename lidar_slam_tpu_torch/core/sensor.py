"""Sensor model (counterpart of ``lidar_slam_tpu.core.sensor``).

A scan is a fixed-shape ``(n_beams,)`` family of tensors plus a prefix
validity mask, as in the JAX package: the valid beams are compacted to the
front in beam order (the reference's ``readAScan``, main.c:71-95), because
the map update indexes the compacted scan.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.config import LidarConfig
from lidar_slam_tpu_torch.core.trig32 import sincos32


class Scan(NamedTuple):
    x: torch.Tensor      # (N,) f32, valid-compacted, zero-padded
    y: torch.Tensor      # (N,) f32
    valid: torch.Tensor  # (N,) bool — prefix mask: valid[j] == (j < size)
    size: torch.Tensor   # () i32


def empty_scan(n: int, device) -> Scan:
    """An all-zero scan of ``n`` beams (a static buffer to copy scans into)."""
    return Scan(x=torch.zeros(n, dtype=torch.float32, device=device),
                y=torch.zeros(n, dtype=torch.float32, device=device),
                valid=torch.zeros(n, dtype=torch.bool, device=device),
                size=torch.zeros((), dtype=torch.int32, device=device))


def beam_angles(cfg: LidarConfig) -> np.ndarray:
    """Angle table with the reference's f32 ``angle += increment``
    accumulation (main.c:53-57), kept in numpy."""
    angles = np.empty(cfg.n_beams, np.float32)
    a = np.float32(cfg.angle_min)
    inc = np.float32(cfg.angle_increment)
    for i in range(cfg.n_beams):
        angles[i] = a
        a = np.float32(a + inc)
    return angles


def compact(keep: torch.Tensor, offset: torch.Tensor | int = 0,
            capacity: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Destination slots for an order-preserving compaction.

    Returns ``(pos, in_range)``: kept element ``i`` goes to slot
    ``offset + (number of kept elements before i)``; ``in_range`` is false for
    dropped elements and for slots at or past ``capacity`` (JAX's
    ``mode="drop"``). ``pos`` points dropped elements at ``capacity``, one
    slot past the end, so a scatter into a buffer with one spare slot and a
    slice drops them without a host sync.
    """
    cap = keep.shape[0] if capacity is None else capacity
    pos = offset + torch.cumsum(keep.to(torch.int32), 0) - 1
    in_range = keep & (pos < cap)
    return torch.where(in_range, pos, cap).to(torch.int64), in_range


def scatter_rows(base: torch.Tensor, pos: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``base`` (C, ...) with ``src[i]`` written at row ``pos[i]``; rows with
    ``pos == C`` are dropped (see ``compact``)."""
    ext = torch.cat([base, base.new_zeros((1,) + base.shape[1:])])
    ext[pos] = src
    return ext[:-1]


def read_scan(ranges: torch.Tensor, angles: torch.Tensor,
              cfg: LidarConfig) -> Scan:
    """Gate + convert one scan (``readAScan``). Keeps ``range_min <= r <=
    usable_range``, exactly the JAX package's test; compaction preserves
    beam order.

    Device dispatcher: on CUDA tensors one launch of kernel K5
    (``ops/cuda_scan_intake``), on CPU tensors ``read_scan_plain``. A CUDA
    tensor never reaches the plain version.
    """
    if ranges.is_cuda:
        from lidar_slam_tpu_torch.ops import cuda_scan_intake

        return cuda_scan_intake.read_scan_cuda(
            ranges.to(torch.float32).contiguous(),
            angles.to(torch.float32).contiguous(), cfg)
    return read_scan_plain(ranges, angles, cfg)


def read_scan_plain(ranges: torch.Tensor, angles: torch.Tensor,
                    cfg: LidarConfig) -> Scan:
    """``read_scan`` in plain tensor code: the CPU's path, and what K5 is
    held to with ``torch.equal`` on the card."""
    ranges = ranges.to(torch.float32)
    ok = (ranges >= cfg.range_min) & (ranges <= cfg.usable_range)
    sa, ca = sincos32(angles)
    pos, _ = compact(ok)
    zeros = torch.zeros_like(ranges)
    x = scatter_rows(zeros, pos, ranges * ca)
    y = scatter_rows(zeros, pos, ranges * sa)
    size = ok.sum().to(torch.int32)
    valid = torch.arange(ranges.shape[0], device=ranges.device) < size
    return Scan(x=x, y=y, valid=valid, size=size)


def read_scans(ranges: torch.Tensor, angles: torch.Tensor,
               cfg: LidarConfig) -> Scan:
    """``read_scan`` of every row of ``ranges`` (T, N) at once: a ``Scan``
    whose x, y and valid are (T, N) and size (T,), each row bit for bit the
    per-scan call's (each beam's point is the same product, and the
    compaction runs along the rows)."""
    ranges = ranges.to(torch.float32)
    t, n = ranges.shape
    ok = (ranges >= cfg.range_min) & (ranges <= cfg.usable_range)
    sa, ca = sincos32(angles)
    # row r's slots are r * (n + 1) + 0..n; a dropped beam goes to slot n
    pos = torch.cumsum(ok.to(torch.int32), 1) - 1
    base = torch.arange(t, device=ranges.device)[:, None] * (n + 1)
    dest = (base + torch.where(ok, pos, n)).reshape(-1)

    def place(v):
        flat = torch.zeros(t * (n + 1), dtype=torch.float32,
                           device=ranges.device)
        flat[dest] = v.reshape(-1)
        return flat.view(t, n + 1)[:, :n]

    size = ok.sum(dim=1).to(torch.int32)
    valid = torch.arange(n, device=ranges.device)[None, :] < size[:, None]
    return Scan(x=place(ranges * ca), y=place(ranges * sa), valid=valid,
                size=size)
