"""Wrapper of kernel K5, the scan intake in ``csrc/scan_intake.cu``.

Replaces no TPU kernel: ``core/sensor.read_scan`` is plain tensor code in
both packages, which XLA fuses on the TPU. On the card the plain version is
about 70 small PyTorch kernels a scan, 46 of them ``trig32.sincos32`` of the
constant beam-angle table, and every captured step runs it once a scan; K5
is one launch: one block whose threads each gate a contiguous run of beams,
a block-wide prefix count for the compaction, and each kept beam's sin, cos
and point written to its slot. ``csrc/scan_intake.cu`` has the details.

The result is ``read_scan_plain``'s bit for bit: the same float32 gate,
sincos32 and products, and the same order-preserving compaction.
``sensor.read_scan`` calls it for CUDA tensors; the CPU keeps the plain
version.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from lidar_slam_tpu_torch import _build
from lidar_slam_tpu_torch.config import LidarConfig
from lidar_slam_tpu_torch.core.sensor import Scan

# kernel launches made through this wrapper since the last reset; a replay
# of a captured graph adds the launches it holds (``utils/graphs``)
launches = 0
# the same launches keyed by (N,): the beams of the scan
launches_by_shape: collections.Counter = collections.Counter()

THREADS = 1024              # the kernel's one block
PER_THREAD = 8              # beams a thread holds in registers, at most
MAX_BEAMS = THREADS * PER_THREAD


def gate_bounds(cfg: LidarConfig) -> tuple[float, float]:
    """The gate's float32 bounds: torch compares a float32 tensor with a
    Python float in float32."""
    return (float(np.float32(cfg.range_min)),
            float(np.float32(cfg.usable_range)))


def launch(ranges: torch.Tensor, angles: torch.Tensor, cfg: LidarConfig,
           out: Scan) -> None:
    """One raw launch on the current stream into the preallocated ``out``:
    ranges, angles (N,) f32 contiguous on one card; out.x, out.y (N,) f32,
    out.valid (N,) bool, out.size () i32. No checks and no count;
    ``read_scan_cuda`` is the checked entry. Allocates and copies nothing,
    so a CUDA graph can capture it."""
    dev = ranges.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(ranges, angles, cfg, out)
    err = _build.load_kernels().slam_scan_intake(
        ranges.data_ptr(), angles.data_ptr(), ranges.shape[0],
        *gate_bounds(cfg), out.x.data_ptr(), out.y.data_ptr(),
        out.valid.data_ptr(), out.size.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "slam_scan_intake")


def read_scan_cuda(ranges: torch.Tensor, angles: torch.Tensor,
                   cfg: LidarConfig) -> Scan:
    """``sensor.read_scan`` on CUDA tensors as one launch of K5: ranges and
    angles (N,) f32, 1 <= N <= ``MAX_BEAMS``. Raises for anything the
    kernel does not take; never falls back to the plain version."""
    global launches
    if ranges.dim() != 1 or not 1 <= ranges.shape[0] <= MAX_BEAMS:
        raise ValueError(f"ranges must be (N,) with 1 <= N <= {MAX_BEAMS} "
                         f"(the kernel's one block), got "
                         f"{tuple(ranges.shape)}")
    n = ranges.shape[0]
    dev = ranges.device
    if not ranges.is_cuda:
        raise ValueError("read_scan_cuda takes CUDA tensors; CPU tensors "
                         "go through core.sensor.read_scan")
    for name, t in (("ranges", ranges), ("angles", angles)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, ranges on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _build.load_kernels()   # built at first use, before anything is allocated
    f32 = dict(dtype=torch.float32, device=dev)
    out = Scan(x=torch.empty(n, **f32), y=torch.empty(n, **f32),
               valid=torch.empty(n, dtype=torch.bool, device=dev),
               size=torch.empty((), dtype=torch.int32, device=dev))
    launch(ranges, angles, cfg, out)
    launches += 1
    launches_by_shape[(n,)] += 1
    return out
