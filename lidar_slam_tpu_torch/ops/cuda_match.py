"""Wrapper of kernel K2, the correlation volume in ``csrc/corr_volume.cu``.

Replaces the TPU kernel ``lidar_slam_tpu/ops/pallas_match.py::
correlate_volume`` (``_corr_kernel``, fed by ``ops/correlative.py::
_volume_pallas``). The TPU correlated a one-hot beam histogram with the whole
field to avoid gathers; on the H100 the direct gather does about 150x less
work (1.3 M gathers against 189 M MACs for the museum particle filter) and
is bound by L2 latency and launch overhead, so the kernel gathers directly:
one block per (64-beam chunk, theta bin), one thread per (dy, dx), one
atomicAdd per thread — exact, since every addend is on the 2^-10 lattice.

The kernel takes a leading batch axis (one launch matches a scan against B
fields, as loop closure does with its candidates); the particle filter's
unbatched call is the case B = 1. Held to the plain
``ops.correlative.score_volume_plain`` with ``torch.equal`` on EDT fields.
"""

from __future__ import annotations

import torch

from lidar_slam_tpu_torch import _build

launches = 0  # kernel launches made through this wrapper since the last reset

MAX_HALF = 15  # W*W threads per block must stay within 1024


def _extent(v, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.int32, device=device)
    if t.shape != () or t.device != device:
        raise ValueError("n_rows/n_cols must be ints or 0-dim int32 tensors "
                         "on the metric's device")
    return t.contiguous()


def score_volume_cuda(metric: torch.Tensor, cx0: torch.Tensor,
                      cy0: torch.Tensor, valid: torch.Tensor,
                      n_rows, n_cols, half: int) -> torch.Tensor:
    """K2 on CUDA tensors: metric (S, S) f32, cx0/cy0 (T, N) i32, valid (N,)
    bool -> scores (T, W, W) f32; or, batched, metric (B, S, S), cx0/cy0
    (B, T, N), valid (B, N) -> scores (B, T, W, W). n_rows/n_cols are ints
    or 0-dim i32 tensors shared by the batch. Raises for anything the
    kernel does not take; never falls back."""
    global launches
    dev = metric.device
    if not metric.is_cuda:
        raise ValueError("score_volume_cuda takes CUDA tensors; CPU tensors "
                         "go through ops.correlative.score_volume_plain")
    batched = metric.dim() == 3
    if metric.dtype != torch.float32 or metric.dim() not in (2, 3) \
            or metric.shape[-1] != metric.shape[-2]:
        raise ValueError(f"metric must be square f32 (S, S) or (B, S, S), "
                         f"got {metric.dtype} {tuple(metric.shape)}")
    lead = tuple(metric.shape[:-2])
    if cx0.dtype != torch.int32 or cy0.dtype != torch.int32 \
            or cx0.dim() != len(lead) + 2 or cx0.shape != cy0.shape \
            or tuple(cx0.shape[:-2]) != lead:
        raise ValueError("cx0/cy0 must be int32 tensors of one shape, (T, N) "
                         "or (B, T, N) with the metric's B")
    if valid.dtype != torch.bool or tuple(valid.shape) != lead + (cx0.shape[-1],):
        raise ValueError("valid must be a bool (N,) or (B, N) tensor")
    if not 0 <= half <= MAX_HALF:
        raise ValueError(f"half {half} outside the kernel's 0..{MAX_HALF}")
    for name, t in (("metric", metric), ("cx0", cx0), ("cy0", cy0),
                    ("valid", valid)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, metric on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_rows_t = _extent(n_rows, dev)
    n_cols_t = _extent(n_cols, dev)
    b = metric.shape[0] if batched else 1
    t_bins, n = cx0.shape[-2:]
    w = 2 * half + 1
    lib = _build.load_kernels()
    scores = torch.empty(lead + (t_bins, w, w), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.slam_corr_volume(
            metric.data_ptr(), metric.shape[-1], cx0.data_ptr(),
            cy0.data_ptr(), valid.data_ptr(), b, t_bins, n,
            n_rows_t.data_ptr(), n_cols_t.data_ptr(), half,
            scores.data_ptr(), stream)
    _build.check(err, "slam_corr_volume")
    launches += 1
    return scores
