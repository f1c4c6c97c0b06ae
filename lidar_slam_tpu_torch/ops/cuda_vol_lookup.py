"""Wrapper of kernel K4, the trilinear volume lookups in
``csrc/vol_lookup.cu``.

Replaces no TPU kernel: ``ops/correlative``'s lookup is plain ``jnp`` code
in the JAX package, which XLA fuses on the TPU. On the card the plain
version is about 209 small kernels a ``lookup_cascade`` call, and a
particle-filter step makes four calls (its particles once, the estimate's
27 candidates three times); K4 is one launch a call, and one launch for the
estimate's three refinement passes: one thread a pose through every level
of the cascade, and for the refinement one block whose thread 0 takes the
first minimum of its candidates. ``csrc/vol_lookup.cu`` has the details.

The result is the plain version's bit for bit: the same float32 operations
in the same order and rounding. ``correlative.lookup_cascade``,
``lookup_avg_distance`` and ``refine_estimate`` call it for CUDA tensors
with no gradient to record. Poses that record a gradient
(``grad_refine_steps > 0``, under ``torch.enable_grad``) keep the plain
version on the card: autograd needs its graph there, and the JAX package
had no kernel here to give a backward. CPU tensors keep the plain version.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from lidar_slam_tpu_torch import _build

# kernel launches made through this wrapper since the last reset; a replay
# of a captured graph adds the launches it holds (``utils/graphs``)
launches = 0
# the same launches keyed by (B, K, T, W, levels, mode): volume rows (1 for
# an unbatched cascade), poses or candidates, theta bins, window, cascade
# levels, and "cascade", "distance" or "refine"
launches_by_shape: collections.Counter = collections.Counter()

MAX_LEVELS = 3         # the cascade depths the presets use: 1-3
MAX_CANDIDATES = 1024  # the refinement's block: a thread a candidate


def _cascade(vols, device: torch.device) -> tuple[int, int, int, int]:
    """Check the cascade's volumes: (B, T, W, half), B 0 where they carry
    no batch axis. Every level has the same shape, float32 scores and
    counts, a float32 base pose and W = 2 half + 1, on ``device``."""
    if not 1 <= len(vols) <= MAX_LEVELS:
        raise ValueError(f"K4 takes 1 to {MAX_LEVELS} cascade levels, got "
                         f"{len(vols)}")
    shape = tuple(vols[0].scores.shape)
    if len(shape) not in (3, 4) or shape[-1] != shape[-2]:
        raise ValueError(f"scores must be (T, W, W) or (B, T, W, W), got "
                         f"{shape}")
    b = shape[0] if len(shape) == 4 else 0
    t, w = shape[-3], shape[-1]
    half = vols[0].half
    if w != 2 * half + 1:
        raise ValueError(f"window {w} is not 2 * half + 1 for half {half}")
    for lvl, vol in enumerate(vols):
        base_shape = (b, 3) if b else (3,)
        for name, x, want in (("scores", vol.scores, shape),
                              ("counts", vol.counts, shape),
                              ("base_pose", vol.base_pose, base_shape)):
            if x.dtype != torch.float32 or tuple(x.shape) != want:
                raise ValueError(f"level {lvl}: {name} must be float32 "
                                 f"{want}, got {x.dtype} {tuple(x.shape)}")
            if x.device != device:
                raise ValueError(f"level {lvl}: {name} is on {x.device}, "
                                 f"the poses on {device}")
        if vol.half != half:
            raise ValueError(f"level {lvl}: half {vol.half}, level 0 {half}")
    return b, t, w, half


def _levels(vols) -> tuple:
    """The launchers' per-level arguments: the scores', counts' and bases'
    pointers and the float32 1/pixel and theta steps, as C arrays. The
    tensors must be contiguous and outlive the launch."""
    def ptrs(ts):
        return (ctypes.c_void_p * MAX_LEVELS)(*(x.data_ptr() for x in ts))

    def f32s(xs):
        return (ctypes.c_float * MAX_LEVELS)(*(float(np.float32(x))
                                               for x in xs))
    return (ptrs(v.scores for v in vols), ptrs(v.counts for v in vols),
            ptrs(v.base_pose for v in vols), f32s(v.ipixel for v in vols),
            f32s(v.theta_step for v in vols))


def _contiguous(vols) -> list:
    return [v._replace(scores=v.scores.contiguous(),
                       counts=v.counts.contiguous(),
                       base_pose=v.base_pose.contiguous()) for v in vols]


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch(vols, poses: torch.Tensor, per_volume: int, dist: torch.Tensor,
           escape: torch.Tensor | None) -> None:
    """One raw launch on the current stream: the cascade ``vols`` (contiguous
    float32 on one card, checked by ``_cascade``), poses f32 (n, 3)
    contiguous, pose i looking up volume row i // per_volume, into the
    preallocated dist f32 (n,) and escape bool (n,) (None: no mask). No
    checks and no count; the ``*_cuda`` functions are the checked entries.
    Allocates and copies nothing, so a CUDA graph can capture it."""
    dev = poses.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(vols, poses, per_volume, dist, escape)
    t, w = vols[0].scores.shape[-3], vols[0].scores.shape[-1]
    err = _build.load_kernels().slam_vol_lookup(
        *_levels(vols), len(vols), t, w, vols[0].half, poses.data_ptr(),
        poses.shape[0], per_volume, dist.data_ptr(),
        None if escape is None else escape.data_ptr(), _stream(dev))
    _build.check(err, "slam_vol_lookup")


def launch_refine(vols, est_pose: torch.Tensor, offs: torch.Tensor,
                  out: torch.Tensor) -> None:
    """One raw launch of the refinement on the current stream: the
    unbatched cascade ``vols``, est_pose f32 (3,), offs f32 (K, 3), all
    contiguous on one card, into the preallocated out f32 (3,). No checks
    and no count; ``refine_estimate_cuda`` is the checked entry."""
    dev = est_pose.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_refine(vols, est_pose, offs, out)
    t, w = vols[0].scores.shape[-3], vols[0].scores.shape[-1]
    err = _build.load_kernels().slam_vol_refine(
        *_levels(vols), len(vols), t, w, vols[0].half, est_pose.data_ptr(),
        offs.data_ptr(), offs.shape[0], out.data_ptr(), _stream(dev))
    _build.check(err, "slam_vol_refine")


def _poses(poses: torch.Tensor) -> None:
    if not poses.is_cuda:
        raise ValueError("K4 takes CUDA tensors; CPU tensors go through "
                         "ops.correlative's plain lookups")
    if poses.dtype != torch.float32 or poses.dim() < 1 \
            or poses.shape[-1] != 3:
        raise ValueError(f"poses must be float32 (..., 3), got "
                         f"{poses.dtype} {tuple(poses.shape)}")


def _lookup(vols, poses: torch.Tensor, mode: str):
    global launches
    _poses(poses)
    b, t, w, _ = _cascade(vols, poses.device)
    lead = tuple(poses.shape[:-1])
    n = poses.numel() // 3
    if b and (len(lead) < 1 or lead[0] != b):
        raise ValueError(f"a batched volume of {b} rows takes poses "
                         f"(B, ..., 3), got {tuple(poses.shape)}")
    dist = torch.empty(lead, dtype=torch.float32, device=poses.device)
    escape = (torch.empty(lead, dtype=torch.bool, device=poses.device)
              if mode == "cascade" else None)
    if n == 0:
        return dist, escape
    _build.load_kernels()   # built at first use, before anything is allocated
    launch(_contiguous(vols), poses.contiguous().view(n, 3),
           n // max(b, 1), dist, escape)
    launches += 1
    launches_by_shape[(max(b, 1), n // max(b, 1), t, w, len(vols), mode)] += 1
    return dist, escape


def lookup_cascade_cuda(vols, poses: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``correlative.lookup_cascade`` on CUDA tensors as one launch of K4:
    the distance and the fine-window escape mask of poses (..., 3) float32,
    or (B, ..., 3) for batched volumes. Raises for anything the kernel does
    not take; never falls back to the plain version."""
    return _lookup(vols, poses, "cascade")


def lookup_avg_distance_cuda(vol, poses: torch.Tensor) -> torch.Tensor:
    """``correlative.lookup_avg_distance`` on CUDA tensors as one launch of
    K4, a cascade of one level with no escape mask."""
    return _lookup([vol], poses, "distance")[0]


def refine_estimate_cuda(vols, est_pose: torch.Tensor, offs: torch.Tensor
                         ) -> torch.Tensor:
    """``correlative.refine_estimate`` on CUDA tensors as one launch of K4:
    ``correlative.REFINE_PASSES`` times, the first minimum of the cascade distance over the
    candidates ``est_pose + offs`` (est_pose (3,), offs (K, 3) float32,
    1 <= K <= 1024) becomes the estimate. Unbatched volumes only."""
    global launches
    _poses(est_pose)
    b, t, w, _ = _cascade(vols, est_pose.device)
    if b:
        raise ValueError("refine_estimate takes unbatched volumes")
    k = offs.shape[0] if offs.dim() == 2 else 0
    if tuple(est_pose.shape) != (3,) or offs.dtype != torch.float32 \
            or tuple(offs.shape) != (k, 3) or not 1 <= k <= MAX_CANDIDATES:
        raise ValueError(f"est_pose (3,) and offs (K, 3) float32 with 1 <= K "
                         f"<= {MAX_CANDIDATES}, got {tuple(est_pose.shape)} "
                         f"and {offs.dtype} {tuple(offs.shape)}")
    if offs.device != est_pose.device:
        raise ValueError(f"offs is on {offs.device}, est_pose on "
                         f"{est_pose.device}")
    _build.load_kernels()
    out = torch.empty(3, dtype=torch.float32, device=est_pose.device)
    launch_refine(_contiguous(vols), est_pose.contiguous(), offs.contiguous(),
                  out)
    launches += 1
    launches_by_shape[(1, k, t, w, len(vols), "refine")] += 1
    return out
