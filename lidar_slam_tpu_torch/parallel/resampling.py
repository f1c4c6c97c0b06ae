"""Distributed systematic resampling (counterpart of
``lidar_slam_tpu.parallel.resampling``).

Each rank holds P/D particles. The global inverse-CDF lookup needs every
weight, and the payload of an ancestor may sit on another rank, so the
weights and the poses are all-gathered: particle state is tiny (16 bytes a
particle), far below a step's other traffic.

The JAX package normalises with a ``pmax``/``psum`` and builds the global
CDF from a prefix of the shard totals, which rounds in another order than
one device's cumsum. Here every rank resamples the gathered weights with
``fastslam.systematic_resample`` itself (float64 softmax and cumsum,
rounded once) and keeps its own teeth of the comb ``u0 + i/P``: the
indices and payloads equal the single-rank result bit for bit.
"""

from __future__ import annotations

import torch

from lidar_slam_tpu_torch.models.fastslam import systematic_resample
from lidar_slam_tpu_torch.parallel.mesh import Axis


def distributed_systematic_resample(axis: Axis, logw: torch.Tensor,
                                    poses: torch.Tensor,
                                    prev_poses: torch.Tensor,
                                    u0: torch.Tensor):
    """Resample particles sharded in equal row blocks over ``axis``.
    ``logw`` (P/D,), ``poses``/``prev_poses`` (P/D, 3) are this rank's rows;
    ``u0`` in [0, 1/P) is the same on every rank. Returns this rank's rows
    of (new poses, new previous poses, ancestor indices into all P)."""
    idx = axis.rows(systematic_resample(u0, axis.gather(logw)))
    return axis.gather(poses)[idx], axis.gather(prev_poses)[idx], idx
