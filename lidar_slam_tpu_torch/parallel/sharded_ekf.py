"""The EKF-FastSLAM bank sharded over the particles axis (counterpart of
``lidar_slam_tpu.parallel.sharded_ekf``).

Every per-particle leaf of ``EkfSlamState`` (poses, previous poses,
weights, landmark means, covariances and seen masks) is cut into equal row
blocks; the generator is replicated. The per-(particle, landmark) EKF
algebra and the Gauss-Newton proposal refinement run on a rank's own
rows. The step is ``ekf_slam_step_ml`` itself with the particles ``Axis``
as its ``rows`` hook: at its cross-particle points (the weights' max,
resampling with the ancestors' banks, the weighted mean) it all-gathers
the vectors (at most 1024 x 64 x 7 values, about 1.8 MB for the banks)
and reduces them with the single-process code, so a sharded step equals
the unsharded one bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_tpu_torch.models import ekf_slam
from lidar_slam_tpu_torch.models.ekf_slam import (EkfSlamConfig,
                                                  EkfSlamState,
                                                  ekf_slam_step_ml)
from lidar_slam_tpu_torch.parallel import mesh as mesh_lib


def place_state(state: EkfSlamState, mesh: mesh_lib.Mesh) -> EkfSlamState:
    """This rank's rows of every per-particle leaf."""
    return mesh_lib.shard_particle_state(state, mesh,
                                         ekf_slam.PARTICLE_LEAVES)


def make_sharded_ekf_step(ekf_cfg: EkfSlamConfig, mesh: mesh_lib.Mesh):
    """Returns (step, place): ``step(state, obs, obs_valid, odo,
    draws=None, n_det=None) -> (state, est_pose)``, the ML-association
    step on this rank's rows, and ``place(state)``."""

    def step(state, obs, obs_valid, odo, draws=None, n_det=None):
        return ekf_slam_step_ml(state, obs, obs_valid, ekf_cfg, odo=odo,
                                draws=draws, n_det=n_det,
                                rows=mesh.particles)

    def place(state):
        return place_state(state, mesh)

    return step, place


def run_sharded_ml(obs_all, valid_all, odo_all, cfg: EkfSlamConfig,
                   mesh: mesh_lib.Mesh, seed: int = 0, draws=None,
                   counts=None) -> tuple[torch.Tensor, EkfSlamState]:
    """``ekf_slam.run_ml`` with the bank sharded over the mesh's particles
    axis, on the mesh's device type. Returns (path, this rank's state)."""
    return ekf_slam.run_ml(obs_all, valid_all, odo_all, cfg, seed,
                           mesh.device_type, draws, counts,
                           rows=mesh.particles)


def steps_job(cfg: EkfSlamConfig, obs: np.ndarray, valid: np.ndarray,
              odo: np.ndarray, n_steps: int, seed: int = 0,
              device_type: str = "cuda"):
    """``n_steps`` sharded steps on the same detections from
    ``init_ekf_slam(cfg, seed)`` on a new mesh over the whole world: a job
    for ``multihost.launch``. Returns (the estimates, this rank's state)."""
    mesh = mesh_lib.make_mesh(n_map_shards=1, device_type=device_type)
    step, place = make_sharded_ekf_step(cfg, mesh)
    state = place(ekf_slam.init_ekf_slam(cfg, seed, device_type))
    obs, valid, odo = (torch.as_tensor(a, device=device_type)
                       for a in (obs, valid, odo))
    ests = []
    for _ in range(n_steps):
        state, est = step(state, obs, valid, odo)
        ests.append(est)
    return torch.stack(ests), state._replace(rng=None)
