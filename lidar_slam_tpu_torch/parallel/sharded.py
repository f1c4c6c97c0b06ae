"""The particle filter sharded over a (particles x map) mesh (counterpart
of ``lidar_slam_tpu.parallel.sharded``).

The JAX package jits ``pf_step`` with sharding constraints and lets GSPMD
place the collectives. Here the step is ``fastslam.pf_step`` itself, given
the mesh's particles ``Axis`` as its ``rows`` hook: each rank propagates,
refines and scores its P/D particles, and all-gathers the per-particle
vectors where the step reduces over particles (the mean pose the volume is
built around, the weights, the ancestors' poses), reducing them with the
single-process code. The point map, the grids and the field are
replicated: every rank builds the same correlation volume (kernel K2)
from the same mean pose. When the map axis has more than one rank, the
keyframe field is the row-block transform of ``sharded_edt`` over it
(kernel K1 on every block), gathered back whole.

Every rank draws the full (P, 3) noise from the shared generator and keeps
its rows, so a sharded run equals the single-process ``run_pf`` bit for
bit, resampling included.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.models import fastslam
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor
from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
from lidar_slam_tpu_torch.parallel import sharded_edt


def make_sharded_pf_step(cfg: SlamConfig, mesh: mesh_lib.Mesh, edt_fn=None):
    """Returns (step, place): ``step(state, ranges, draws=None) -> (state,
    est_pose)`` on this rank's particle rows, and ``place(state)`` cutting
    a whole state to them. ``edt_fn(occ, max_dist)`` defaults to the map
    axis's row-block transform when that axis has more than one rank, else
    to ``ops/edt.edt``."""
    if edt_fn is None and mesh.map.size > 1:
        def edt_fn(occ, max_dist):
            return sharded_edt.edt_replicated(occ, mesh.map, max_dist)

    angles = angles_tensor(cfg, mesh.device_type)

    def step(state, ranges, draws=None):
        return fastslam.pf_step(state, ranges, cfg, angles, draws=draws,
                                edt_fn=edt_fn, rows=mesh.particles)

    def place(state):
        return mesh_lib.shard_particle_state(state, mesh)

    return step, place


def run_sharded_pf(ranges_all: np.ndarray, cfg: SlamConfig,
                   mesh: mesh_lib.Mesh, seed: int = 0, draws=None,
                   edt_fn=None) -> tuple[torch.Tensor, fastslam.ParticleState]:
    """Whole-dataset sharded run on the mesh's device type, every rank of
    the world calling it. ``draws``: per-step whole-P ``(noise, u0)``, as
    ``fastslam.run_pf``. Returns (path (T, 3), this rank's final state)."""
    step, place = make_sharded_pf_step(cfg, mesh, edt_fn)
    ranges = torch.as_tensor(np.asarray(ranges_all, np.float32),
                             device=mesh.device_type)
    state = place(fastslam.init_particles(ranges[0], cfg, seed))
    poses = [torch.zeros(3, dtype=torch.float32, device=ranges.device)]
    for t in range(1, ranges.shape[0]):
        state, pose = step(state, ranges[t],
                           None if draws is None else draws[t - 1])
        poses.append(pose)
    return torch.stack(poses), state


def run_job(ranges_all: np.ndarray, cfg: SlamConfig, n_map_shards: int = 1,
            seed: int = 0, device_type: str = "cuda"):
    """``run_sharded_pf`` on a new mesh over the whole world: a job for
    ``multihost.launch``. Returns (path, this rank's poses, its logw)."""
    mesh = mesh_lib.make_mesh(n_map_shards=n_map_shards,
                              device_type=device_type)
    path, state = run_sharded_pf(ranges_all, cfg, mesh, seed)
    return path, state.poses, state.logw
