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
(kernel K1 on every block), gathered back whole
(``sharded_edt.ReplicatedField``).

The step runs as JAX runs its jitted one, on every mesh shape:
``fastslam.PfStepFn``, one CUDA graph over static buffers with the
collectives captured inside it, so ``run_sharded_pf`` reads nothing on the
host between its first scan and its final read, as ``run_pf``. Every rank
captures the same collectives in the same order and takes the same arm:
the keyframe test is computed from gathered tensors. No collective sits
inside the graph's IF node (the card's NCCL refuses a collective of two or
more ranks in a conditional body): the refresh arm computes this rank's
row block of the field, and the main graph all-gathers the blocks after
the IF node on every scan. ``eager=True`` gives the eager ``pf_step``
loop, the reference the captured step is held to; it gathers the field
only on a keyframe.

Every rank draws the full (P, 3) noise from the shared generator and keeps
its rows, so a sharded run equals the single-process ``run_pf`` bit for
bit, resampling included.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.models import fastslam
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor, as_ranges
from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
from lidar_slam_tpu_torch.parallel import sharded_edt
from lidar_slam_tpu_torch.utils import graphs


def make_sharded_pf_step(cfg: SlamConfig, mesh: mesh_lib.Mesh, edt_fn=None,
                         eager: bool = False):
    """Returns (step, place): ``step``, this rank's particle rows' step, and
    ``place(state)`` cutting a whole state to them. ``step`` is the
    captured ``fastslam.PfStepFn`` (``step(state, ranges, draws=None) ->
    (state, pose as numpy)``, ``advance`` and ``finish``) on every mesh
    shape; with ``eager``, the eager ``pf_step`` (``-> (state, pose
    tensor)``). ``edt_fn(occ, max_dist)`` defaults to the map axis's
    row-block transform (``sharded_edt.ReplicatedField``) when that axis
    has more than one rank, else to ``ops/edt.edt``."""
    if edt_fn is None and mesh.map.size > 1:
        edt_fn = sharded_edt.ReplicatedField(mesh.map)

    def place(state):
        return mesh_lib.shard_particle_state(state, mesh)

    if not eager:
        return fastslam.PfStepFn(cfg, mesh.device_type, rows=mesh.particles,
                                 edt_fn=edt_fn,
                                 axes=(mesh.particles, mesh.map)), place
    angles = angles_tensor(cfg, mesh.device_type)

    def step(state, ranges, draws=None):
        return fastslam.pf_step(state, ranges, cfg, angles, draws=draws,
                                edt_fn=edt_fn, rows=mesh.particles)

    return step, place


def run_sharded_pf(ranges_all: np.ndarray, cfg: SlamConfig,
                   mesh: mesh_lib.Mesh, seed: int = 0, draws=None,
                   edt_fn=None, eager: bool = False
                   ) -> tuple[torch.Tensor, fastslam.ParticleState]:
    """Whole-dataset sharded run on the mesh's device type, every rank of
    the world calling it: scans 2.. through the captured step with no host
    read, the path in a device buffer, one read at the end (``run_pf``'s
    loop, ``graphs.drive``); with ``eager``, the eager step a scan.
    ``draws``: per-step whole-P ``(noise, u0)``, as ``fastslam.run_pf``.
    Returns (path (T, 3), this rank's final state)."""
    step, place = make_sharded_pf_step(cfg, mesh, edt_fn, eager)
    ranges = as_ranges(ranges_all, mesh.device_type)
    state = place(fastslam.init_particles(ranges[0], cfg, seed))

    def inputs_at(t):
        return ranges[t], None if draws is None else draws[t - 1]

    if not eager:
        return graphs.drive(step, state, ranges.shape[0], inputs_at)
    path = torch.zeros((ranges.shape[0], 3), dtype=torch.float32,
                       device=ranges.device)
    for t in range(1, ranges.shape[0]):
        state, path[t] = step(state, *inputs_at(t))
    return path, state


def run_job(ranges_all: np.ndarray, cfg: SlamConfig, n_map_shards: int = 1,
            seed: int = 0, device_type: str = "cuda", eager: bool = False):
    """``run_sharded_pf`` on a new mesh over the whole world: a job for
    ``multihost.launch``. Returns (path, this rank's poses, its logw, the
    particles axis's and the map axis's collectives by kind and shape)."""
    mesh = mesh_lib.make_mesh(n_map_shards=n_map_shards,
                              device_type=device_type)
    path, state = run_sharded_pf(ranges_all, cfg, mesh, seed, eager=eager)
    return (path, state.poses, state.logw,
            dict(mesh.particles.launches_by_shape),
            dict(mesh.map.launches_by_shape))
