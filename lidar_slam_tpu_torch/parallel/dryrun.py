"""Multi-rank dry run of the four sharded subsystems (counterpart of
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` runs inside every rank of a world of n: one PF
step on a (particles x map) mesh, with a map axis of 2 when n is even and
at least 4, so both axes carry work; one sharded BA iteration whose error
must fall; the row-block EDT over n ranks with the JAX package's point
checks; and two sharded EKF steps. Tiny shapes throughout: 8 particles a
rank, a small correlation volume. It runs on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu_torch.device import resolve_device


def _tiny_cfg(n_particles: int, **particle_overrides):
    """DEFAULT_CONFIG with a particle config of its own."""
    return dataclasses.replace(
        DEFAULT_CONFIG,
        particles=ParticleConfig(n_particles=n_particles,
                                 **particle_overrides))


def _ranges(n_scans: int = 2, seed: int = 0) -> np.ndarray:
    from lidar_slam_tpu_torch.io import simulate

    ranges, _ = simulate.generate_dataset(n_scans=n_scans, seed=seed)
    return ranges


def tiny_ba_problem(device: str | torch.device = "cuda"):
    """Small synthetic bundle-adjustment problem (6 poses, 4 landmarks)."""
    from lidar_slam_tpu_torch.core import se2
    from lidar_slam_tpu_torch.models.ba import BAProblem

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    k, l, ecap, fcap = 6, 4, 8, 32
    gt_poses = np.stack([np.linspace(0, 5, k),
                         0.2 * np.sin(np.linspace(0, 2, k)),
                         0.05 * np.cos(np.linspace(0, 2, k))],
                        1).astype(np.float32)
    gt_lms = np.stack([np.linspace(1, 4, l),
                       np.tile([1.5, -1.5], l // 2)], 1).astype(np.float32)
    obs_i, obs_j, obs_z = [], [], []
    for i in range(k):
        for j in range(l):
            dx, dy = gt_lms[j] - gt_poses[i, :2]
            obs_i.append(i)
            obs_j.append(j)
            obs_z.append([float(np.hypot(dx, dy)),
                          float(np.arctan2(dy, dx) + gt_poses[i, 2])])
    f = len(obs_z)
    odo_z = se2.between(torch.as_tensor(gt_poses[:-1]),
                        torch.as_tensor(gt_poses[1:])).numpy()
    init = gt_poses + rng.normal(0, 0.05, gt_poses.shape).astype(np.float32)
    init[0] = gt_poses[0]
    lms = gt_lms + rng.normal(0, 0.2, gt_lms.shape).astype(np.float32)

    def slots(values, cap, width=None, dtype=np.float32):
        out = np.zeros((cap,) if width is None else (cap, width), dtype)
        out[:len(values)] = values
        return out

    fields = dict(
        poses=init, landmarks=lms,
        pose_active=np.ones(k, bool), lm_active=np.ones(l, bool),
        odo_i=slots(np.arange(k - 1), ecap, dtype=np.int32),
        odo_j=slots(np.arange(1, k), ecap, dtype=np.int32),
        odo_z=slots(odo_z, ecap, 3), odo_w=np.full((ecap, 3), 10.0,
                                                   np.float32),
        odo_active=np.arange(ecap) < k - 1,
        obs_i=slots(obs_i, fcap, dtype=np.int32),
        obs_j=slots(obs_j, fcap, dtype=np.int32),
        obs_z=slots(np.asarray(obs_z, np.float32), fcap, 2),
        obs_w=np.tile(np.asarray([100.0, 400.0], np.float32), (fcap, 1)),
        obs_active=np.arange(fcap) < f)
    return BAProblem(**{n: torch.as_tensor(v, device=device)
                        for n, v in fields.items()})


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> dict:
    """The dry run, in every rank of a world of ``n_devices``; prints what
    each subsystem did on rank 0 and returns it."""
    from lidar_slam_tpu_torch.models import ba, ekf_slam, fastslam
    from lidar_slam_tpu_torch.parallel import (mesh as mesh_lib, sharded,
                                               sharded_ba, sharded_ekf,
                                               sharded_edt)

    device_type = mesh_lib.device_type_of(device_type)
    rank, world = mesh_lib.world()
    if world != n_devices:
        raise ValueError(f"need a world of {n_devices}, have {world}")
    say = print if rank == 0 else (lambda *a, **k: None)
    out = {}

    # a (particles x map) PF step: 8 particles a rank, a small volume
    n_map = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = mesh_lib.make_mesh(n_particles_shards=n_devices // n_map,
                              n_map_shards=n_map, device_type=device_type)
    cfg = _tiny_cfg(8 * n_devices, vol_theta_bins=5, vol_half=4)
    ranges = torch.as_tensor(_ranges(2), device=device_type)
    step, place = sharded.make_sharded_pf_step(cfg, mesh)
    state = place(fastslam.init_particles(ranges[0], cfg))
    state, est = step(state, ranges[1])
    out["pf_est"] = est.cpu().numpy()
    say(f"dryrun_multichip({n_devices}): PF step ok on a "
        f"{n_devices // n_map}x{n_map} (particles x map) mesh, est pose = "
        f"{out['pf_est']}")

    # one sharded Schur BA iteration over every rank
    prob = tiny_ba_problem(device_type)
    res = sharded_ba.optimize_ba_sharded(
        prob, sharded_ba.make_graph_mesh(device_type), iters=1)
    e0, e1 = float(ba.ba_error(prob)), float(ba.ba_error(res))
    if not (np.isfinite(e1) and e1 < e0):
        raise AssertionError(f"sharded BA error did not fall: {e0} -> {e1}")
    out["ba_error"] = (e0, e1)
    say(f"dryrun_multichip({n_devices}): sharded BA ok, error {e0:.4f} -> "
        f"{e1:.4f}")

    # the row-block EDT over every rank, K1 on each block on a card
    axis = mesh_lib.make_axis("map", device_type)
    size = 16 * n_devices
    occ = torch.zeros((size, size), dtype=torch.bool, device=device_type)
    occ[size // 2, size // 2] = True
    dist = axis.gather(sharded_edt.edt_sharded(axis.rows(occ), axis))
    dist = dist.cpu().numpy()
    if dist[size // 2, size // 2] != 0.0 or abs(
            dist[size // 2 + 3, size // 2 + 4] - 5.0) >= 1e-5:
        raise AssertionError("sharded EDT point checks failed")
    out["edt_shape"] = dist.shape
    say(f"dryrun_multichip({n_devices}): sharded EDT ok ({size}x{size} over "
        f"{n_devices} row blocks)")

    # two ML-association steps of the EKF bank sharded over the particles
    ecfg = ekf_slam.EkfSlamConfig(n_particles=8 * n_devices, max_landmarks=8,
                                  use_scan_odometry=True)
    emesh = mesh_lib.make_mesh(n_particles_shards=n_devices, n_map_shards=1,
                               device_type=device_type)
    estep, eplace = sharded_ekf.make_sharded_ekf_step(ecfg, emesh)
    estate = eplace(ekf_slam.init_ekf_slam(ecfg, 0, device_type))
    obs = torch.tensor([[2.0, 0.3], [3.0, -0.7], [1.5, 1.1], [4.0, 0.0]],
                       device=device_type)
    valid = torch.tensor([True, True, True, False], device=device_type)
    odo = torch.tensor([0.05, 0.0, 0.01], device=device_type)
    for _ in range(2):
        estate, eest = estep(estate, obs, valid, odo)
    out["ekf_est"] = eest.cpu().numpy()
    if not np.isfinite(out["ekf_est"]).all():
        raise AssertionError("sharded EKF estimate is not finite")
    say(f"dryrun_multichip({n_devices}): sharded EKF bank ok "
        f"(P={8 * n_devices} over {n_devices} particle shards, est pose = "
        f"{out['ekf_est']})")
    return out
