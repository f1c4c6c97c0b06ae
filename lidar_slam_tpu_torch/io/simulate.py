"""Synthetic lidar datasets, in numpy (counterpart of the scan synthesizer
of ``lidar_slam_tpu.io.simulate``): the museum, loop, corridor and
building tours, the known-association landmark datasets of the EKF
family, and a landmark bundle-adjustment problem on the museum tour.

The JAX package's synthesizer is numpy too, but it cannot be imported
without JAX: ``lidar_slam_tpu/io/__init__.py`` imports ``simulate``, which
imports ``core.sensor``, whose package ``__init__`` loads ``gridmap``,
``se2`` and ``sensor`` — all on ``jax.numpy``. The machine with the card has
no JAX, so the port carries the same code and produces byte-identical
arrays (pinned by ``tests/test_torch_simulate.py``).

Sensor geometry as the reference (main.c:45-58): 1079 beams, angle_min
-2.351831, increment 0.004363 rad, 10 Hz. Poses use the reference convention ``w = R(-theta) p + t``, so a beam
at sensor angle a leaves the robot at world angle ``a - theta``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from lidar_slam_tpu_torch.config import LidarConfig
from lidar_slam_tpu_torch.core.sensor import beam_angles


class World(NamedTuple):
    segments: np.ndarray  # (S, 4) — x1, y1, x2, y2


def _box(x0, y0, x1, y1):
    return [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1), (x0, y1, x0, y0)]


def museum_world() -> World:
    """A 20x15 m three-room floor plan with door gaps and pillars."""
    segs: list[tuple[float, float, float, float]] = []
    segs += _box(0.0, 0.0, 20.0, 15.0)                       # outer shell
    segs += [(8.0, 0.0, 8.0, 6.0), (8.0, 8.0, 8.0, 15.0)]    # wall A, door y 6..8
    segs += [(8.0, 7.5, 13.0, 7.5), (15.0, 7.5, 20.0, 7.5)]  # wall B, door x 13..15
    for cx, cy in [(4.0, 7.5), (12.0, 11.5), (16.5, 3.5), (11.5, 2.5)]:
        s = 0.25
        segs += _box(cx - s, cy - s, cx + s, cy + s)         # pillars
    return World(segments=np.asarray(segs, np.float64))


DEFAULT_WAYPOINTS = np.asarray([
    (3.0, 3.0), (3.0, 12.0), (5.5, 12.5), (6.0, 5.0), (7.0, 6.9),
    (9.5, 7.0), (11.5, 5.0), (13.0, 2.5), (17.0, 2.0), (18.0, 5.5),
    (14.5, 6.2), (14.0, 8.5), (16.5, 9.5), (17.5, 12.5), (13.0, 13.0),
    (10.0, 11.5), (9.2, 9.0), (10.5, 8.2), (13.5, 9.0),
], np.float64)


def smooth_trajectory(waypoints: np.ndarray, speed: float = 0.3,
                      rate_hz: float = 10.0, smooth_m: float = 2.0,
                      heading_smooth: int = 51) -> np.ndarray:
    """Arc-length-resampled, corner-rounded path -> (T, 3) poses in the
    reference convention; the per-step displacement stays below the coarse
    matcher step (5 cm)."""
    pts = []
    for a, b in zip(waypoints[:-1], waypoints[1:]):
        n = max(2, int(np.linalg.norm(b - a) / 0.01))
        t = np.linspace(0.0, 1.0, n, endpoint=False)[:, None]
        pts.append(a[None] * (1 - t) + b[None] * t)
    dense = np.concatenate(pts + [waypoints[-1:]], axis=0)

    win = max(1, int(smooth_m / 0.01))
    kernel = np.ones(win) / win
    sm = np.stack([np.convolve(dense[:, i], kernel, mode="valid") for i in range(2)], 1)

    seglen = np.linalg.norm(np.diff(sm, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seglen)])
    step = speed / rate_hz
    stations = np.arange(0.0, s[-1] - 1e-6, step)
    x = np.interp(stations, s, sm[:, 0])
    y = np.interp(stations, s, sm[:, 1])

    heading = np.arctan2(np.gradient(y), np.gradient(x))
    heading = np.unwrap(heading)
    # smoothed twice: the matcher corrects at most coarse_r + fine_r per step
    # beyond the constant-velocity prediction
    hw = heading_smooth
    hk = np.ones(hw) / hw
    for _ in range(2):
        heading = np.convolve(np.pad(heading, hw // 2, mode="edge"), hk,
                              mode="valid")[: len(x)]
    theta = -heading  # reference convention: world angle = sensor angle - theta
    return np.stack([x, y, theta], axis=1)


def raycast(world: World, pose: np.ndarray, angles: np.ndarray,
            max_range: float = 60.0) -> np.ndarray:
    """Cast all beams from one pose; returns ranges (N,), 0 where no hit."""
    ox, oy, theta = pose
    ang = angles.astype(np.float64) - theta
    dx, dy = np.cos(ang), np.sin(ang)                       # (N,)
    x1, y1, x2, y2 = world.segments.T                        # (S,)
    ex, ey = x2 - x1, y2 - y1
    # o + t d = p1 + u e ; solve per (beam, segment)
    denom = dx[:, None] * ey[None, :] - dy[:, None] * ex[None, :]  # (N, S)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_x = x1[None, :] - ox
        rel_y = y1[None, :] - oy
        t = (rel_x * ey[None, :] - rel_y * ex[None, :]) / denom
        u = (rel_x * dy[:, None] - rel_y * dx[:, None]) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-9) & (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    r = np.min(t, axis=1)
    return np.where(np.isfinite(r) & (r <= max_range), r, 0.0)


def corridor_world() -> World:
    """A 40x8 m office corridor with side rooms (weak longitudinal
    constraint along the straight walls)."""
    segs: list[tuple[float, float, float, float]] = []
    segs += _box(0.0, 0.0, 40.0, 8.0)                          # shell
    # corridor walls at y=3 and y=5 with door gaps every ~8 m
    for x0 in (0.0, 10.0, 20.0, 30.0):
        segs += [(x0 + 2.0, 3.0, x0 + 10.0, 3.0)]
        segs += [(x0, 5.0, x0 + 8.0, 5.0)]
    for x in (10.0, 20.0, 30.0):                               # room dividers
        segs += [(x, 0.0, x, 3.0), (x, 5.0, x, 8.0)]
    for cx, cy in [(5.0, 1.0), (15.0, 6.8), (25.0, 1.2), (33.0, 6.5)]:
        segs += _box(cx, cy - 0.3, cx + 1.2, cy + 0.3)         # cabinets
    return World(segments=np.asarray(segs, np.float64))


# Out-and-back along the corridor: the return leg revisits outbound keyframes.
CORRIDOR_WAYPOINTS = np.asarray([
    (2.0, 4.0), (12.0, 4.1), (22.0, 3.9), (27.5, 4.0), (28.0, 4.2),
    (24.0, 4.1), (14.0, 4.0), (6.0, 4.1), (2.5, 4.0),
], np.float64)


# A closed loop in the museum's left room that revisits the start.
LOOP_WAYPOINTS = np.asarray([
    (3.0, 3.0), (2.8, 8.0), (3.0, 12.0), (5.5, 12.5), (6.5, 9.0),
    (6.2, 5.0), (4.8, 3.2), (3.2, 3.2), (2.9, 7.0), (3.0, 10.0),
], np.float64)


def building_world() -> World:
    """A 60x45 m multi-hall building: a 60 m central corridor, four flanking
    halls with pillars, corridor clutter and exhibit stands. Pair it with
    ``config.BUILDING_CONFIG`` (51.2 m rasters)."""
    segs: list[tuple[float, float, float, float]] = []
    segs += _box(0.0, 0.0, 60.0, 45.0)                       # outer shell
    # central corridor walls (y=19.5 and y=25.5) with hall doors
    for x0, x1 in [(0.0, 10.0), (14.0, 44.0), (48.0, 60.0)]:
        segs += [(x0, 19.5, x1, 19.5)]
    for x0, x1 in [(0.0, 16.0), (20.0, 40.0), (44.0, 60.0)]:
        segs += [(x0, 25.5, x1, 25.5)]
    # hall dividers at x=30 with 4 m doors
    segs += [(30.0, 0.0, 30.0, 8.0), (30.0, 12.0, 30.0, 19.5)]
    segs += [(30.0, 25.5, 30.0, 33.0), (30.0, 37.0, 30.0, 45.0)]
    for cx in (8.0, 16.0, 24.0, 38.0, 46.0, 54.0):           # pillars
        for cy in (6.0, 13.0, 32.0, 39.0):
            s = 0.3
            segs += _box(cx - s, cy - s, cx + s, cy + s)
    # corridor clutter breaking the longitudinal ambiguity
    for cx, cy in [(6.0, 20.0), (18.0, 24.8), (26.0, 20.1), (36.0, 24.9),
                   (50.0, 20.2), (56.0, 24.7)]:
        segs += _box(cx, cy - 0.25, cx + 1.5, cy + 0.25)
    # exhibit stands inside the visited halls
    for cx, cy in [(10.0, 9.5), (20.0, 4.0), (14.0, 16.0), (42.0, 9.0),
                   (52.0, 15.0), (48.0, 4.5)]:
        segs += _box(cx - 0.6, cy - 0.4, cx + 0.6, cy + 0.4)
    return World(segments=np.asarray(segs, np.float64))


# Building tour: loop hall A, corridor east, dip into hall B, corridor back
# west (the revisit from about scan 2500), re-enter hall A.
BUILDING_WAYPOINTS = np.asarray([
    (6.0, 6.0), (6.0, 14.0), (12.0, 16.0), (16.0, 9.5), (11.0, 4.5),
    (7.0, 6.0),                                                  # hall A loop
    (11.5, 13.0), (12.0, 21.5), (24.0, 22.5), (36.0, 22.4), (45.5, 22.2),
    (47.5, 16.0), (52.0, 13.0), (53.5, 17.0), (49.0, 20.0),      # hall B dip
    (44.0, 22.6), (32.0, 22.4), (20.0, 22.6), (13.0, 22.3),      # corridor west
    (11.5, 15.5), (8.5, 10.0), (6.5, 7.0), (6.2, 10.0),          # hall A revisit
], np.float64)

BUILDING_N_SCANS = 3800    # of the 3894 the tour supports
BUILDING_SPEED = 0.4       # m/s; 4 cm a scan, below the 5 cm coarse step


def generate_dataset(n_scans: int = 1000, seed: int = 0,
                     noise_std: float = 0.008, dropout: float = 0.01,
                     speed: float = 0.35, waypoints: np.ndarray | None = None,
                     world: World | None = None,
                     cfg: LidarConfig = LidarConfig()
                     ) -> tuple[np.ndarray, np.ndarray]:
    """A tour of ``world`` (default the museum) along ``waypoints`` (default
    the museum tour): (ranges (T, 1079) f32, ground-truth poses (T, 3) f32),
    ground truth relative to the first pose (the pipeline starts at the
    origin, main.c:830)."""
    rng = np.random.default_rng(seed)
    world = world or museum_world()
    angles = beam_angles(cfg)
    if waypoints is None:
        waypoints = DEFAULT_WAYPOINTS
    traj = smooth_trajectory(waypoints, speed=speed)
    if len(traj) < n_scans:
        raise ValueError(f"trajectory supports {len(traj)} scans < {n_scans}")
    traj = traj[:n_scans]

    ranges = np.zeros((n_scans, cfg.n_beams), np.float32)
    for i, pose in enumerate(traj):
        r = raycast(world, pose, angles)
        r = r + rng.normal(0.0, noise_std, r.shape) * (r > 0)
        drop = rng.random(r.shape) < dropout
        ranges[i] = np.where(drop, 0.0, np.maximum(r, 0.0)).astype(np.float32)

    # pose in the scan-0 frame: (A(th0)^T (t - t0), th - th0), with the
    # reference rotation A(th) = [[c, s], [-s, c]]
    t0 = traj[0]
    c, s = np.cos(t0[2]), np.sin(t0[2])
    rel = traj - t0
    gx = c * rel[:, 0] - s * rel[:, 1]
    gy = s * rel[:, 0] + c * rel[:, 1]
    gt = np.stack([gx, gy, rel[:, 2]], axis=1).astype(np.float32)
    return ranges, gt


def landmark_positions(world: World | None = None) -> np.ndarray:
    """Point landmarks for the EKF-SLAM model family: pillar centers plus
    room corners (stable, distinguishable features of the museum world)."""
    return np.asarray([
        (4.0, 7.5), (12.0, 11.5), (16.5, 3.5), (11.5, 2.5),      # pillars
        (0.0, 0.0), (20.0, 0.0), (20.0, 15.0), (0.0, 15.0),      # outer corners
        (8.0, 6.0), (8.0, 8.0), (13.0, 7.5), (15.0, 7.5),        # door jambs
    ], np.float64)


def _segment_blocks(world: World, p: np.ndarray, q: np.ndarray) -> bool:
    """True if any wall segment blocks the open segment p->q."""
    x1, y1, x2, y2 = world.segments.T
    ex, ey = x2 - x1, y2 - y1
    dx, dy = q[0] - p[0], q[1] - p[1]
    denom = dx * ey - dy * ex
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_x = x1 - p[0]
        rel_y = y1 - p[1]
        t = (rel_x * ey - rel_y * ex) / denom
        u = (rel_x * dy - rel_y * dx) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-6) & (t < 1.0 - 1e-6) \
        & (u > 1e-6) & (u < 1.0 - 1e-6)
    return bool(np.any(hit))


def generate_landmark_observations(
        traj: np.ndarray, seed: int = 0, max_range: float = 12.0,
        r_noise: float = 0.03, b_noise: float = 0.01,
        world: World | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Range/bearing observations with known association (EKF model family).

    traj: (T, 3) reference-convention poses. Returns (obs (T, L, 2) of
    (range, bearing), visible (T, L) bool, landmarks (L, 2)). Bearings are in
    the sensor frame: bearing = atan2(dy, dx) + theta (ref convention: a
    beam at sensor angle a points at world angle a - theta)."""
    rng = np.random.default_rng(seed)
    world = world or museum_world()
    lms = landmark_positions(world)
    t_, l_ = len(traj), len(lms)
    obs = np.zeros((t_, l_, 2), np.float32)
    vis = np.zeros((t_, l_), bool)
    for t in range(t_):
        px, py, theta = traj[t]
        for j, (lx, ly) in enumerate(lms):
            dx, dy = lx - px, ly - py
            r = float(np.hypot(dx, dy))
            if r < 0.3 or r > max_range:
                continue
            if _segment_blocks(world, traj[t, :2], lms[j] - 1e-3 * np.asarray([dx, dy]) / r):
                continue
            bearing = np.arctan2(dy, dx) + theta   # sensor-frame angle
            bearing = (bearing + np.pi) % (2 * np.pi) - np.pi
            obs[t, j, 0] = r + rng.normal(0, r_noise)
            obs[t, j, 1] = bearing + rng.normal(0, b_noise)
            vis[t, j] = True
    return obs, vis, np.asarray(lms, np.float32)


def generate_ekf_dataset(n_scans: int = 500, seed: int = 0,
                         odo_xy_noise: float = 0.004, odo_th_noise: float = 0.0015,
                         waypoints: np.ndarray | None = None):
    """Landmark-SLAM dataset: noisy odometry + range/bearing observations.

    Returns (odom (T-1, 3) noisy relative motions in the ref convention,
    obs (T, L, 2), visible (T, L), gt (T, 3), landmarks (L, 2)); everything
    expressed in the scan-0 frame."""
    rng = np.random.default_rng(seed + 7)
    if waypoints is None:
        waypoints = DEFAULT_WAYPOINTS
    traj = smooth_trajectory(waypoints)
    if len(traj) < n_scans:
        raise ValueError(f"trajectory supports {len(traj)} scans < {n_scans}")
    traj = traj[:n_scans]
    obs, vis, lms = generate_landmark_observations(traj, seed=seed)

    # re-express in the scan-0 frame (see generate_dataset)
    t0 = traj[0]
    c, s = np.cos(t0[2]), np.sin(t0[2])

    def to_rel(pts):
        rel = pts - t0[:2]
        return np.stack([c * rel[:, 0] - s * rel[:, 1],
                         s * rel[:, 0] + c * rel[:, 1]], axis=1)

    gt_xy = to_rel(traj[:, :2])
    gt = np.concatenate([gt_xy, (traj[:, 2:3] - t0[2])], axis=1).astype(np.float32)
    lms_rel = to_rel(lms).astype(np.float32)

    # noisy odometry: relative motion in the previous pose's frame
    # (ref convention: compose_ref(prev, odo) == cur)
    odom = np.zeros((n_scans - 1, 3), np.float32)
    for t in range(1, n_scans):
        d = gt[t, :2] - gt[t - 1, :2]
        cp, sp = np.cos(gt[t - 1, 2]), np.sin(gt[t - 1, 2])
        odom[t - 1, 0] = cp * d[0] - sp * d[1] + rng.normal(0, odo_xy_noise)
        odom[t - 1, 1] = sp * d[0] + cp * d[1] + rng.normal(0, odo_xy_noise)
        odom[t - 1, 2] = gt[t, 2] - gt[t - 1, 2] + rng.normal(0, odo_th_noise)
    return odom, obs, vis, gt, lms_rel


BA_POSE_STRIDE = 2        # every second pose of the tour fills a pose slot
BA_LANDMARK_SLOTS = 64
BA_LANDMARK_NOISE = 0.3   # m, the landmarks' start off the truth


def generate_ba_problem(n_scans: int = 1000, kmax: int = 512,
                        fmax: int = 8192, emax: int = 512) -> dict:
    """A landmark bundle-adjustment problem on the museum tour's landmark
    dataset (``generate_ekf_dataset``, seed 0), as numpy arrays keyed by
    the fields of ``models.ba.BAProblem``.

    Every second pose fills a pose slot (``kmax``); the 12 landmarks fill
    the first of 64 landmark slots; the visible observations at the kept
    poses fill the observation slots (``fmax``), weighted by the dataset's
    range/bearing noise. Odometry factors (``emax`` slots) join consecutive
    kept poses: the ground truth's relative pose plus Gaussian noise of the
    dataset's odometry sigmas (summed over two scans), weighted by the
    inverse variance. Poses start from those measurements chained, landmarks
    from the truth plus 0.3 m of noise. Ground truth, observations and
    landmarks are all in the scan-0 frame."""
    odo_sig = np.asarray([0.004, 0.004, 0.0015]) * np.sqrt(BA_POSE_STRIDE)
    obs_sig = np.asarray([0.03, 0.01])     # generate_landmark_observations
    _, obs, vis, gt, lms = generate_ekf_dataset(n_scans=n_scans, seed=0)
    rng = np.random.default_rng(11)
    keep = np.arange(0, n_scans, BA_POSE_STRIDE)[:kmax]
    k, n_lm = len(keep), len(lms)
    gt_k = gt[keep].astype(np.float64)
    a, b = gt_k[:-1], gt_k[1:]             # standard-convention a (-) b
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    dth = b[:, 2] - a[:, 2]
    z = np.stack([c * (b[:, 0] - a[:, 0]) + s * (b[:, 1] - a[:, 1]),
                  -s * (b[:, 0] - a[:, 0]) + c * (b[:, 1] - a[:, 1]),
                  dth - 2 * np.pi * np.floor((dth + np.pi) / (2 * np.pi))],
                 axis=1) + rng.normal(0, odo_sig, (k - 1, 3))
    poses = np.zeros((kmax, 3), np.float64)
    poses[0] = gt_k[0]
    for e in range(k - 1):      # chain the measurements (se2.compose)
        c, s = np.cos(poses[e, 2]), np.sin(poses[e, 2])
        poses[e + 1] = [poses[e, 0] + c * z[e, 0] - s * z[e, 1],
                        poses[e, 1] + s * z[e, 0] + c * z[e, 1],
                        poses[e, 2] + z[e, 2]]
    landmarks = np.zeros((BA_LANDMARK_SLOTS, 2), np.float32)
    landmarks[:n_lm] = lms + rng.normal(0, BA_LANDMARK_NOISE, lms.shape)
    pi, lj = np.nonzero(vis[keep])
    f = len(pi)
    if f > fmax or k - 1 > emax or n_lm > BA_LANDMARK_SLOTS:
        raise ValueError(f"{f} observations, {k - 1} odometry factors, "
                         f"{n_lm} landmarks exceed the slots")

    def slots(n, cap, fill, dtype=np.int32, width=None):
        shape = (cap,) if width is None else (cap, width)
        out = np.zeros(shape, dtype)
        out[:n] = fill
        return out

    f32 = np.float32
    return dict(
        poses=poses.astype(f32), landmarks=landmarks,
        pose_active=np.arange(kmax) < k,
        lm_active=np.arange(BA_LANDMARK_SLOTS) < n_lm,
        odo_i=slots(k - 1, emax, np.arange(k - 1)),
        odo_j=slots(k - 1, emax, np.arange(1, k)),
        odo_z=slots(k - 1, emax, z, f32, 3),
        odo_w=np.broadcast_to((1.0 / odo_sig ** 2).astype(f32),
                              (emax, 3)).copy(),
        odo_active=np.arange(emax) < k - 1,
        obs_i=slots(f, fmax, pi), obs_j=slots(f, fmax, lj),
        obs_z=slots(f, fmax, obs[keep][pi, lj], f32, 2),
        obs_w=np.broadcast_to((1.0 / obs_sig ** 2).astype(f32),
                              (fmax, 2)).copy(),
        obs_active=np.arange(fmax) < f)
