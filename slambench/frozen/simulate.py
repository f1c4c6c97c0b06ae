"""The benchmark's frozen tour synthesiser: a copy of the museum world, the
museum and loop tours and the raycaster of ``lidar_slam_tpu_torch.io.
simulate``, with the sensor's constants (reference ``main.c:45-58``).

The benchmark makes every tour from ``--seed`` with this copy, so a later
change to the program's synthesiser cannot change what the benchmark feeds
it. ``slambench/tests/test_slambench_frozen.py`` pins this copy byte for byte
to the program's at small sizes. NumPy only.
"""

from __future__ import annotations

import numpy as np

# the sensor (main.c:45-58; LidarConfig's defaults)
N_BEAMS = 1079
ANGLE_MIN = -2.351831
ANGLE_INCREMENT = 0.004363
RATE_HZ = 10.0


def beam_angles(n_beams: int = N_BEAMS, angle_min: float = ANGLE_MIN,
                angle_increment: float = ANGLE_INCREMENT) -> np.ndarray:
    """The beam angle table, accumulated in f32 as ``angle += increment``
    (main.c:53-57)."""
    angles = np.empty(n_beams, np.float32)
    a = np.float32(angle_min)
    inc = np.float32(angle_increment)
    for i in range(n_beams):
        angles[i] = a
        a = np.float32(a + inc)
    return angles


def _box(x0, y0, x1, y1):
    return [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1),
            (x0, y1, x0, y0)]


def museum_world() -> np.ndarray:
    """A 20x15 m three-room floor plan with door gaps and pillars: (S, 4)
    wall segments x1, y1, x2, y2."""
    segs: list[tuple[float, float, float, float]] = []
    segs += _box(0.0, 0.0, 20.0, 15.0)
    segs += [(8.0, 0.0, 8.0, 6.0), (8.0, 8.0, 8.0, 15.0)]
    segs += [(8.0, 7.5, 13.0, 7.5), (15.0, 7.5, 20.0, 7.5)]
    for cx, cy in [(4.0, 7.5), (12.0, 11.5), (16.5, 3.5), (11.5, 2.5)]:
        s = 0.25
        segs += _box(cx - s, cy - s, cx + s, cy + s)
    return np.asarray(segs, np.float64)


WAYPOINTS = {
    # the museum tour through all three rooms
    "museum": np.asarray([
        (3.0, 3.0), (3.0, 12.0), (5.5, 12.5), (6.0, 5.0), (7.0, 6.9),
        (9.5, 7.0), (11.5, 5.0), (13.0, 2.5), (17.0, 2.0), (18.0, 5.5),
        (14.5, 6.2), (14.0, 8.5), (16.5, 9.5), (17.5, 12.5), (13.0, 13.0),
        (10.0, 11.5), (9.2, 9.0), (10.5, 8.2), (13.5, 9.0),
    ], np.float64),
    # a closed loop in the museum's left room that revisits the start
    "loop": np.asarray([
        (3.0, 3.0), (2.8, 8.0), (3.0, 12.0), (5.5, 12.5), (6.5, 9.0),
        (6.2, 5.0), (4.8, 3.2), (3.2, 3.2), (2.9, 7.0), (3.0, 10.0),
    ], np.float64),
}

WORLDS = {"museum": museum_world}


def smooth_trajectory(waypoints: np.ndarray, speed: float = 0.3,
                      rate_hz: float = RATE_HZ, smooth_m: float = 2.0,
                      heading_smooth: int = 51) -> np.ndarray:
    """Arc-length-resampled, corner-rounded path -> (T, 3) poses in the
    reference convention."""
    pts = []
    for a, b in zip(waypoints[:-1], waypoints[1:]):
        n = max(2, int(np.linalg.norm(b - a) / 0.01))
        t = np.linspace(0.0, 1.0, n, endpoint=False)[:, None]
        pts.append(a[None] * (1 - t) + b[None] * t)
    dense = np.concatenate(pts + [waypoints[-1:]], axis=0)
    win = max(1, int(smooth_m / 0.01))
    kernel = np.ones(win) / win
    sm = np.stack([np.convolve(dense[:, i], kernel, mode="valid")
                   for i in range(2)], 1)
    seglen = np.linalg.norm(np.diff(sm, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seglen)])
    step = speed / rate_hz
    stations = np.arange(0.0, s[-1] - 1e-6, step)
    x = np.interp(stations, s, sm[:, 0])
    y = np.interp(stations, s, sm[:, 1])
    heading = np.arctan2(np.gradient(y), np.gradient(x))
    heading = np.unwrap(heading)
    hw = heading_smooth
    hk = np.ones(hw) / hw
    for _ in range(2):
        heading = np.convolve(np.pad(heading, hw // 2, mode="edge"), hk,
                              mode="valid")[: len(x)]
    return np.stack([x, y, -heading], axis=1)


def raycast(segments: np.ndarray, pose: np.ndarray, angles: np.ndarray,
            max_range: float = 60.0) -> np.ndarray:
    """Cast all beams from one pose; ranges (N,), 0 where no hit."""
    ox, oy, theta = pose
    ang = angles.astype(np.float64) - theta
    dx, dy = np.cos(ang), np.sin(ang)
    x1, y1, x2, y2 = segments.T
    ex, ey = x2 - x1, y2 - y1
    denom = dx[:, None] * ey[None, :] - dy[:, None] * ex[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_x = x1[None, :] - ox
        rel_y = y1[None, :] - oy
        t = (rel_x * ey[None, :] - rel_y * ex[None, :]) / denom
        u = (rel_x * dy[:, None] - rel_y * dx[:, None]) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-9) & (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    r = np.min(t, axis=1)
    return np.where(np.isfinite(r) & (r <= max_range), r, 0.0)


def _tour(n_scans: int, world: str, waypoints: str, speed: float):
    traj = smooth_trajectory(WAYPOINTS[waypoints], speed=speed)
    if len(traj) < n_scans:
        raise ValueError(f"trajectory supports {len(traj)} scans < {n_scans}")
    traj = traj[:n_scans]
    t0 = traj[0]
    c, s = np.cos(t0[2]), np.sin(t0[2])
    rel = traj - t0
    gx = c * rel[:, 0] - s * rel[:, 1]
    gy = s * rel[:, 0] + c * rel[:, 1]
    gt = np.stack([gx, gy, rel[:, 2]], axis=1).astype(np.float32)
    return WORLDS[world](), traj, gt


def generate_tour(n_scans: int, seed: int, world: str = "museum",
                  waypoints: str = "museum", speed: float = 0.35,
                  noise_std: float = 0.008, dropout: float = 0.01
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(ranges (T, 1079) f32, ground truth (T, 3) f32 in the scan-0
    frame): the tour along ``WAYPOINTS[waypoints]`` in ``WORLDS[world]``,
    with range noise and dropouts drawn from ``seed``, scan by scan (the
    program's synthesiser's draws). Every seed has the same trajectory and
    sizes; only the noise differs."""
    rng = np.random.default_rng(seed)
    segments, traj, gt = _tour(n_scans, world, waypoints, speed)
    angles = beam_angles()
    ranges = np.zeros((n_scans, N_BEAMS), np.float32)
    for i, pose in enumerate(traj):
        r = raycast(segments, pose, angles)
        r = r + rng.normal(0.0, noise_std, r.shape) * (r > 0)
        drop = rng.random(r.shape) < dropout
        ranges[i] = np.where(drop, 0.0, np.maximum(r, 0.0)).astype(np.float32)
    return ranges, gt


def tour_logs(n_scans: int, seed: int, count: int, world: str = "museum",
              waypoints: str = "museum", speed: float = 0.35,
              noise_std: float = 0.008, dropout: float = 0.01
              ) -> tuple[list[np.ndarray], np.ndarray]:
    """``count`` logs of one tour (ranges (T, 1079) f32 each) and its ground
    truth: the tour is raycast once, and log j takes its range noise and
    dropouts from the generator seeded with (``seed``, j), drawn for the
    whole log at once."""
    segments, traj, gt = _tour(n_scans, world, waypoints, speed)
    angles = beam_angles()
    clean = np.stack([raycast(segments, pose, angles) for pose in traj])
    logs = []
    for j in range(count):
        rng = np.random.default_rng([seed, j])
        r = clean + rng.normal(0.0, noise_std, clean.shape) * (clean > 0)
        drop = rng.random(clean.shape) < dropout
        logs.append(np.where(drop, 0.0, np.maximum(r, 0.0)).astype(
            np.float32))
    return logs, gt


def ate(est: np.ndarray, ref: np.ndarray) -> float:
    """Absolute trajectory error: RMSE over xy of two (T, >=2) paths that
    both start at the origin (a copy of ``utils.metrics.ate``, unaligned)."""
    a = np.asarray(est, np.float64)[:, :2]
    b = np.asarray(ref, np.float64)[:, :2]
    if a.shape != b.shape:
        raise ValueError(f"paths of shapes {a.shape} and {b.shape}")
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))
