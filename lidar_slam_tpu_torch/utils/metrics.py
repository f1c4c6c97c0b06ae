"""Trajectory metrics of the port (a copy of ``lidar_slam_tpu.utils.metrics``,
so the port imports nothing of the JAX package; ``tests/test_torch_config.py``
holds the two equal).

The reference publishes no quantitative accuracy metric — its criterion is
visual map fidelity. Accuracy here is trajectory comparison against the
simulator's ground truth and the compiled C oracle: ATE, RPE and the
largest absolute difference.
"""

from __future__ import annotations

import numpy as np


def ate(est: np.ndarray, ref: np.ndarray, align: bool = False) -> float:
    """Absolute trajectory error (RMSE over xy). est/ref: (T, >=2).

    ``align=False`` compares raw trajectories (both start at the origin by
    construction); ``align=True`` applies the optimal SE(2) alignment first
    (Umeyama, rotation+translation only).
    """
    a = np.asarray(est, np.float64)[:, :2]
    b = np.asarray(ref, np.float64)[:, :2]
    assert a.shape == b.shape, (a.shape, b.shape)
    if align:
        ca, cb = a.mean(0), b.mean(0)
        h = (a - ca).T @ (b - cb)
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        r = vt.T @ np.diag([1.0, d]) @ u.T
        a = (a - ca) @ r.T + cb
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def rpe(est: np.ndarray, ref: np.ndarray, delta: int = 10) -> float:
    """Relative pose error (RMSE of xy drift over windows of ``delta`` steps)."""
    a = np.asarray(est, np.float64)[:, :2]
    b = np.asarray(ref, np.float64)[:, :2]
    da = a[delta:] - a[:-delta]
    db = b[delta:] - b[:-delta]
    return float(np.sqrt(np.mean(np.sum((da - db) ** 2, axis=1))))


def max_abs_err(est: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(np.asarray(est) - np.asarray(ref))))
