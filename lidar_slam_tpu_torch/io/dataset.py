"""Dataset cache (counterpart of ``lidar_slam_tpu.io.dataset``).

``ensure_dataset`` synthesizes a tour once and caches it as
``data/<world>_v2_<n>_s<seed>.npz`` at the repository root — the JAX
package's own file name for the same, byte-identical arrays, so either
package may write the cache and both read it. The write goes through a
temporary file and an atomic rename, so concurrent test workers never read a
half-written cache. ``save_csv``/``load_csv`` write and read the
reference's CSV format (``native.read_csv`` is the fast reader).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

DEFAULT_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "data")


def save_csv(path: str, ranges: np.ndarray) -> None:
    """One scan a row, comma-separated, six decimals: the reference's
    dataset format (main.c:22-30), as the JAX package writes it."""
    np.savetxt(path, ranges, fmt="%.6f", delimiter=",")


def load_csv(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)


def ensure_dataset(n_scans: int = 1000, seed: int = 0,
                   data_dir: str | None = None, world: str = "museum"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Ranges (T, 1079) f32 and ground-truth poses (T, 3) f32.

    world: ``"museum"`` (20x15 m) or ``"building"`` (60x45 m, pair it with
    ``config.BUILDING_CONFIG``).
    """
    from lidar_slam_tpu_torch.io import simulate

    if world == "museum":
        kwargs = {}
    elif world == "building":
        kwargs = dict(speed=simulate.BUILDING_SPEED,
                      waypoints=simulate.BUILDING_WAYPOINTS,
                      world=simulate.building_world())
    else:
        raise ValueError(f"unknown world {world!r}")
    data_dir = os.path.abspath(data_dir or DEFAULT_DATA_DIR)
    os.makedirs(data_dir, exist_ok=True)
    npz = os.path.join(data_dir, f"{world}_v2_{n_scans}_s{seed}.npz")
    if os.path.exists(npz):
        with np.load(npz) as blob:
            return blob["ranges"], blob["gt"]
    ranges, gt = simulate.generate_dataset(n_scans=n_scans, seed=seed,
                                           **kwargs)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=data_dir)
    os.close(fd)
    try:
        np.savez_compressed(tmp, ranges=ranges, gt=gt)
        os.replace(tmp, npz)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return ranges, gt
