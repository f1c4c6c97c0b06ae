"""Inputs of the graph backend's captured helpers, made with numpy from a
seed: loop-tour keyframe scans and their batches, pose graphs and BA
problems. Shared by the CPU tests (``test_torch_captured_backend.py``) and
the card's (``test_torch_cuda.py``); imports neither JAX nor the JAX
package."""

import numpy as np
import torch

from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
from lidar_slam_tpu_torch.core import sensor
from lidar_slam_tpu_torch.io import simulate
from lidar_slam_tpu_torch.models import ba, graph_slam, posegraph, state_io
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor

N_KEYFRAMES = 16
WIDTHS = range(1, 9)     # every bucket width of the card's passes


def keyframes(device):
    """16 gated loop-tour scans, 6 scans apart, as (x, y, valid) (16, N)
    on ``device``, and their ground-truth poses (16, 3) numpy."""
    ranges, gt = simulate.generate_dataset(100, seed=1,
                                           waypoints=simulate.LOOP_WAYPOINTS)
    rows = np.arange(N_KEYFRAMES) * 6
    angles = angles_tensor(DEFAULT_CONFIG, "cpu")
    scans = [sensor.read_scan(torch.as_tensor(ranges[i]), angles,
                              DEFAULT_CONFIG.lidar) for i in rows]
    x, y, v = (torch.stack([getattr(s, f) for s in scans]).to(device)
               for f in ("x", "y", "valid"))
    return x, y, v, gt[rows]


def store(x, y, v, lc=graph_slam.LoopClosureConfig()):
    """A device keyframe store over those scans, rasters zero."""
    metric = torch.zeros((x.shape[0], lc.raster_size, lc.raster_size),
                         device=x.device)
    return graph_slam._DeviceKeyframes(x, y, v, metric)


def batches(b: int):
    """Two batches of width ``b``: (old rows, current rows) each, distinct
    keyframes in a scrambled order, the current one after the old."""
    out = []
    for start in (0, 7):
        olds = [(start + 4 * i) % (N_KEYFRAMES - 1) for i in range(b)]
        out.append((olds, [o + 1 for o in olds]))
    return out


def guesses(gt, olds, curs, seed=0):
    """The current keyframes' poses in the old ones' frames, off by a few
    cm and mrad: (B, 3) f32."""
    rng = np.random.default_rng(seed)
    rel = np.stack([graph_slam._np_between_ref(gt[i], gt[k])
                    for i, k in zip(olds, curs)])
    noise = rng.normal(0, [0.05, 0.05, 0.01], rel.shape)
    return (rel + noise).astype(np.float32)


def pose_graph_arrays(seed=0, k=24, e=60, kmax=32, emax=80):
    """A random connected pose graph (an odometry chain plus random extra
    edges), padded to capacity: ``PoseGraph``'s fields as numpy."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((kmax, 3), np.float32)
    poses[:k] = rng.normal(0, 2, (k, 3))
    ei = np.zeros(emax, np.int32)
    ej = np.zeros(emax, np.int32)
    ei[:k - 1], ej[:k - 1] = np.arange(k - 1), np.arange(1, k)
    ei[k - 1:e] = rng.integers(0, k, e - k + 1)
    ej[k - 1:e] = rng.integers(0, k, e - k + 1)
    ez = np.zeros((emax, 3), np.float32)
    ez[:e] = rng.normal(0, 1, (e, 3))
    ew = np.ones((emax, 3), np.float32)
    ew[:e] = rng.uniform(1, 100, (e, 3))
    return (poses, np.arange(kmax) < k, np.int32(k), ei, ej, ez, ew,
            np.arange(emax) < e, np.int32(e))


def pose_graph(arrays, device) -> posegraph.PoseGraph:
    return posegraph.PoseGraph(*(torch.as_tensor(a, device=device)
                                 for a in arrays))


def ba_problems(device, n_scans=400):
    """The museum BA problem (K = 512 slots) and a copy of it whose initial
    poses and landmarks are moved by a few cm: two problems of one
    shape."""
    p = state_io.ba_problem_from_numpy(
        ba.BAProblem(**simulate.generate_ba_problem(n_scans=n_scans)), device)
    rng = np.random.default_rng(3)
    moved = p._replace(
        poses=p.poses + torch.as_tensor(
            rng.normal(0, 0.02, tuple(p.poses.shape)), dtype=torch.float32,
            device=device),
        landmarks=p.landmarks + torch.as_tensor(
            rng.normal(0, 0.05, tuple(p.landmarks.shape)),
            dtype=torch.float32, device=device))
    return p, moved
