"""Eager reference loops the captured drivers are held to, for the CPU
tests and the card's (``tests/test_torch_cuda.py``); imports neither JAX
nor the JAX package."""

import numpy as np
import torch

from lidar_slam_tpu_torch.models import submap_slam
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor


def eager_paged(ranges_all, cfg, paged, manage_every: int = 16,
                device="cpu"):
    """``utils/paging.run_host_loop_paged`` with the eager ``slam_step`` a
    scan in place of the captured step: (path (T, 3) numpy, final state)."""
    ranges = torch.as_tensor(np.asarray(ranges_all, np.float32),
                             device=device)
    angles = angles_tensor(cfg, ranges.device)
    state = submap_slam.init_state(ranges[0], cfg)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, ranges.shape[0]):
        state, pose = submap_slam.slam_step(state, ranges[t], cfg, angles)
        poses.append(pose.cpu().numpy())
        if t % manage_every == 0:
            new_atlas = paged.manage(state.atlas, poses[-1])
            if new_atlas is not state.atlas:
                state = state._replace(atlas=new_atlas)
    return np.stack(poses), state
