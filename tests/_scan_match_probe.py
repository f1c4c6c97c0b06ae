"""K3, the correlative matcher, at the fidelity step's two shapes on the
card: chip_smoke's phase 7 rows without the rest of chip_smoke.

    PYTHONPATH=. python tests/_scan_match_probe.py

Runs 120 eager museum steps on the card, then holds K3 to the plain
version on the keyframe's coarse (200^2) and fine (400^2) fields with scan
120 from the keyframe's pose (every field ``torch.equal``) and prints its
device time (100 raw launches in a CUDA graph), the profiler's kernel row,
the wrapper's and the plain version's times and the bound. Imports no JAX.
"""

import subprocess

import torch

import chip_smoke
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
from lidar_slam_tpu_torch.core import sensor
from lidar_slam_tpu_torch.io import simulate
from lidar_slam_tpu_torch.models import scan_matcher


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    cfg = DEFAULT_CONFIG
    mc = cfg.matcher
    ranges, _ = simulate.generate_dataset(121, seed=0)
    angles = scan_matcher.angles_tensor(cfg, dev)
    state = scan_matcher.init_state(torch.as_tensor(ranges[0], device=dev),
                                    cfg)
    for t in range(1, 121):
        state, _ = scan_matcher.slam_step(
            state, torch.as_tensor(ranges[t], device=dev), cfg, angles)
    scan = sensor.read_scan(torch.as_tensor(ranges[120], device=dev), angles,
                            cfg.lidar)
    for label, grid, metric, step_t, step_r in (
            ("C=27 N=1079 S=200 coarse field", state.coarse,
             state.coarse_metric, mc.coarse_t, mc.coarse_r),
            ("C=27 N=1079 S=400 fine field", state.fine, state.fine_metric,
             mc.fine_t, mc.fine_r)):
        chip_smoke.k3_shape_row(label, metric, grid, scan, state.pose,
                                step_t, step_r, int(mc.window_t),
                                float(mc.window_penalty_px))


if __name__ == "__main__":
    main()
