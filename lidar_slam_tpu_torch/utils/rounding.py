"""Where the card's float32 arithmetic rounds otherwise than the CPU's.

    python -m lidar_slam_tpu_torch.utils.rounding

On one GPU, prints one JSON object: for each operation the port's pose
graph runs in f32 (cos, sin, atan2, sqrt, the batched 3x3 ``einsum`` of its
normal equations, a dense ``solve_ex``), how many of its results the card
computes otherwise than the CPU on the same seeded random inputs; and a
float64 solve rounded to f32, which agrees. It explains why the robust pose
graph on the card stays within about 1e-6 of the CPU's but not bit for bit.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from lidar_slam_tpu_torch.device import resolve_device

N_VALUES = 100000    # inputs of each elementwise operation
N_BLOCKS = 512       # 3x3 blocks of the einsum
N_SOLVE = 384        # size of the dense solves


def rounding_differences(device="cuda", seed: int = 0) -> dict:
    """{operation: how many f32 results differ between ``device`` and the
    CPU} on inputs drawn from ``seed``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def differ(fn, *args):
        want = fn(*args)
        got = fn(*(a.to(dev) for a in args)).cpu()
        return int((got.float() != want.float()).sum())

    xs = torch.as_tensor(rng.normal(0, 3, N_VALUES), dtype=torch.float32)
    ys = torch.as_tensor(rng.normal(0, 3, N_VALUES), dtype=torch.float32)
    out = {"cos": differ(torch.cos, xs), "sin": differ(torch.sin, xs),
           "atan2": differ(torch.atan2, ys, xs),
           "sqrt": differ(torch.sqrt, xs.abs())}
    ea, eb = (torch.as_tensor(rng.normal(0, 1, (N_BLOCKS, 3, 3)),
                              dtype=torch.float32) for _ in range(2))
    out["einsum eab,eac->ebc"] = differ(
        lambda a, b: torch.einsum("eab,eac->ebc", a, b), ea, eb)
    m = torch.as_tensor(rng.normal(0, 1, (N_SOLVE, N_SOLVE)),
                        dtype=torch.float32)
    m = m @ m.T + N_SOLVE * torch.eye(N_SOLVE)
    rhs = torch.as_tensor(rng.normal(0, 1, N_SOLVE), dtype=torch.float32)
    for dt in (torch.float32, torch.float64):
        out[f"solve_ex {str(dt)[6:]} (as f32)"] = differ(
            lambda a, b: torch.linalg.solve_ex(a, b)[0], m.to(dt), rhs.to(dt))
    return out


if __name__ == "__main__":
    print(json.dumps({"of": {"elementwise": N_VALUES,
                             "einsum": N_BLOCKS * 9, "solve": N_SOLVE},
                      "differ": rounding_differences()}))
