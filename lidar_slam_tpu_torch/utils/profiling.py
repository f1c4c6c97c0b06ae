"""Wall-clock stage timing (counterpart of ``StageTimer`` in
``lidar_slam_tpu.utils.profiling``).

Each stage ends with a device synchronize when the timer is given a CUDA
device (where the JAX package calls ``jax.effects_barrier()``), so a
stage's time includes the device work it queued.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulates wall time per named stage."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        lines = [f"{'stage':24s} {'total s':>9s} {'calls':>7s} {'share':>7s}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t:9.3f} {self.counts[name]:7d} "
                         f"{100 * t / total:6.1f}%")
        return "\n".join(lines)
