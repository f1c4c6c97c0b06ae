"""Times the watchdog tests' PF worker a step, at torch's default number of
threads and at ``_watchdog_workers.WORKER_THREADS``, in turns:

    PYTHONPATH=.:tests python tests/_watchdog_threads.py SECONDS

Each turn spawns a child (as ``watchdog.run_supervised`` does) that runs
``watchdog.pf_worker`` on the 12 museum scans and 32 particles of
``tests/test_torch_watchdog.py``'s PF case and prints its thread count,
its seconds and each step's seconds. Run it beside a loaded test run (six
xdist workers) to see what the stall timeout has to survive.
"""

import dataclasses
import multiprocessing
import os
import sys
import tempfile
import time

from _watchdog_workers import WORKER_THREADS


def _child(run_dir, ranges, cfg, threads, out) -> None:
    import torch

    from lidar_slam_tpu_torch.models import fastslam
    from lidar_slam_tpu_torch.utils import watchdog

    if threads:
        torch.set_num_threads(threads)
    steps = []
    step = fastslam.pf_step

    def timed(state, *args, **kwargs):
        t0 = time.perf_counter()
        out = step(state, *args, **kwargs)
        steps.append(time.perf_counter() - t0)
        return out

    fastslam.pf_step = timed
    t0 = time.perf_counter()
    watchdog.pf_worker(run_dir, ranges, cfg, 0, 3, "cpu")
    with open(out, "w") as f:
        f.write(f"{torch.get_num_threads()} threads: "
                f"{time.perf_counter() - t0:.2f} s, steps "
                + " ".join(f"{s:.2f}" for s in steps))


def main() -> None:
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu_torch.io import simulate

    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    ranges, _ = simulate.generate_dataset(n_scans=12, seed=0)
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=32))
    ctx = multiprocessing.get_context("spawn")
    end = time.monotonic() + seconds
    turn = 0
    while time.monotonic() < end:
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "steps.txt")
            p = ctx.Process(target=_child, args=(
                d, ranges, cfg, WORKER_THREADS if turn % 2 else 0, out))
            p.start()
            p.join()
            with open(out) as f:
                print(f.read(), flush=True)
        turn += 1


if __name__ == "__main__":
    main()
