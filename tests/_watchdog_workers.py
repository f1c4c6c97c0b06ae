"""Workers for ``tests/test_torch_watchdog.py``, in a module of their own
so a spawned child imports the port and torch only, not the test module's
JAX. Each injects its hang the way ``tests/test_watchdog.py`` does, with no
hook in the port."""

import os
import time

import torch

from lidar_slam_tpu_torch.models import fastslam
from lidar_slam_tpu_torch.utils import watchdog


def _flaky_worker(run_dir: str, n_steps: int, hang_at: int) -> None:
    """Counts to n_steps with a checkpoint a step; the FIRST attempt wedges
    (sleeps, heartbeat silent) at step ``hang_at``."""
    hb = watchdog.Heartbeat(run_dir)
    progress = os.path.join(run_dir, "progress.txt")
    start, first_attempt = 0, True
    if os.path.exists(progress):
        with open(progress) as f:
            start = int(f.read())
        first_attempt = False
    hb.beat(start)
    for t in range(start, n_steps):
        if first_attempt and t == hang_at:
            time.sleep(3600)   # the injected wedge
        with open(progress + ".tmp", "w") as f:
            f.write(str(t + 1))
        os.replace(progress + ".tmp", progress)
        hb.beat(t + 1)


def _always_hang(run_dir: str) -> None:
    watchdog.Heartbeat(run_dir).beat(0)
    time.sleep(3600)


def _stale_beat_then_hang(run_dir: str) -> None:
    """One beat whose mtime lands before the launch (a coarse-mtime
    filesystem), then a wedge."""
    hb = watchdog.Heartbeat(run_dir)
    hb.beat(0)
    past = time.time() - 30.0
    os.utime(hb.path, (past, past))
    time.sleep(3600)


# torch threads of a worker that computes: two, as in the test processes
# (``_torch_util``). With torch's default of one a core, the spawned PF
# child's 11 steps took 4.5-14.2 s beside five busy test workers running
# JAX (a step up to 3.7 s), against 0.2-5.2 s on two threads (a step up to
# 1.4 s; 8 cores, ``tests/_watchdog_threads.py``); in a loaded tier-1 run
# the resumed attempt of ``test_resume_after_a_wedge_matches_run_pf`` fell
# silent for the 15 s stall timeout and was killed a second time.
WORKER_THREADS = 2


def _wedging_pf_worker(run_dir, ranges, cfg, seed, ckpt_every, device,
                       wedge_at):
    """``pf_worker`` whose first attempt wedges before scan ``wedge_at``,
    on ``WORKER_THREADS`` torch threads."""
    torch.set_num_threads(WORKER_THREADS)
    marker = os.path.join(run_dir, "attempted")
    if not os.path.exists(marker):
        open(marker, "w").close()
        step = fastslam.pf_step

        def wedging(state, *args, **kwargs):
            if state.step == wedge_at:
                time.sleep(3600)
            return step(state, *args, **kwargs)

        fastslam.pf_step = wedging
    watchdog.pf_worker(run_dir, ranges, cfg, seed, ckpt_every, device)
