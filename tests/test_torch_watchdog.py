"""The port's stall watchdog (``utils/watchdog``): the cases of
``tests/test_watchdog.py`` (a hang is injected and recovered from; the
supervisor gives up after ``max_restarts``; a supervised PF equals
``run_pf``, here exactly), a resume after a kill that equals the unbroken
run (the checkpoint carries the generator), and one test for each change
from the JAX supervisor: the heartbeat read once a poll, ``booted`` latched
from the launch token, ``boot_grace_s`` passed through
``run_pf_supervised``.

Workers are spawned from ``tests/_watchdog_workers.py`` (it imports the
port only, so a child starts without JAX); each pays for importing torch
before its first beat, so the boot grace is generous and the stall
timeouts short.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import _torch_util  # noqa: F401  (caps torch's threads)
from _watchdog_workers import (_always_hang, _flaky_worker,
                               _stale_beat_then_hang, _wedging_pf_worker)
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu_torch.io import simulate
from lidar_slam_tpu_torch.models import fastslam
from lidar_slam_tpu_torch.utils import watchdog

BOOT_GRACE_S = 120.0     # a spawned child importing torch on a busy host
# the longest a PF step may go without a beat: a resumed child's first
# steps on a busy host (six test workers) took over 2 s
PF_STALL_S = 15.0
# the longest a counting step may go without a beat: under six test workers
# and the spawned gloo worlds of the multiprocess tests, a pause between two
# beats of a few seconds was seen, so the same margin as a PF step
FLAKY_STALL_S = 15.0


def test_recovers_from_injected_hang(tmp_path):
    run_dir = str(tmp_path / "run")
    report = watchdog.run_supervised(
        _flaky_worker, (20, 7), run_dir, stall_timeout_s=FLAKY_STALL_S,
        max_restarts=1, poll_s=0.1, boot_grace_s=BOOT_GRACE_S)
    assert report.completed, report
    assert report.attempts == 2 and report.stalls == 1
    with open(os.path.join(run_dir, "progress.txt")) as f:
        assert int(f.read()) == 20


def test_gives_up_after_max_restarts(tmp_path):
    report = watchdog.run_supervised(
        _always_hang, (), str(tmp_path / "hangs"), stall_timeout_s=1.0,
        max_restarts=1, poll_s=0.1, boot_grace_s=BOOT_GRACE_S)
    assert not report.completed
    assert report.attempts == 2 and report.stalls == 2


def _pf_case(n_scans=12):
    ranges, _ = simulate.generate_dataset(n_scans=n_scans, seed=0)
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=32))
    want, _ = fastslam.run_pf(ranges, cfg, seed=0, device="cpu")
    return ranges, cfg, want.numpy()


def test_supervised_pf_matches_run_pf(tmp_path):
    ranges, cfg, want = _pf_case()
    path, report = watchdog.run_pf_supervised(
        ranges, cfg, str(tmp_path / "pf"), stall_timeout_s=300.0,
        ckpt_every=5, device="cpu", boot_grace_s=BOOT_GRACE_S)
    assert report.completed and report.attempts == 1
    assert np.array_equal(path, want)


def test_resume_after_a_wedge_matches_run_pf(tmp_path):
    """The first attempt wedges at scan 9 after a checkpoint at scan 6; the
    second resumes at scan 7 with the saved generator: the path equals the
    unbroken run's, bit for bit."""
    ranges, cfg, want = _pf_case()
    run_dir = str(tmp_path / "pf")
    report = watchdog.run_supervised(
        _wedging_pf_worker, (ranges, cfg, 0, 3, "cpu", 9), run_dir,
        stall_timeout_s=PF_STALL_S, max_restarts=1, poll_s=0.1,
        boot_grace_s=BOOT_GRACE_S)
    assert report.completed and report.attempts == 2 and report.stalls == 1
    assert np.array_equal(np.load(os.path.join(run_dir, watchdog.PATH_FILE)),
                          want)


def test_heartbeat_read_once_a_poll(tmp_path, monkeypatch):
    """Each poll reads the heartbeat once: consecutive reads are a poll
    interval apart, never back to back."""
    stamps = []
    read = watchdog.read_beat

    def counting(run_dir):
        stamps.append(time.monotonic())
        return read(run_dir)

    monkeypatch.setattr(watchdog, "read_beat", counting)
    poll = 0.2
    watchdog.run_supervised(_always_hang, (), str(tmp_path / "h"),
                            stall_timeout_s=1.0, max_restarts=0, poll_s=poll,
                            boot_grace_s=BOOT_GRACE_S)
    assert len(stamps) >= 3
    assert min(np.diff(stamps)) > poll / 2


def test_beat_stamped_before_launch_counts_as_booted(tmp_path):
    """A beat whose mtime lies before the launch still boots the attempt
    (its launch token matches), so the wedge after it is killed after
    ``stall_timeout_s``, not ``boot_grace_s``."""
    t0 = time.time()
    report = watchdog.run_supervised(
        _stale_beat_then_hang, (), str(tmp_path / "s"), stall_timeout_s=1.0,
        max_restarts=0, poll_s=0.1, boot_grace_s=BOOT_GRACE_S)
    assert report.stalls == 1 and not report.completed
    assert time.time() - t0 < BOOT_GRACE_S / 2


def test_run_pf_supervised_passes_boot_grace(tmp_path, monkeypatch):
    seen = {}

    def fake(worker, args, run_dir, **kwargs):
        seen.update(kwargs, worker=worker, device=args[-1])
        return watchdog.SuperviseReport(True, 1, 0, 0, 0.0)

    monkeypatch.setattr(watchdog, "run_supervised", fake)
    ranges = np.zeros((3, 1079), np.float32)
    watchdog.run_pf_supervised(ranges, DEFAULT_CONFIG, str(tmp_path / "g"),
                               boot_grace_s=77.0, device="cpu")
    assert seen["boot_grace_s"] == 77.0 and seen["device"] == "cpu"
    assert seen["worker"] is watchdog.pf_worker


def test_pf_worker_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        watchdog.pf_worker(str(tmp_path), np.zeros((2, 1079), np.float32),
                           DEFAULT_CONFIG)
