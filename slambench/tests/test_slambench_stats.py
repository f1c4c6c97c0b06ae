"""The window's arithmetic: a rate over all the work and all the time of the
window, and latencies over every request. A stall inside the window lowers
``scans_per_s`` and raises ``pose_p50_ms`` and the tail."""

import json
import time
import urllib.request

import numpy as np
import pytest

from slambench import harness
from slambench.kinds import paced_stream, replay

CONFIG = {"tour": {"n_scans": 30, "world": "museum", "waypoints": "museum",
                   "speed": 0.35, "noise_std": 0.008, "dropout": 0.01}}


class _System:
    """A stand-in program: each session or scan takes ``step_s``, and the
    ``stall_at``-th one ``stall_s`` more."""

    def __init__(self, step_s, stall_at=None, stall_s=0.0):
        self.step_s, self.stall_at, self.stall_s = step_s, stall_at, stall_s
        self.calls = 0
        outer = self

        class Program:
            def __init__(self, config, device):
                pass

            def replay(self, ranges):
                outer._work()
                return {}

            def stream(self, url, n, lat):
                for k in range(n):
                    with urllib.request.urlopen(f"{url}/?param={k}") as r:
                        json.loads(r.read())
                    arrived = time.perf_counter()
                    outer._work()
                    if k:
                        lat.append((arrived, arrived, time.perf_counter()))
                return {}

        self.Program = Program

    def _work(self):
        self.calls += 1
        time.sleep(self.step_s + (self.stall_s if self.calls == self.stall_at
                                  else 0.0))

    @staticmethod
    def to_host(out):
        return out


def test_percentile_is_numpys():
    v = np.random.default_rng(0).exponential(5.0, 299)
    for q in (50, 95, 99):
        assert harness.percentile(v, q) == pytest.approx(np.percentile(v, q))


def test_stall_lowers_the_replay_rate():
    def rate(system):
        win = replay.run(system, CONFIG, {"logs": 3}, 1, 1.0, False, "cpu",
                         0.0)
        return win.e2e["scans_per_s"], win.attempted

    steady, n = rate(_System(0.05))
    stalled, m = rate(_System(0.05, stall_at=4, stall_s=0.6))
    assert n >= 10 and m >= 5
    assert stalled < 0.8 * steady


def test_stall_raises_the_stream_latency():
    traffic = {"rate_hz": 10.0, "decimals": 2, "warm_scans": 3}

    def latency(system):
        win = paced_stream.run(system, CONFIG, traffic, 1, 2.0, False, "cpu",
                               0.0)
        assert win.attempted == 19 and win.failed == 0
        pose = [f + s for f, s in zip(win.data["fetch_ms"],
                                      win.data["step_ms"])]
        assert win.e2e["pose_p50_ms"] == pytest.approx(
            harness.percentile(pose, 50), abs=1e-6)
        return win.e2e["pose_p50_ms"], harness.percentile(pose, 95)

    p50, p95 = latency(_System(0.001))
    s50, s95 = latency(_System(0.001, stall_at=3 + 3, stall_s=1.5))
    assert p95 < 100.0
    assert s50 > p50 + 100.0 and s95 > p95 + 500.0
