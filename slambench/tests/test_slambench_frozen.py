"""The benchmark's frozen copies equal the program's originals today: the
tour synthesiser byte for byte (museum and loop tours, two seeds), the
served protocol's rows, the pacing server's rows and the ATE. A later
change to the program does not change the copies; this test then shows
where the two part."""

import json
import multiprocessing
import time
import urllib.request

import numpy as np
import pytest

from lidar_slam_tpu_torch.config import LidarConfig
from lidar_slam_tpu_torch.core.sensor import beam_angles
from lidar_slam_tpu_torch.io import server as prog_server
from lidar_slam_tpu_torch.io import simulate as prog_sim
from lidar_slam_tpu_torch.utils.metrics import ate
from slambench.frozen import server, simulate


@pytest.mark.parametrize("seed", [0, 3_000_000_123])
@pytest.mark.parametrize("tour", ["museum", "loop"])
def test_tours_byte_identical(tour, seed):
    mine = simulate.generate_tour(12, seed, waypoints=tour)
    wps = prog_sim.LOOP_WAYPOINTS if tour == "loop" else None
    theirs = prog_sim.generate_dataset(12, seed=seed, waypoints=wps)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_sensor_constants():
    cfg = LidarConfig()
    assert simulate.beam_angles().tobytes() == beam_angles(cfg).tobytes()
    assert (simulate.N_BEAMS, simulate.ANGLE_MIN, simulate.ANGLE_INCREMENT) \
        == (cfg.n_beams, cfg.angle_min, cfg.angle_increment)


def test_ate_is_the_programs():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 50, 3))
    assert simulate.ate(a, b) == ate(a, b)


def test_served_rows_are_what_the_client_parses():
    ranges, _ = simulate.generate_tour(5, 7)
    srv = prog_server.ScanServer(ranges).start()
    try:
        parsed = np.stack([prog_server.fetch_scan(srv.url, k)
                           for k in range(5)])
    finally:
        srv.stop()
    assert parsed.tobytes() == server.served_rows(ranges).tobytes()


def test_paced_chain_serves_rows_on_time():
    ranges, _ = simulate.generate_tour(6, 7)
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=server.serve_chain, args=(ranges, child),
                       daemon=True)
    proc.start()
    try:
        assert conn.poll(60)
        url = conn.recv()
        conn.send(("pace", 0.05))
        assert conn.recv() is True
        rows = []
        for k in range(6):
            with urllib.request.urlopen(f"{url}/?param={k}") as r:
                rows.append(json.loads(r.read()))
            got = time.perf_counter()
        conn.send(("clock",))
        t0, due, released = conn.recv()
        conn.send(("stop",))
        assert conn.recv() is True
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert not proc.is_alive()
    assert np.asarray(rows, np.float32).tobytes() == \
        server.served_rows(ranges).tobytes()
    assert sorted(due) == list(range(6))
    for k in range(6):
        assert due[k] == pytest.approx(t0 + 0.05 * k)
        assert 0.0 <= released[k] - due[k] < 0.05
    assert got >= t0 + 0.25
