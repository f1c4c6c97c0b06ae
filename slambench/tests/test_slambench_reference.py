"""The plain reference against the program at small sizes on the CPU, and
the control (the reference in bfloat16 in the program's place) failing the
same comparison."""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.models import graph_slam, scan_matcher
from slambench import control
from slambench.frozen import simulate
from slambench.reference import fidelity as ref_fid
from slambench.reference import graph as ref_graph
from _small import small_cell

CFG = dataclasses.asdict(SlamConfig())


def test_fidelity_reference_equals_the_program():
    ranges, _ = simulate.generate_tour(60, 11)
    path, state = scan_matcher.run_scan(ranges, SlamConfig(), device="cpu")
    rpath, rst, refreshes = ref_fid.Fidelity(CFG, "cpu").run(ranges)
    assert refreshes > 3
    assert np.array_equal(path.numpy(), rpath)
    size = int(state.pmap.size)
    assert np.array_equal(state.pmap.xy[:size].numpy(), rst.map_xy.numpy())
    coarse, fine = ref_fid.final_fields(rst)
    assert np.array_equal(state.coarse_metric.numpy(), coarse)
    assert np.array_equal(state.fine_metric.numpy(), fine)


def test_sincos_and_field_match_the_programs_ops():
    from lidar_slam_tpu_torch.core.trig32 import sincos32
    from lidar_slam_tpu_torch.ops.edt import edt_clamped

    x = torch.linspace(-40.0, 40.0, 100001)
    for a, b in zip(ref_fid.sincos(x), sincos32(x)):
        assert torch.equal(a, b)
    occ = torch.rand(3, 64, 80, generator=torch.Generator().manual_seed(0)) \
        < 0.02
    assert torch.equal(ref_fid.clamped_edt(occ, 10, torch.float32),
                       edt_clamped(occ, 10))


def test_graph_reference_follows_the_program():
    """200 loop scans, chunks of 32, closures after 3 keyframes: closures
    and two feedbacks happen; the path stays exact, the keyframe poses
    within the solve's rounding."""
    ranges, _ = simulate.generate_tour(200, 1, waypoints="loop")
    lc = graph_slam.LoopClosureConfig(min_gap=3)
    g = graph_slam.GraphSlam(SlamConfig(), lc, device="cpu")
    path, kf = g.run(ranges, chunk_size=32)
    out = ref_graph.run_graph(ranges, CFG, dataclasses.asdict(lc), 512, 32,
                              "cpu")
    assert out["feedbacks"] >= 1 and len(out["closures"]) >= 3
    assert out["closures"] == g.closures
    assert out["attempts"] == len(g.attempt_log)
    assert np.abs(path - out["path"]).max() < 1e-5
    assert np.abs(kf - out["kf_poses"])[:, :2].max() < 1e-5
    # the backend alone on the program's keyframes does the same
    back = ref_graph.follow_backend(ranges, g.kf_times, path[g.kf_times],
                                    CFG, dataclasses.asdict(lc), 512, 32,
                                    "cpu")
    assert back["closures"] == g.closures
    assert back["kf_times"] == g.kf_times
    assert np.abs(kf - back["kf_poses"])[:, :2].max() < 1e-5


def test_optimize_reaches_a_consistent_graph():
    poses = np.asarray([[0, 0, 0], [1.1, 0, 0], [2.0, 0.1, 0]], np.float64)
    z = np.asarray([1.0, 0.0, 0.0])
    edges = [(0, 1, z, np.ones(3)), (1, 2, z, np.ones(3)),
             (0, 2, 2 * z, np.ones(3))]
    opt = ref_graph.optimize(poses, edges, iters=20)
    assert np.abs(opt - [[0, 0, 0], [1, 0, 0], [2, 0, 0]]).max() < 1e-3


@pytest.mark.parametrize("name", ["museum-fidelity.replay",
                                  "museum-fidelity.stream10hz",
                                  "loop-graph.replay"])
def test_control_fails_and_program_passes(name):
    cell = small_cell(name)
    r = control.readings(cell, 5, 2.0, "cpu", program="replay" in name)
    assert any(v > lim for _, v, lim in r["control"]), r["control"]
    if r["program"] is not None:
        assert all(v <= lim for _, v, lim in r["program"]), r["program"]
