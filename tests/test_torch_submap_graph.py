"""The port's graph SLAM over the submap atlas
(``models/submap_graph_slam``) against
``lidar_slam_tpu.models.submap_graph_slam``.

Both packages run 200 loop-tour scans in chunks of 32 with ``min_gap`` 3,
so closures fire and feed back early. The frontend's path is held within
1e-5 of JAX's (XLA fuses the anchor-frame transform of the stored points
into multiply-adds, an f32 ulp on a few points, which can move a raster
cell), the keyframes and closures equal, the optimized keyframes and the
re-anchored submaps within 1e-3 (the pose-graph solve, as in
``test_torch_graph.py``).
"""

import numpy as np
import pytest

from _torch_util import to_numpy_tree  # noqa: F401  (caps torch threads)
from lidar_slam_tpu.config import DEFAULT_CONFIG as JCFG
from lidar_slam_tpu.io import simulate as jsim
from lidar_slam_tpu.models import graph_slam as jgs
from lidar_slam_tpu.models.submap_graph_slam import SubmapGraphSlam as JSGS
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG as TCFG
from lidar_slam_tpu_torch.io import simulate as tsim
from lidar_slam_tpu_torch.models import graph_slam as tgs
from lidar_slam_tpu_torch.models import posegraph as tpg
from lidar_slam_tpu_torch.models.submap_graph_slam import SubmapGraphSlam
from lidar_slam_tpu_torch.utils.metrics import ate

PATH_TOL = 1e-5
GRAPH_TOL = 1e-3


@pytest.fixture(scope="module")
def runs():
    ranges, gt = jsim.generate_dataset(200, seed=1,
                                       waypoints=jsim.LOOP_WAYPOINTS)
    jg = JSGS(JCFG, jgs.LoopClosureConfig(min_gap=3))
    jpath, jopt = jg.run(ranges, chunk_size=32)
    tg = SubmapGraphSlam(TCFG, tgs.LoopClosureConfig(min_gap=3), device="cpu")
    tpath, topt = tg.run(ranges, chunk_size=32)
    return (tg, tpath, topt), (jg, jpath, jopt), gt


def test_submap_graph_run_matches_jax(runs):
    (tg, tpath, topt), (jg, jpath, jopt), gt = runs
    assert tg.kf.count == jg.kf.count > 15
    assert len(tg.closures) >= 1
    assert tg.closures == jg.closures
    assert tg._epoch == jg._epoch >= 1          # a feedback happened
    assert tg.path_epoch == jg.path_epoch
    np.testing.assert_allclose(tpath, jpath, atol=PATH_TOL, rtol=0)
    np.testing.assert_allclose(topt, jopt, atol=GRAPH_TOL, rtol=0)
    assert ate(tpath, gt) < 0.05


def test_anchor_association_matches_jax(runs):
    """Every submap tied to the same keyframe by the same rigid relation,
    and the final anchors (re-anchored by the feedback) alike."""
    (tg, _, _), (jg, _, _), _ = runs
    n = tg.final_state.atlas.n_submaps
    assert n >= 2
    assert set(tg.anchor_assoc) == set(range(n))
    for s in range(n):
        i, rel = tg.anchor_assoc[s]
        j, jrel = jg.anchor_assoc[s]
        assert i == j
        np.testing.assert_allclose(rel, jrel, atol=GRAPH_TOL, rtol=0)
    np.testing.assert_allclose(
        tg.final_state.atlas.anchors[:n].numpy(),
        np.asarray(jg.final_state.atlas.anchors)[:n], atol=GRAPH_TOL, rtol=0)


def test_world_map_matches_jax(runs):
    (tg, _, _), (jg, _, _), _ = runs
    got = tg.world_map(tg.final_state)
    want = jg.world_map(jg.final_state)
    assert len(got) > 100 and np.isfinite(got).all()
    # the port's last chunk runs its real scans only; JAX repeats the last
    # scan to pad it, which can add a few points to the active submap
    assert len(want) >= len(got)
    order = lambda p: p[np.lexsort(p.T)]  # noqa: E731
    np.testing.assert_allclose(order(got), order(want[:len(got)]),
                               atol=GRAPH_TOL, rtol=0)


@pytest.mark.slow
def test_submap_graph_slam_closes_and_reanchors():
    """tests/test_submap_graph_slam.py's loop-300 pins on the port."""
    import dataclasses

    from lidar_slam_tpu_torch.config import SubmapConfig

    cfg = dataclasses.replace(TCFG, submaps=SubmapConfig(
        n_submaps=32, submap_capacity=4096, k_nearest=8, spawn_dist=2.0))
    ranges, gt = tsim.generate_dataset(n_scans=300, seed=1,
                                       waypoints=tsim.LOOP_WAYPOINTS)
    gs = SubmapGraphSlam(cfg, device="cpu")
    path, _ = gs.run(ranges)
    assert int(gs.kf.count) >= 10
    assert len(gs.closures) >= 1, "no loop closures on a loop trajectory"
    err = float(tpg.graph_error(gs.graph))
    assert err / max(int(gs.graph.n_edges), 1) < 1.0
    assert ate(path, gt) < 0.1
    n_sub = gs.final_state.atlas.n_submaps
    assert n_sub >= 2
    assert set(gs.anchor_assoc) >= set(range(n_sub))
    pts = gs.world_map(gs.final_state)
    assert len(pts) > 100 and np.isfinite(pts).all()
    assert np.abs(pts).max() < np.abs(gt[:, :2]).max() + 30.0
