"""The captured graph backend on the CPU, where the runner calls the same
bodies uncaptured on the same static buffers (``utils/graphs``): each
equals its eager version bit for bit.

- ``GraphSlam``'s batched helpers (``graph_slam._Backend``: keyframe
  rasters, closure matching, fine refinement) at every bucket width
  B = 1..8, two batches a width through the same buffers, against
  ``_raster_edt_batch``, ``_match_keyframes_batch`` and
  ``_refine_rel_batch`` on the same rows;
- ``posegraph.OptimizeFn`` robust and not, refilled from host arrays and
  copied from a graph, against ``posegraph.optimize``;
- PF-graph's re-raster around two keyframes against ``_reraster``;
- ``ba.optimize_ba`` against ``ba.optimize_ba_eager`` on two problems of
  one shape and two iteration counts;
- whole ``GraphSlam``, ``SubmapGraphSlam`` and ``PFGraphSlam`` runs (JAX's
  draws injected, and the port's generator) against ``eager=True``, with
  and without feedback: path, keyframe poses, closures, weak closures and
  the attempt log.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _backend_cases as cases
from _torch_util import assert_tree_equal
from lidar_slam_tpu.io import simulate as jsim
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu_torch.core.gridmap import PointMap
from lidar_slam_tpu_torch.models import ba, posegraph
from lidar_slam_tpu_torch.models import graph_slam as tgs
from lidar_slam_tpu_torch.models import pf_graph_slam as tpfg
from lidar_slam_tpu_torch.models.submap_graph_slam import SubmapGraphSlam

LC = tgs.LoopClosureConfig()
FINE = dict(pixel=LC.fine_pixel, size=LC.fine_size, iters=LC.fine_iters,
            step_t0=LC.fine_step_t0, step_r0=LC.fine_step_r0,
            max_range=LC.fine_range)


@pytest.fixture(scope="module")
def scans():
    return cases.keyframes("cpu")


def _backend(scans):
    x, y, v, _ = scans
    return tgs._Backend(cases.store(x, y, v), LC, cases.N_KEYFRAMES,
                        torch.device("cpu"), eager=False)


@pytest.mark.parametrize("b", cases.WIDTHS)
def test_raster_edt_batch_captured_equals_eager(scans, b):
    x, y, v, _ = scans
    backend = _backend(scans)
    for olds, _ in cases.batches(b):
        backend.raster(olds)
        want = tgs._raster_edt_batch(x[olds], y[olds], v[olds],
                                     LC.raster_size, LC.raster_pixel)
        assert torch.equal(backend.store.metric[olds], want)
    untouched = sorted(set(range(cases.N_KEYFRAMES))
                       - {i for olds, _ in cases.batches(b) for i in olds})
    assert not backend.store.metric[untouched].any()


@pytest.mark.parametrize("b", cases.WIDTHS)
def test_match_keyframes_batch_captured_equals_eager(scans, b):
    x, y, v, gt = scans
    backend = _backend(scans)
    metric = backend.store.metric
    metric.copy_(tgs._raster_edt_batch(x, y, v, LC.raster_size,
                                       LC.raster_pixel))
    for seed, (olds, curs) in enumerate(cases.batches(b)):
        g = cases.guesses(gt, olds, curs, seed)
        got = backend.match(olds, curs, g)
        want = tgs._match_keyframes_batch(metric[olds], x[curs], y[curs],
                                          v[curs], torch.as_tensor(g), LC)
        assert got.shape == (b, 6) and torch.equal(got, want)


@pytest.mark.parametrize("b", cases.WIDTHS)
def test_refine_rel_batch_captured_equals_eager(scans, b):
    x, y, v, gt = scans
    backend = _backend(scans)
    for seed, (olds, curs) in enumerate(cases.batches(b)):
        g = cases.guesses(gt, olds, curs, seed)
        got = backend.refine(olds, curs, g)
        want = tgs._refine_rel_batch(x[olds], y[olds], v[olds], x[curs],
                                     y[curs], v[curs], torch.as_tensor(g),
                                     **FINE)
        assert got.shape == (b, 3) and torch.equal(got, want)


@pytest.mark.parametrize("robust", [True, False])
def test_optimize_captured_equals_eager(robust):
    """Two graphs through one ``OptimizeFn``: one loaded from host arrays,
    one passed as device tensors and copied in."""
    fn = posegraph.OptimizeFn(32, 80, "cpu")
    for seed in (0, 1):
        arrays = cases.pose_graph_arrays(seed)
        g = fn.load(arrays) if seed == 0 else cases.pose_graph(arrays, "cpu")
        got = fn(g, iters=10, robust=robust)
        want = posegraph.optimize(cases.pose_graph(arrays, "cpu"), iters=10,
                                  robust=robust)
        assert got.poses is fn.poses
        assert torch.equal(got.poses, want.poses)
        assert_tree_equal(got._replace(poses=want.poses), want)


def test_reraster_captured_equals_eager(scans):
    """The re-raster of a rebuilt map around two keyframes, through the
    same buffers; the results are the caller's own tensors."""
    x, y, v, gt = scans
    gs = tpfg.PFGraphSlam(DEFAULT_CONFIG, max_keyframes=cases.N_KEYFRAMES,
                          device="cpu")
    gs._kf_dx.copy_(x)
    gs._kf_dy.copy_(y)
    gs._kf_dv.copy_(v)
    xy, size = tgs._rebuilt_map_points(x.numpy(), y.numpy(), v.numpy(),
                                       gt.astype(np.float32), 8192)
    outs = []
    for k in (3, 11):
        pose = torch.as_tensor(gt[k], dtype=torch.float32)
        pmap = PointMap(xy=torch.as_tensor(xy),
                        size=torch.as_tensor(np.int32(size)),
                        keyframe_pose=pose)
        got = gs._rerastered(pmap, k)
        want = tpfg._reraster(pmap, x[k], y[k], v[k], pose, DEFAULT_CONFIG)
        assert_tree_equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        outs.append(got)
    assert not torch.equal(outs[0][1], outs[1][1])


def test_optimize_ba_captured_equals_eager():
    """Two problems of one shape through the same graph and buffers, and
    a second iteration count; the caller's problem is left as it was."""
    problems = cases.ba_problems("cpu")
    for iters in (3, 2):
        for p in problems:
            start = [t.clone() for t in p]
            got = ba.optimize_ba(p, iters=iters)
            want = ba.optimize_ba_eager(p, iters=iters)
            assert_tree_equal(got, want)
            assert all(torch.equal(a, b) for a, b in zip(start, p))
    assert not torch.equal(ba.optimize_ba(problems[0], 2).poses,
                           ba.optimize_ba(problems[1], 2).poses)


# ---- whole runs

N_LOOP = 160      # loop-tour scans: 19 keyframes, 3 closures, 1 feedback
CHUNK = 32


@pytest.fixture(scope="module")
def loop_tour():
    return jsim.generate_dataset(N_LOOP, seed=1,
                                 waypoints=jsim.LOOP_WAYPOINTS)


def _assert_backends_equal(runs):
    (g, path, opt), (e, epath, eopt) = runs
    assert np.array_equal(path, epath)
    assert np.array_equal(opt, eopt)
    assert g.kf.count == e.kf.count
    assert g.closures == e.closures and g.weak_closures == e.weak_closures
    assert g.attempt_log == e.attempt_log
    assert g.closure_rejects == e.closure_rejects
    assert g.path_epoch == e.path_epoch


@pytest.mark.parametrize("feedback", [True, False])
@pytest.mark.parametrize("cls", [tgs.GraphSlam, SubmapGraphSlam],
                         ids=["graph", "submap-graph"])
def test_graph_run_captured_backend_equals_eager(loop_tour, cls, feedback):
    ranges, _ = loop_tour
    lc = tgs.LoopClosureConfig(min_gap=3)
    runs = []
    for eager in (False, True):
        gs = cls(DEFAULT_CONFIG, lc, device="cpu", eager=eager)
        path, opt = gs.run(ranges, chunk_size=CHUNK, feedback=feedback)
        runs.append((gs, path, opt))
    _assert_backends_equal(runs)
    gs = runs[0][0]
    assert len(gs.closures) >= 1 and len(gs.attempt_log) > len(gs.closures)
    assert (gs._epoch >= 1) == feedback


def _jax_draws(n, p, seed=0):
    key = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(n):
        key, k_noise, k_res = jax.random.split(key, 3)
        draws.append((np.array(jax.random.normal(k_noise, (p, 3))),
                      np.array(jax.random.uniform(k_res, (), minval=0.0,
                                                  maxval=1.0 / p))))
    return draws


@pytest.mark.parametrize("feedback", [True, False])
@pytest.mark.parametrize("draws_from", ["jax", "generator"])
def test_pf_graph_run_captured_backend_equals_eager(draws_from, feedback):
    """PF-graph, 96 loop-tour scans, 32 particles: the re-raster runs at
    every feedback."""
    p = 32
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=p))
    ranges, _ = jsim.generate_dataset(96, seed=0,
                                      waypoints=jsim.LOOP_WAYPOINTS)
    draws = _jax_draws(len(ranges) - 1, p) if draws_from == "jax" else None
    lc = tgs.LoopClosureConfig(weak_closures=True, min_gap=3)
    runs = []
    for eager in (False, True):
        gs = tpfg.PFGraphSlam(cfg, lc, seed=2, device="cpu", draws=draws,
                              eager=eager)
        path, opt = gs.run(ranges, chunk_size=CHUNK, feedback=feedback)
        runs.append((gs, path, opt))
    _assert_backends_equal(runs)
    gs = runs[0][0]
    assert len(gs.attempt_log) >= 1
    assert (gs._epoch >= 1) == (feedback and bool(gs.closures))
