"""The port's correlative matcher against ``lidar_slam_tpu.ops.matching``:
candidate order, scores, first-minimum argmin and the bestHits aliasing,
all exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import jax_grid
from lidar_slam_tpu.config import DEFAULT_CONFIG
from lidar_slam_tpu.core.gridmap import OccGrid as JGrid
from lidar_slam_tpu.ops import matching as jm
from lidar_slam_tpu_torch.core import sensor as tsensor
from lidar_slam_tpu_torch.core.gridmap import OccGrid as TGrid
from lidar_slam_tpu_torch.models import scan_matcher as tsm
from lidar_slam_tpu_torch.models import state_io
from lidar_slam_tpu_torch.ops import matching as tm


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_match_equal(t, j):
    for f in t._fields:
        assert np.array_equal(_np(getattr(t, f)), np.asarray(getattr(j, f))), f


@pytest.fixture(scope="module")
def keyframe(small_dataset):
    """A real keyframe: the port's state after 12 scans (its rasters and EDT
    fields) and the next scan."""
    ranges, _ = small_dataset
    path, state = tsm.run_scan(ranges[:12], DEFAULT_CONFIG, device="cpu")
    scan = tsensor.read_scan(torch.as_tensor(ranges[12]),
                             tsm.angles_tensor(DEFAULT_CONFIG, "cpu"),
                             DEFAULT_CONFIG.lidar)
    return state, scan


def _both(state, scan, which):
    grid = getattr(state, which)
    metric = getattr(state, which + "_metric")
    g_np = state_io.grid_to_numpy(grid)
    jgrid = jax_grid(g_np._replace(pixel=grid.pixel))
    return (metric, grid, scan), (jnp.asarray(metric.numpy()), jgrid,
                                  tuple(jnp.asarray(_np(v)) for v in scan))


@pytest.mark.parametrize("wt,wr", [(1, 1), (2, 2), (3, 1)])
def test_candidate_grid_order(wt, wr):
    pose = np.asarray([1.0, -2.0, 0.3], np.float32)
    got = tm.candidate_grid_ref(torch.as_tensor(pose), 0.05, 0.008727, wt, wr)
    want = jm.candidate_grid_ref(jnp.asarray(pose), 0.05, 0.008727, wt, wr)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["coarse", "fine"])
def test_score_candidates_matches_jax(keyframe, which):
    state, scan = keyframe
    (m, g, s), (jmet, jg, js) = _both(state, scan, which)
    poses = tm.candidate_grid_ref(state.pose, 0.05, 0.008727, 2, 2)
    got = tm.score_candidates(m, g, s.x, s.y, s.valid, poses)
    want = jm.score_candidates(jmet, jg, js[0], js[1], js[2],
                               jnp.asarray(poses.numpy()))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("which,window", [("coarse", 1), ("fine", 1),
                                          ("fine", 2)])
def test_fast_match_matches_jax(keyframe, which, window):
    state, scan = keyframe
    (m, g, s), (jmet, jg, js) = _both(state, scan, which)
    guess = state.pose + torch.tensor([0.03, -0.02, 0.004])
    got = tm.fast_match(m, g, s.x, s.y, s.valid, guess, 0.05, 0.008727,
                        window, window, 4.0)
    want = jm.fast_match(jmet, jg, js[0], js[1], js[2],
                         jnp.asarray(guess.numpy()), 0.05, 0.008727,
                         window, window, 4.0)
    _assert_match_equal(got, want)


def _toy():
    """A 32x32 field whose rows 1..30 all hold 1.0, and a scan of 6 points."""
    metric = np.zeros((32, 32), np.float32)
    metric[1:31, :] = 1.0
    xs = np.asarray([0.5, 0.9, 1.3, 1.7, 2.1, 2.5], np.float32)
    ys = np.full(6, 1.5, np.float32)
    valid = np.ones(6, bool)
    return metric, xs, ys, valid


def _grids(n_rows, n_cols):
    z = np.zeros((32, 32), bool)
    org = np.zeros(2, np.float32)
    t = TGrid(torch.as_tensor(z), torch.tensor(n_rows, dtype=torch.int32),
              torch.tensor(n_cols, dtype=torch.int32), torch.as_tensor(org), 0.1)
    j = JGrid(jnp.asarray(z), jnp.int32(n_rows), jnp.int32(n_cols),
              jnp.asarray(org), 0.1)
    return t, j


def test_exact_tie_takes_first_minimum():
    """Every candidate scores exactly the same (a flat field): both packages
    must return the first candidate in loop order."""
    metric, xs, ys, valid = _toy()
    tg, jg = _grids(32, 32)
    pose = np.asarray([0.2, 0.2, 0.0], np.float32)
    got = tm.fast_match(torch.as_tensor(metric), tg, torch.as_tensor(xs),
                        torch.as_tensor(ys), torch.as_tensor(valid),
                        torch.as_tensor(pose), 0.05, 0.01)
    want = jm.fast_match(jnp.asarray(metric), jg, jnp.asarray(xs),
                         jnp.asarray(ys), jnp.asarray(valid),
                         jnp.asarray(pose), 0.05, 0.01)
    _assert_match_equal(got, want)
    first = tm.candidate_grid_ref(torch.as_tensor(pose), 0.05, 0.01)[0]
    assert torch.equal(got.pose, first)


def test_last_hits_and_best_count_aliasing():
    """``last_hits`` is compacted from the LAST candidate while
    ``best_count`` is the BEST candidate's in-bounds count: a bounds edge
    that cuts the last candidate's points makes the two differ."""
    metric, xs, ys, valid = _toy()
    metric[:, 20:] = 0.0          # cheap columns on the right...
    tg, jg = _grids(32, 26)      # ...but the column bound cuts at 25
    pose = np.asarray([0.25, 0.0, 0.0], np.float32)
    args_t = (torch.as_tensor(metric), tg, torch.as_tensor(xs),
              torch.as_tensor(ys), torch.as_tensor(valid),
              torch.as_tensor(pose), 0.1, 0.01)
    got = tm.fast_match(*args_t)
    want = jm.fast_match(jnp.asarray(metric), jg, jnp.asarray(xs),
                         jnp.asarray(ys), jnp.asarray(valid),
                         jnp.asarray(pose), 0.1, 0.01)
    _assert_match_equal(got, want)
    n_last = int(got.last_inb.sum())
    assert int(got.best_count) != n_last
    assert not got.last_hits[n_last:].any()
