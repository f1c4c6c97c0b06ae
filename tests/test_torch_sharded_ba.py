"""The port's matrix-free sharded BA against the dense port, the JAX
package's ``optimize_ba_sharded`` on the 8-device virtual mesh, and the
property that no (K, K)- or (L, K)-shaped tensor exists (the counterpart of
``tests/test_sharded_ba.py``, whose HLO-text check becomes a record of
every tensor shape the call's aten ops produce). A gloo world of one;
worlds of 2 and 4 are in ``tests/test_torch_multiprocess.py``.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_util  # noqa: F401  (caps torch's threads)
from lidar_slam_tpu.parallel import sharded_ba as jsba
from lidar_slam_tpu_torch.models import ba as tba
from lidar_slam_tpu_torch.models import state_io
from lidar_slam_tpu_torch.parallel import multihost, sharded_ba
from lidar_slam_tpu_torch.utils.profiling import tensor_shapes
from test_ba import _make_problem

DENSE_TOL = 5e-3   # the JAX test's bar against the dense solver
# against JAX's sharded solver at the same iterations: 9.54e-7 measured
# (K = 12, 13 and 512, 8 to 15 iterations), pinned at about 10x
JAX_TOL = 1e-5


@pytest.fixture(scope="module")
def axis():
    assert multihost.initialize(device_type="cpu") == (0, 1)
    yield sharded_ba.make_graph_mesh("cpu")
    multihost.shutdown()


def _port(prob):
    return state_io.ba_problem_from_numpy(
        tba.BAProblem(*[np.asarray(a) for a in prob]), "cpu")


@pytest.mark.parametrize("kwargs,iters", [({}, 12),
                                          (dict(n_poses=13, n_lms=7,
                                                seed=2), 8)])
def test_matches_dense_and_jax(axis, kwargs, iters):
    """K, L, E, F divisible or not by JAX's 8 shards (the second case pads):
    within DENSE_TOL of the dense ``optimize_ba``, within JAX_TOL of JAX's
    ``optimize_ba_sharded`` at the same iterations."""
    prob, _, _ = _make_problem(**kwargs)
    tp = _port(prob)
    got = sharded_ba.optimize_ba_sharded(tp, axis, iters=iters)
    assert got.poses.shape == tp.poses.shape
    assert got.landmarks.shape == tp.landmarks.shape
    dense = tba.optimize_ba(tp, iters=iters)
    np.testing.assert_allclose(got.poses.numpy(), dense.poses.numpy(),
                               atol=DENSE_TOL, rtol=0)
    np.testing.assert_allclose(got.landmarks.numpy(), dense.landmarks.numpy(),
                               atol=DENSE_TOL, rtol=0)
    jout = jsba.optimize_ba_sharded(
        prob, jsba.make_graph_mesh(jax.devices()[:8]), iters=iters)
    diff = max(
        np.abs(got.poses.numpy() - np.asarray(jout.poses)).max(),
        np.abs(got.landmarks.numpy() - np.asarray(jout.landmarks)).max())
    print(f"sharded BA port vs JAX: max {diff:.3g}")
    assert diff <= JAX_TOL


def test_converges_to_ground_truth(axis):
    prob, gt_poses, gt_lms = _make_problem(seed=1)
    tp = _port(prob)
    out = sharded_ba.optimize_ba_sharded(tp, axis, iters=15)
    e0, e1 = float(tba.ba_error(tp)), float(tba.ba_error(out))
    assert e1 < e0 * 0.05, (e0, e1)
    assert np.abs(out.poses.numpy()[:, :2] - gt_poses[:, :2]).max() < 0.05
    assert np.abs(out.landmarks.numpy() - gt_lms).max() < 0.05


def test_pad_problem_uneven():
    prob, _, _ = _make_problem(n_poses=13, n_lms=7, seed=2)
    tp = _port(prob)
    pp = sharded_ba.pad_problem(tp, 8)
    k, l = tp.poses.shape[0], tp.landmarks.shape[0]
    e, f = tp.odo_i.shape[0], tp.obs_i.shape[0]
    assert pp.poses.shape[0] % 8 == 0 and pp.poses.shape[0] >= k
    assert pp.landmarks.shape[0] % 8 == 0 and pp.landmarks.shape[0] >= l
    assert pp.odo_i.shape[0] % 8 == 0 and pp.obs_i.shape[0] % 8 == 0
    assert not pp.pose_active[k:].any() and not pp.lm_active[l:].any()
    assert not pp.odo_active[e:].any() and not pp.obs_active[f:].any()
    assert pp.pose_active.dtype == torch.bool
    assert torch.equal(pp.poses[:k], tp.poses)


def test_no_k2_intermediate(axis):
    """K = 256, L = 32: no tensor produced during the call has two
    256-long axes or starts (32, 256); the dense solver, recorded the
    same way, does (the record sees what it must)."""
    k, l, e, f = 256, 32, 255, 64
    rng = np.random.default_rng(0)
    b = torch.bool
    prob = tba.BAProblem(
        poses=torch.as_tensor(rng.normal(0, 1, (k, 3)), dtype=torch.float32),
        landmarks=torch.as_tensor(rng.normal(0, 1, (l, 2)),
                                  dtype=torch.float32),
        pose_active=torch.ones(k, dtype=b), lm_active=torch.ones(l, dtype=b),
        odo_i=torch.arange(e, dtype=torch.int32),
        odo_j=torch.arange(1, e + 1, dtype=torch.int32),
        odo_z=torch.zeros((e, 3)), odo_w=torch.ones((e, 3)),
        odo_active=torch.ones(e, dtype=b),
        obs_i=torch.as_tensor(rng.integers(0, k, f), dtype=torch.int32),
        obs_j=torch.as_tensor(rng.integers(0, l, f), dtype=torch.int32),
        obs_z=torch.ones((f, 2)), obs_w=torch.ones((f, 2)),
        obs_active=torch.ones(f, dtype=b))

    def dense_like(shape):
        return shape.count(k) >= 2 or tuple(shape[:2]) == (l, k)

    _, shapes = tensor_shapes(sharded_ba.optimize_ba_sharded, prob, axis,
                              iters=1, cg_iters=8)
    assert (k, 3) in shapes and (l, 2) in shapes
    assert [s for s in shapes if dense_like(s)] == []
    _, dense = tensor_shapes(tba.optimize_ba, prob, iters=1)
    assert any(dense_like(s) for s in dense)


def test_museum_512_matches_jax_and_differs_from_dense_by_the_gauge(axis):
    """The K = 512 museum problem chip_smoke's phase 22 runs, 15 iterations
    of 50 PCG steps: within JAX_TOL of JAX's sharded solver at the same
    steps. Both sharded solvers hold pose 0 exactly, where each package's
    dense solve, whose gauge is a soft 1e6 prior, lets its heading move by
    milliradians; so the sharded and dense results differ by about 1e-2
    in both packages (printed), not within the corridor problem's 5e-3."""
    from lidar_slam_tpu.models import ba as jba
    from lidar_slam_tpu_torch.io import simulate

    p = tba.BAProblem(**simulate.generate_ba_problem())
    tp = state_io.ba_problem_from_numpy(p, "cpu")
    got = sharded_ba.optimize_ba_sharded(tp, axis, iters=15, cg_iters=50)
    jp = jba.BAProblem(*[np.asarray(a) for a in p])
    jout = jsba.optimize_ba_sharded(
        jp, jsba.make_graph_mesh(jax.devices()[:8]), iters=15, cg_iters=50)
    diff = max(
        np.abs(got.poses.numpy() - np.asarray(jout.poses)).max(),
        np.abs(got.landmarks.numpy() - np.asarray(jout.landmarks)).max())
    assert diff <= JAX_TOL, diff
    dense = tba.optimize_ba(tp, iters=15)
    jdense = jba.optimize_ba(jp, iters=15)
    heading = float(dense.poses[0, 2] - tp.poses[0, 2])
    assert torch.equal(got.poses[0], tp.poses[0])
    assert abs(heading) > 1e-3
    e0 = float(tba.ba_error(tp))
    assert float(tba.ba_error(got)) < 0.05 * e0
    jgap = np.abs(np.asarray(jout.poses) - np.asarray(jdense.poses)).max()
    print(f"K=512: port vs JAX sharded {diff:.3g}; sharded vs dense: port "
          f"{float((got.poses - dense.poses).abs().max()):.4g}, JAX "
          f"{jgap:.4g}; the dense solve moved pose 0's heading "
          f"{heading:.4g} rad")
