"""The port's SE(2) algebra and pose graph against
``lidar_slam_tpu.core.se2`` and ``lidar_slam_tpu.models.posegraph``.

The Gauss-Newton solve is float32 in both packages, with Jacobians taken in
closed form here and by ``jacfwd`` there, and the normal equations summed in
another order, so optimized poses agree to 1e-4 (absolute, on poses of a
few metres), not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import to_numpy_tree
from lidar_slam_tpu.core import se2 as jse2
from lidar_slam_tpu.models import posegraph as jpg
from lidar_slam_tpu_torch.core import se2 as tse2
from lidar_slam_tpu_torch.models import posegraph as tpg
from lidar_slam_tpu_torch.models import state_io


def _random_graph(seed=0, k=24, e=60, kmax=32, emax=80):
    """A random connected graph: an odometry chain plus random extra edges,
    noisy measurements, a spread of weights, padded to capacity."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((kmax, 3), np.float32)
    poses[:k] = rng.normal(0, 2, (k, 3)).astype(np.float32)
    ei = np.zeros(emax, np.int32)
    ej = np.zeros(emax, np.int32)
    ei[:k - 1], ej[:k - 1] = np.arange(k - 1), np.arange(1, k)
    ei[k - 1:e] = rng.integers(0, k, e - k + 1)
    ej[k - 1:e] = rng.integers(0, k, e - k + 1)
    ez = np.zeros((emax, 3), np.float32)
    ez[:e] = rng.normal(0, 1, (e, 3))
    ew = np.ones((emax, 3), np.float32)
    ew[:e] = rng.uniform(1, 100, (e, 3))
    return jpg.PoseGraph(
        poses=jnp.asarray(poses), node_active=jnp.asarray(np.arange(kmax) < k),
        n_nodes=jnp.int32(k), edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
        edge_z=jnp.asarray(ez), edge_w=jnp.asarray(ew),
        edge_active=jnp.asarray(np.arange(emax) < e), n_edges=jnp.int32(e))


def test_se2_compose_between_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(0, 3, (50, 3)).astype(np.float32)
    b = rng.normal(0, 3, (50, 3)).astype(np.float32)
    for tf, jf in ((tse2.compose, jse2.compose), (tse2.between, jse2.between),
                   (tse2.compose_ref, jse2.compose_ref),
                   (tse2.between_ref, jse2.between_ref)):
        np.testing.assert_allclose(
            tf(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
            np.asarray(jf(jnp.asarray(a), jnp.asarray(b))), atol=1e-5, rtol=0)
    x, y = rng.normal(0, 5, (2, 50)).astype(np.float32)
    for got, want in zip(
            tse2.transform(torch.as_tensor(x), torch.as_tensor(y),
                           torch.as_tensor(a[0])),
            jse2.transform(jnp.asarray(x), jnp.asarray(y), jnp.asarray(a[0]))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_jacobians_match_jacfwd():
    """Closed-form edge Jacobians against JAX's vmapped ``jacfwd`` of the
    same residual, to 1e-5."""
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 3, (40, 3)).astype(np.float32)
    xj = rng.normal(0, 3, (40, 3)).astype(np.float32)
    z = rng.normal(0, 1, (40, 3)).astype(np.float32)
    ji, jj = jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=(0, 1)))(
        jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(z))
    ti, tj = tpg._edge_jacobians(torch.as_tensor(xi), torch.as_tensor(xj))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-5, rtol=0)
    r = tpg._edge_residual(torch.as_tensor(xi), torch.as_tensor(xj),
                           torch.as_tensor(z))
    want = jax.vmap(jpg._edge_residual)(jnp.asarray(xi), jnp.asarray(xj),
                                        jnp.asarray(z))
    np.testing.assert_allclose(r.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed,robust", [(0, True), (1, True), (2, False)])
def test_optimize_and_graph_error_match_jax(seed, robust):
    """K=24, E=60 random graph: 10 iterations, eager and captured
    (``OptimizeFn``, GraphSlam's); poses within 1e-4 and the graph error
    within 1e-4 relative."""
    jg = _random_graph(seed)
    tg = state_io.posegraph_from_numpy(to_numpy_tree(jg), "cpu")
    jo = jpg.optimize(jg, iters=10, robust=robust)
    captured = tpg.OptimizeFn(32, 80, "cpu")(tg, iters=10, robust=robust)
    for to in (tpg.optimize(tg, iters=10, robust=robust), captured):
        np.testing.assert_allclose(to.poses.numpy(), np.asarray(jo.poses),
                                   atol=1e-4, rtol=0)
        for a, b in ((tg, jg), (to, jo)):
            want = float(jpg.graph_error(b))
            assert float(tpg.graph_error(a)) == pytest.approx(want, rel=1e-4)
        assert float(tpg.graph_error(to)) < float(tpg.graph_error(tg))
        # inactive slots untouched, node 0 pinned by the gauge prior
        assert np.array_equal(to.poses[24:].numpy(), tg.poses[24:].numpy())
        np.testing.assert_allclose(to.poses[0].numpy(), tg.poses[0].numpy(),
                                   atol=1e-4)


def test_add_node_and_edge_drop_at_capacity():
    """``add_node``/``add_edge`` against JAX's ``mode="drop"`` versions:
    appends, masked insertion, and nothing written past capacity."""
    jg = jpg.empty_graph(3, 2)
    tg = tpg.empty_graph(3, 2, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(4):
        p = rng.normal(0, 1, 3).astype(np.float32)
        jg, jk = jpg.add_node(jg, jnp.asarray(p))
        tg, tk = tpg.add_node(tg, torch.as_tensor(p))
        assert int(jk) == int(tk)
    for valid in (True, False, True, True):
        z = rng.normal(0, 1, 3).astype(np.float32)
        w = rng.uniform(1, 5, 3).astype(np.float32)
        jg = jpg.add_edge(jg, jnp.int32(0), jnp.int32(2), jnp.asarray(z),
                          jnp.asarray(w), valid)
        tg = tpg.add_edge(tg, 0, 2, torch.as_tensor(z), torch.as_tensor(w),
                          valid)
    got = state_io.posegraph_to_numpy(tg)
    for f, want in zip(jpg.PoseGraph._fields, to_numpy_tree(jg)):
        assert np.array_equal(np.asarray(getattr(got, f)), want), f


def test_posegraph_state_io_round_trip():
    want = to_numpy_tree(_random_graph(4))
    back = state_io.posegraph_to_numpy(state_io.posegraph_from_numpy(want,
                                                                     "cpu"))
    for a, b in zip(back, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)
