"""End-to-end parity of the port's fidelity pipeline: bit-identical
trajectories against the C++ oracle and JAX ``run_scan``, on the small
museum dataset and on the 200-scan building prefix (512^2 fine grid)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import assert_tree_equal, jax_slam_state, to_numpy_tree
from lidar_slam_tpu import native
from lidar_slam_tpu.config import BUILDING_CONFIG, DEFAULT_CONFIG
from lidar_slam_tpu.models import scan_matcher as jsm
from lidar_slam_tpu_torch.models import scan_matcher as tsm
from lidar_slam_tpu_torch.models import state_io


@pytest.fixture(scope="module")
def museum(small_dataset):
    ranges, _ = small_dataset
    cpath, cmap = native.run_oracle(ranges)
    jpath, _ = jsm.run_scan(ranges, DEFAULT_CONFIG)
    return ranges, cpath, cmap, np.asarray(jpath)


def test_run_scan_matches_oracle_and_jax(museum):
    ranges, cpath, cmap, jpath = museum
    path, state = tsm.run_scan(ranges, DEFAULT_CONFIG, device="cpu")
    path = path.numpy()
    assert np.array_equal(path, cpath)
    assert np.array_equal(path, jpath)
    # the map too: the oracle is built with -ffp-contract=off and the port
    # never fuses a multiply-add, so even the map points agree bit for bit
    n = int(state.pmap.size)
    assert n == len(cmap)
    assert np.array_equal(state.pmap.xy[:n].numpy(), cmap)


def test_run_host_loop_matches_oracle(museum):
    ranges, cpath, _, _ = museum
    path, state = tsm.run_host_loop(ranges, DEFAULT_CONFIG, device="cpu")
    assert np.array_equal(path, cpath)
    assert state.step == len(ranges)


def test_building_prefix_bit_exact():
    """200 building scans with BUILDING_CONFIG (256^2 / 512^2 grids, 40k
    map), several keyframe rebuilds, as tests/test_pipeline_parity.py."""
    from lidar_slam_tpu.io import dataset, simulate

    ranges, _, _ = dataset.ensure_dataset(
        n_scans=simulate.BUILDING_N_SCANS, world="building")
    ranges = ranges[:200]
    cpath, _ = native.run_oracle_cfg(ranges, BUILDING_CONFIG)
    jpath, _ = jsm.run_scan(ranges, BUILDING_CONFIG)
    path, state = tsm.run_scan(ranges, BUILDING_CONFIG, device="cpu")
    assert state.fine_metric.shape == (512, 512)
    assert np.array_equal(path.numpy(), cpath)
    assert np.array_equal(path.numpy(), np.asarray(jpath))


@pytest.mark.parametrize("t", [9, 33])
def test_slam_step_from_mid_run_jax_state(small_dataset, t):
    """One step from JAX's state after t scans (converted by state_io):
    the new pose and every state leaf equal JAX's step, and the state
    converts back to JAX's field names and dtypes."""
    ranges, _ = small_dataset
    step = jsm.make_step_fn(DEFAULT_CONFIG)
    jstate = jsm.init_state(jnp.asarray(ranges[0]), DEFAULT_CONFIG)
    for i in range(1, t):
        jstate, _ = step(jstate, jnp.asarray(ranges[i]))
    snap = to_numpy_tree(jstate)
    tstate = state_io.slam_state_from_numpy(snap, "cpu")
    assert_tree_equal(state_io.slam_state_to_numpy(tstate)._replace(
        coarse=None, fine=None), snap._replace(coarse=None, fine=None))
    tnew, tpose = tsm.slam_step(tstate, torch.as_tensor(ranges[t]),
                                DEFAULT_CONFIG,
                                tsm.angles_tensor(DEFAULT_CONFIG, "cpu"))
    jnew, jpose = step(jax_slam_state(snap), jnp.asarray(ranges[t]))
    assert np.array_equal(tpose.numpy(), np.asarray(jpose))
    got = state_io.slam_state_to_numpy(tnew)
    want = to_numpy_tree(jnew)
    for f in ("pose", "prev_pose", "step", "mini_updated", "coarse_metric",
              "fine_metric"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.pmap.size == want.pmap.size
    n = int(got.pmap.size)
    # the world-frame scan and the map use the transform: JAX's jitted step
    # may fuse its multiply-adds (see tests/test_pipeline_parity.py)
    np.testing.assert_allclose(got.pmap.xy[:n], want.pmap.xy[:n], atol=2e-6)
    for g, w in ((got.coarse, want.coarse), (got.fine, want.fine)):
        assert np.array_equal(g.occ, w.occ)
        assert g.n_rows == w.n_rows and g.n_cols == w.n_cols
        np.testing.assert_allclose(g.origin, w.origin, atol=2e-6)
