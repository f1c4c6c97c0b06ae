"""End-to-end parity of the port's fidelity pipeline: bit-identical
trajectories against the C++ oracle and JAX ``run_scan``, on the small
museum dataset and on the building tour (512^2 fine grid): its 200-scan
prefix, its first 1000 scans with the parity and the wide window, and
(slow) the whole 3800-scan tour with each (the twins of
``tests/test_pipeline_parity.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import assert_tree_equal, jax_slam_state, to_numpy_tree
from lidar_slam_tpu import native
from lidar_slam_tpu.config import (BUILDING_CONFIG, BUILDING_WIDE_CONFIG,
                                   DEFAULT_CONFIG)
from lidar_slam_tpu.models import scan_matcher as jsm
from lidar_slam_tpu_torch.models import scan_matcher as tsm
from lidar_slam_tpu_torch.models import state_io
from lidar_slam_tpu_torch.utils.metrics import ate


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


def _building():
    from lidar_slam_tpu.io import dataset, simulate

    ranges, gt, _ = dataset.ensure_dataset(
        n_scans=simulate.BUILDING_N_SCANS, world="building")
    return ranges, gt


def test_building_wide_window_prefix():
    """The first 1000 building scans (the first hard corridor turns): the
    parity window's path equals the oracle's, the wide window's equals
    JAX ``run_scan``'s; the parity window has lost over twice the wide
    window's error, which stays under 0.2 m."""
    ranges, gt = _building()
    n = 1000
    narrow, _ = tsm.run_scan(ranges[:n], BUILDING_CONFIG, device="cpu")
    cpath, _ = native.run_oracle_cfg(ranges[:n], BUILDING_CONFIG)
    assert np.array_equal(narrow.numpy(), cpath)
    wide, _ = tsm.run_scan(ranges[:n], BUILDING_WIDE_CONFIG, device="cpu")
    jwide, _ = jsm.run_scan(ranges[:n], BUILDING_WIDE_CONFIG)
    assert np.array_equal(wide.numpy(), np.asarray(jwide))
    e_wide = ate(wide.numpy(), gt[:n])
    e_narrow = ate(narrow.numpy(), gt[:n])
    assert e_wide < 0.2
    assert e_narrow > 2.0 * e_wide


@pytest.mark.slow
def test_building_3800_bit_exact():
    """The whole tour with the parity window: equal to the oracle bit for
    bit, drifting as the oracle does in the 60 m corridor (3 to 8 m)."""
    ranges, gt = _building()
    cpath, _ = native.run_oracle_cfg(ranges, BUILDING_CONFIG)
    path, _ = tsm.run_scan(ranges, BUILDING_CONFIG, device="cpu")
    assert np.array_equal(path.numpy(), cpath)
    assert 3.0 < ate(cpath, gt) < 8.0


@pytest.mark.slow
def test_building_3800_wide_window_solves_tour():
    """The whole tour with the wide window: ATE < 0.5 m (the JAX test's
    bar), and the path equal to JAX ``run_scan``'s but at one scan.

    Measured on the CPU: scan 3149 of 3800 differs by one fine step
    (0.025 m in y) and every later pose is equal again. The states before
    it are equal except the map points, which JAX's jitted step computes
    with fused multiply-adds (within 3.8e-6; see
    ``test_slam_step_from_mid_run_jax_state``): the keyframe raster rebuilt
    from them at scan 3149 moves the wide window's argmin. The port keeps
    the oracle's unfused arithmetic, so this pins that one scan."""
    ranges, gt = _building()
    path, _ = tsm.run_scan(ranges, BUILDING_WIDE_CONFIG, device="cpu")
    jpath, _ = jsm.run_scan(ranges, BUILDING_WIDE_CONFIG)
    diff = np.abs(path.numpy() - np.asarray(jpath)).max(axis=1)
    assert np.flatnonzero(diff).tolist() == [3149]
    assert diff.max() <= BUILDING_WIDE_CONFIG.matcher.fine_t
    assert ate(path.numpy(), gt) < 0.5


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
