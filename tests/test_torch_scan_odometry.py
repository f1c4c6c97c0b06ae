"""The port's batched scan-to-scan matching against
``lidar_slam_tpu.ops.scan_odometry``.

Rasters are compared exactly. Odometry deltas agree to 1e-5: both sides run
the same descent over the same exact EDT sums, but XLA:CPU may contract the
range gate's ``x*x + y*y`` into a fused multiply-add, which can move a point
at exactly the gate radius.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import to_numpy_tree  # noqa: F401  (caps torch threads)
from lidar_slam_tpu.config import LidarConfig
from lidar_slam_tpu.core.sensor import beam_angles
from lidar_slam_tpu.ops import scan_odometry as jso
from lidar_slam_tpu_torch.core import sensor as tsensor
from lidar_slam_tpu_torch.io import simulate as tsim
from lidar_slam_tpu_torch.ops import edt as tedt
from lidar_slam_tpu_torch.ops import matching as tm
from lidar_slam_tpu_torch.ops import scan_odometry as tso

CFG = LidarConfig()


@pytest.fixture(scope="module")
def museum20():
    ranges, gt = tsim.generate_dataset(20, seed=3)
    return ranges, gt


def test_raster_centered_matches_jax(museum20):
    """Real scans plus points beyond the extent on every side, which must
    be dropped (never wrapped to the opposite edge)."""
    ranges, _ = museum20
    angles = torch.as_tensor(beam_angles(CFG))
    scans = [tsensor.read_scan(torch.as_tensor(r), angles, CFG)
             for r in ranges[:3]]
    x = torch.stack([s.x for s in scans])
    y = torch.stack([s.y for s in scans])
    v = torch.stack([s.valid for s in scans])
    x[:, :4] = torch.tensor([-30.0, 30.0, 0.5, 0.0])
    y[:, :4] = torch.tensor([0.0, 0.0, -30.0, 30.0])
    got = tso._raster_centered(x, y, v, 0.05, 448)
    for b in range(3):
        want = jso._raster_centered(jnp.asarray(x[b].numpy()),
                                    jnp.asarray(y[b].numpy()),
                                    jnp.asarray(v[b].numpy()), 0.05, 448)
        assert np.array_equal(got.occ[b].numpy(), np.asarray(want.occ))
        assert np.array_equal(got.origin.numpy(), np.asarray(want.origin))
    assert int(got.n_rows) == int(got.n_cols) == 448


def test_descend_equals_fast_match_loop(museum20):
    """The batched descent takes exactly the poses of a loop of the port's
    own ``matching.fast_match`` calls with halving steps."""
    ranges, _ = museum20
    angles = torch.as_tensor(beam_angles(CFG))
    s0 = [tsensor.read_scan(torch.as_tensor(r), angles, CFG)
          for r in ranges[:4]]
    s1 = [tsensor.read_scan(torch.as_tensor(r), angles, CFG)
          for r in ranges[1:5]]
    x0, y0, v0 = (torch.stack([getattr(s, f) for s in s0])
                  for f in ("x", "y", "valid"))
    x1, y1, v1 = (torch.stack([getattr(s, f) for s in s1])
                  for f in ("x", "y", "valid"))
    grid = tso._raster_centered(x0, y0, v0, 0.05, 448)
    metric = tedt.edt(grid.occ)
    guess = torch.tensor([[0.01, -0.02, 0.003]] * 4)
    got = tso._descend(metric, grid, x1, y1, v1, guess, 5, 0.03, 0.03)
    for b in range(4):
        g1 = grid._replace(occ=grid.occ[b])
        pose, st, sr = guess[b], 0.03, 0.03
        for _ in range(5):
            pose = tm.fast_match(metric[b], g1, x1[b], y1[b], v1[b], pose,
                                 st, sr).pose
            st, sr = st * 0.5, sr * 0.5
        assert torch.equal(got[b], pose)


def test_pairwise_odometry_matches_jax(museum20):
    """20 museum scans (19 pairs in one batch): deltas within 1e-5."""
    ranges, gt = museum20
    angles = beam_angles(CFG)
    got = tso.pairwise_odometry(torch.as_tensor(ranges),
                                torch.as_tensor(angles), CFG, chunk=19)
    want = np.asarray(jso.pairwise_odometry(
        jnp.asarray(ranges), jnp.asarray(angles), CFG, chunk=19))
    assert got.shape == (19, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # and the deltas are the tour's motion
    assert np.abs(want[:, :2]).max() > 0.01
    assert tso.reach_clip_fraction(got.numpy()) == \
        jso.reach_clip_fraction(want)


def test_reach_clip_fraction_and_guard():
    rng = np.random.default_rng(5)
    deltas = rng.uniform(-0.06, 0.06, (50, 3)).astype(np.float32)
    assert tso.reach_clip_fraction(deltas) == jso.reach_clip_fraction(deltas)
    assert tso.reach_clip_fraction(np.zeros((0, 3))) == 0.0
    with pytest.raises(ValueError, match="half-extent"):
        tso.pairwise_odometry(torch.zeros((3, CFG.n_beams)),
                              torch.zeros(CFG.n_beams), CFG, max_range=12.0)
