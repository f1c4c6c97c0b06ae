"""The port's batched scan-to-scan matching against
``lidar_slam_tpu.ops.scan_odometry``.

Rasters are compared exactly. Odometry deltas agree to 1e-5: both sides run
the same descent over the same exact EDT sums, but XLA:CPU may contract the
range gate's ``x*x + y*y`` into a fused multiply-add, which can move a point
at exactly the gate radius. Within the port, the batched ``read_scans``
equals ``read_scan`` row by row, and ``pairwise_odometry``'s chunk runner
(``PairMatcher``, which replays a captured graph a chunk width on the
card) equals the eager chunk loop bit for bit.
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


@pytest.mark.parametrize("rows", ["museum-20", "no valid beam"])
def test_read_scans_equals_read_scan(museum20, rows):
    """The batched read gives every row's x, y, valid and size bit for bit
    as the per-scan call: the museum's scans, and rows with no beam in the
    gate (all short, all long, all zero) among partly gated ones."""
    ranges = torch.as_tensor(museum20[0])
    if rows == "no valid beam":
        ranges = ranges[:6].clone()
        ranges[0] = 0.0
        ranges[2] = CFG.usable_range + 1.0
        ranges[3, ::3] = 0.0
        ranges[4] = CFG.range_min / 2
    angles = torch.as_tensor(beam_angles(CFG))
    got = tsensor.read_scans(ranges, angles, CFG)
    assert got.x.shape == ranges.shape and got.size.shape == ranges.shape[:1]
    for t in range(ranges.shape[0]):
        want = tsensor.read_scan(ranges[t], angles, CFG)
        for f in ("x", "y", "valid", "size"):
            assert torch.equal(getattr(got, f)[t], getattr(want, f)), (t, f)
    if rows == "no valid beam":
        assert got.size[[0, 2, 4]].tolist() == [0, 0, 0]


def _eager_chunk_loop(ranges, angles, chunk, **kw):
    """``pairwise_odometry`` as an eager loop: ``read_scan`` a scan, then
    ``match_batch`` a chunk of pairs."""
    scans = [tsensor.read_scan(r, angles, CFG) for r in ranges]
    x, y, v = (torch.stack([getattr(sc, f) for sc in scans])
               for f in ("x", "y", "valid"))
    n_pairs, out = ranges.shape[0] - 1, []
    for a in range(0, n_pairs, chunk):
        b = min(a + chunk, n_pairs)
        out.append(tso.match_batch(
            x[a:b], y[a:b], v[a:b], x[a + 1:b + 1], y[a + 1:b + 1],
            v[a + 1:b + 1], torch.zeros((b - a, 3)), **kw))
    return torch.cat(out) if out else torch.zeros((0, 3))


@pytest.mark.parametrize("n_scans", [1, 2, 51, 101])
def test_pairwise_odometry_chunk_runner_equals_eager_loop(n_scans):
    """The batched read and the chunk runner (``PairMatcher``: chunks of 30
    pairs, so every log but one of a scan ends in a tail chunk) against the
    eager loop, bit for bit."""
    ranges, _ = tsim.generate_dataset(max(n_scans, 2), seed=3)
    ranges = torch.as_tensor(ranges[:n_scans])
    angles = torch.as_tensor(beam_angles(CFG))
    got = tso.pairwise_odometry(ranges, angles, CFG, chunk=30)
    want = _eager_chunk_loop(
        ranges, angles, 30, max_range=10.0, pixel=0.05, size=448, iters=7,
        step_t0=0.03, step_r0=0.03)
    assert got.shape == (n_scans - 1, 3)
    assert torch.equal(got, want)
    if n_scans > 2:
        matcher = tso.pair_matcher(ranges.device, 30, 10.0, 0.05, 448, 7,
                                   0.03, 0.03)
        assert {(n_scans - 1) % 30, 30} <= set(matcher.bufs)


def test_reach_clip_fraction_and_guard():
    rng = np.random.default_rng(5)
    deltas = rng.uniform(-0.06, 0.06, (50, 3)).astype(np.float32)
    assert tso.reach_clip_fraction(deltas) == jso.reach_clip_fraction(deltas)
    assert tso.reach_clip_fraction(np.zeros((0, 3))) == 0.0
    with pytest.raises(ValueError, match="half-extent"):
        tso.pairwise_odometry(torch.zeros((3, CFG.n_beams)),
                              torch.zeros(CFG.n_beams), CFG, max_range=12.0)
