"""The port's landmark extraction against ``lidar_slam_tpu.ops.landmarks``.

Detection counts must be equal: the thresholds are hard, and the corner
detector's window sums are differences of f32 prefix sums whose rounding
decides the beams near ``max_resid``. ``rb`` within 1e-5 m/rad: cos, sin,
atan2 and hypot are float64 rounded once in the port and XLA's own f32
functions in the JAX package (measured up to 3e-6 on museum-1000).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import to_numpy_tree  # noqa: F401  (caps torch threads)
from lidar_slam_tpu.config import LidarConfig
from lidar_slam_tpu.core.sensor import beam_angles
from lidar_slam_tpu.io import simulate
from lidar_slam_tpu.ops import landmarks as jlm
from lidar_slam_tpu_torch.ops import landmarks as tlm

ANGLES = beam_angles(LidarConfig())
RB_TOL = 1e-5


@pytest.fixture(scope="module")
def museum_prefix():
    """The first 300 scans of the museum tour (the EKF benchmarks' tour)."""
    ranges, _ = simulate.generate_dataset(300, seed=0)
    return ranges


def _cases():
    kw = dict(max_range=12.0)
    return {
        "corners": (lambda r: jlm.extract_corners(r, jnp.asarray(ANGLES), **kw),
                    lambda r: tlm.extract_corners(r, torch.as_tensor(ANGLES),
                                                  **kw)),
        "pillars": (lambda r: jlm.extract_landmarks(r, jnp.asarray(ANGLES)),
                    lambda r: tlm.extract_landmarks(r,
                                                    torch.as_tensor(ANGLES))),
        "all": (lambda r: jlm.extract_all(r, jnp.asarray(ANGLES)),
                lambda r: tlm.extract_all(r, torch.as_tensor(ANGLES))),
    }


def _compare(ranges, name):
    jfn, tfn = _cases()[name]
    want = jax.jit(jax.vmap(jfn))(jnp.asarray(ranges))
    got = tfn(torch.as_tensor(ranges))
    assert np.array_equal(got.count.numpy(), np.asarray(want.count))
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.rb.numpy(), np.asarray(want.rb),
                               atol=RB_TOL, rtol=0)
    return int(np.asarray(want.count).sum())


@pytest.mark.parametrize("name", ["corners", "pillars", "all"])
def test_detections_match_jax_small(small_dataset, name):
    ranges, _ = small_dataset
    assert _compare(ranges, name) > 50


@pytest.mark.parametrize("name", ["corners", "pillars", "all"])
def test_detections_match_jax_museum_prefix(museum_prefix, name):
    assert _compare(museum_prefix, name) > 300


def test_single_scan_equals_batch(small_dataset):
    """A (N,) scan gives row t of the batched (T, N) call."""
    ranges, _ = small_dataset
    batch = tlm.extract_corners(torch.as_tensor(ranges),
                                torch.as_tensor(ANGLES))
    for t in (0, 31, 79):
        one = tlm.extract_corners(torch.as_tensor(ranges[t]),
                                  torch.as_tensor(ANGLES))
        assert torch.equal(one.rb, batch.rb[t])
        assert int(one.count) == int(batch.count[t])


@pytest.mark.parametrize("corners", [True, False])
def test_extract_landmarks_batch_matches_jax(small_dataset, corners):
    ranges, _ = small_dataset
    kw = dict(range_min=0.023, usable_range=24.0, max_range=12.0,
              max_out=12)
    want = jlm.extract_landmarks_batch(jnp.asarray(ranges),
                                       jnp.asarray(ANGLES), corners=corners,
                                       **kw)
    got = tlm.extract_landmarks_batch(torch.as_tensor(ranges),
                                      torch.as_tensor(ANGLES),
                                      corners=corners, **kw)
    assert got.rb.shape == (len(ranges), 12, 2)
    assert np.array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.rb.numpy(), np.asarray(want.rb),
                               atol=RB_TOL, rtol=0)


@pytest.mark.parametrize("shape", [(1079,), (5, 1079), (3, 17), (2, 16),
                                   (4, 300), (1, 5000)])
def test_cumsum32_is_xla_cumsum(shape):
    """The block order of XLA:CPU's f32 cumulative sum, bit for bit."""
    v = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    v = v * 500.0
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(v))
    assert np.array_equal(tlm.cumsum32(torch.as_tensor(v)).numpy(), want)


def test_overflow_keeps_first_max_out():
    """More detections than slots: the first ``max_out`` in beam order are
    kept and the count saturates (JAX's mode="drop")."""
    rb = torch.arange(20, dtype=torch.float32).repeat(2, 1).T[None]
    keep = torch.ones((1, 20), dtype=torch.bool)
    keep[0, 3] = False
    det = tlm._detections(rb, keep, 8)
    assert int(det.count[0]) == 8 and bool(det.valid.all())
    assert det.rb[0, :, 0].tolist() == [0, 1, 2, 4, 5, 6, 7, 8]


def test_corner_extraction_precision():
    """tests/test_ekf_slam.py's precision pin on the port: corners extracted
    from noisy museum scans land within 0.15 m of a true wall end for more
    than 80% of the detections."""
    from lidar_slam_tpu_torch.io import simulate as tsim

    rng = np.random.default_rng(5)
    world = tsim.museum_world()
    traj = tsim.smooth_trajectory(tsim.DEFAULT_WAYPOINTS)[:40]
    ends = np.concatenate([world.segments[:, :2], world.segments[:, 2:]])
    n_hit, n_tot = 0, 0
    for t in range(0, 40, 8):
        r = tsim.raycast(world, traj[t], ANGLES)
        r = (r + rng.normal(0, 0.008, r.shape) * (r > 0)).astype(np.float32)
        det = tlm.extract_corners(torch.as_tensor(r), torch.as_tensor(ANGLES))
        x0, y0, th = traj[t]
        c, s = np.cos(th), np.sin(th)
        for rr, b in det.rb[: int(det.count)].numpy():
            px, py = rr * np.cos(b), rr * np.sin(b)
            wx, wy = c * px + s * py + x0, -s * px + c * py + y0
            n_tot += 1
            n_hit += np.hypot(ends[:, 0] - wx, ends[:, 1] - wy).min() < 0.15
    assert n_tot >= 5
    assert n_hit / n_tot > 0.8, (n_hit, n_tot)
