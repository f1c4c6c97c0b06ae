"""The port's correlation volume (plain version of kernel K2) and lookups
against ``lidar_slam_tpu.ops.correlative``.

On full-resolution EDT fields every addend is on the 2^-10 lattice, so the
scores and counts must match JAX's ``impl="jnp"`` path and the Pallas kernel
(interpret mode) exactly. The factor-2/4 min-pooled cascade fields and the
trilinear lookups are compared at 1e-6 relative: the lookups sum their
corners in another order than JAX's one-hot contraction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_util import jax_grid
from lidar_slam_tpu.config import DEFAULT_CONFIG
from lidar_slam_tpu.ops import correlative as jc
from lidar_slam_tpu.ops import edt as jedt
from lidar_slam_tpu_torch.core import sensor as tsensor
from lidar_slam_tpu_torch.core.gridmap import OccGrid as TGrid
from lidar_slam_tpu_torch.models import scan_matcher as tsm
from lidar_slam_tpu_torch.models import state_io
from lidar_slam_tpu_torch.ops import correlative as tc


@pytest.fixture(scope="module")
def field(small_dataset):
    """The museum fine field (400^2) of the port's state after 30 scans,
    the scan that follows, and its pose."""
    ranges, _ = small_dataset
    _, state = tsm.run_scan(ranges[:30], DEFAULT_CONFIG, device="cpu")
    scan = tsensor.read_scan(torch.as_tensor(ranges[30]),
                             tsm.angles_tensor(DEFAULT_CONFIG, "cpu"),
                             DEFAULT_CONFIG.lidar)
    jgrid = jax_grid(state_io.grid_to_numpy(state.fine)._replace(
        pixel=state.fine.pixel))
    jscan = tuple(jnp.asarray(v.numpy()) for v in scan[:3])
    return state, scan, jgrid, jscan


def _base(state, d=(0.03, -0.05, 0.002)):
    return state.pose + torch.tensor(d, dtype=torch.float32)


@pytest.mark.parametrize("t_bins,half", [(5, 2), (7, 6), (13, 4), (5, 14)])
def test_volume_matches_jax_jnp(field, t_bins, half):
    state, scan, jgrid, jscan = field
    base = _base(state)
    got = tc.build_score_volume(state.fine_metric, state.fine, scan.x, scan.y,
                                scan.valid, base, n_theta=t_bins,
                                theta_step=0.004363, half=half)
    want = jc.build_score_volume(jnp.asarray(state.fine_metric.numpy()),
                                 jgrid, *jscan, jnp.asarray(base.numpy()),
                                 n_theta=t_bins, theta_step=0.004363,
                                 half=half, impl="jnp")
    assert got.scores.shape == (t_bins, 2 * half + 1, 2 * half + 1)
    assert got.scores.abs().sum() > 0
    assert np.array_equal(got.scores.numpy(), np.asarray(want.scores))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))


def _small_field(seed, s=64):
    rng = np.random.default_rng(seed)
    occ = rng.random((s, s)) < 0.02
    metric = np.asarray(jedt.edt_clamped(occ, 10))
    n_rows, n_cols = s - 5, s - 9
    org = np.asarray([-s * 0.05, -s * 0.05], np.float32)
    tg = TGrid(torch.as_tensor(occ), torch.tensor(n_rows, dtype=torch.int32),
               torch.tensor(n_cols, dtype=torch.int32), torch.as_tensor(org),
               0.1)
    jg = jax_grid(state_io.grid_to_numpy(tg)._replace(pixel=0.1))
    n = 300
    xy = rng.uniform(-s * 0.045, s * 0.045, (2, n)).astype(np.float32)
    valid = rng.random(n) < 0.9
    return metric, tg, jg, xy, valid


@pytest.mark.parametrize("t_bins,half", [(5, 2), (3, 6), (13, 2), (7, 4)])
def test_volume_matches_pallas_interpret(t_bins, half):
    """Against the Pallas K2 path (histogram + correlation kernel) in
    interpret mode, on a 64^2 EDT field. Interpret mode traces every
    (bin, dy, dx) of the kernel, so T*W^2 stays small here; half=14 against
    Pallas costs minutes this way and is covered by transitivity: the
    jnp comparison above at (5, 14) and tests/test_correlative.py's
    Pallas-vs-jnp case at half=14."""
    metric, tg, jg, (x, y), valid = _small_field(t_bins * 100 + half)
    base = np.asarray([0.3, -0.2, 0.01], np.float32)
    got = tc.build_score_volume(torch.as_tensor(metric.copy()), tg,
                                torch.as_tensor(x), torch.as_tensor(y),
                                torch.as_tensor(valid), torch.as_tensor(base),
                                n_theta=t_bins, theta_step=0.004363,
                                half=half)
    with pltpu.force_tpu_interpret_mode():
        want = jc.build_score_volume(jnp.asarray(metric), jg, jnp.asarray(x),
                                     jnp.asarray(y), jnp.asarray(valid),
                                     jnp.asarray(base), n_theta=t_bins,
                                     theta_step=0.004363, half=half,
                                     impl="pallas")
    assert got.scores.abs().sum() > 0
    assert np.array_equal(got.scores.numpy(), np.asarray(want.scores))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))


@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_metric(field, factor):
    state, _, jgrid, _ = field
    m2, g2 = tc.downsample_metric(state.fine_metric, state.fine, factor)
    jm2, jg2 = jc.downsample_metric(jnp.asarray(state.fine_metric.numpy()),
                                    jgrid, factor)
    assert np.array_equal(m2.numpy(), np.asarray(jm2))
    assert int(g2.n_rows) == int(jg2.n_rows)
    assert int(g2.n_cols) == int(jg2.n_cols)
    assert np.array_equal(g2.origin.numpy(), np.asarray(jg2.origin))
    assert np.float32(g2.pixel) == np.float32(jg2.pixel)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_cascade_lookups_match_jax(field, levels):
    """Cascade volumes, ``_window_inside``, ``lookup_avg_distance`` and
    ``lookup_cascade`` at 1-3 levels, for poses inside and far outside the
    fine window (which clamp to its edge or fall to a coarser level)."""
    state, scan, jgrid, jscan = field
    base = _base(state)
    tv = tc.build_cascade(state.fine_metric, state.fine, scan.x, scan.y,
                          scan.valid, base, 7, 0.004363, 6, levels)
    jv = jc.build_cascade(jnp.asarray(state.fine_metric.numpy()), jgrid,
                          *jscan, jnp.asarray(base.numpy()), 7, 0.004363, 6,
                          levels)
    for lvl, (a, b) in enumerate(zip(tv, jv)):
        if lvl == 0:
            assert np.array_equal(a.scores.numpy(), np.asarray(b.scores))
        else:
            np.testing.assert_allclose(a.scores.numpy(), np.asarray(b.scores),
                                       rtol=1e-6)
        assert np.array_equal(a.counts.numpy(), np.asarray(b.counts))
    rng = np.random.default_rng(levels)
    spread = np.asarray([1.2, 1.2, 0.03], np.float32)
    poses = (base.numpy() + rng.uniform(-1, 1, (400, 3)) * spread
             ).astype(np.float32)
    tp, jp = torch.as_tensor(poses), jnp.asarray(poses)
    for a, b in zip(tv, jv):
        assert np.array_equal(tc._window_inside(a, tp).numpy(),
                              np.asarray(jc._window_inside(b, jp)))
        np.testing.assert_allclose(tc.lookup_avg_distance(a, tp).numpy(),
                                   np.asarray(jc.lookup_avg_distance(b, jp)),
                                   rtol=1e-6)
    d, esc = tc.lookup_cascade(tv, tp)
    jd, jesc = jc.lookup_cascade(jv, jp)
    assert 0 < int(esc.sum()) < len(poses)
    assert np.array_equal(esc.numpy(), np.asarray(jesc))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
