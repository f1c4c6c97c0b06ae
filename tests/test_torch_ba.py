"""The port's Schur-complement landmark BA against
``lidar_slam_tpu.models.ba``.

Both packages iterate in float32 on the same numpy problem: the small
corridor problem of ``tests/test_ba.py`` (K = 12) and the museum problem
the card runs in ``chip_smoke.py`` (K = 512 pose slots, 500 active; a
1536^2 reduced system an iteration). The port assembles the normal
equations in float64 and takes its Jacobians in closed form, so results
agree to float32 rounding, not bit for bit: poses and landmarks within 1e-5
(absolute, metres) after 15 iterations, the error within 1e-5 relative.
``optimize_ba`` is the captured function (one Gauss-Newton iteration a
CUDA graph on the card; here the same iteration on its static buffers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_util  # noqa: F401  (caps torch's threads)
from lidar_slam_tpu.models import ba as jba
from lidar_slam_tpu_torch.io import simulate
from lidar_slam_tpu_torch.models import ba as tba
from lidar_slam_tpu_torch.models import state_io
from test_ba import _make_problem

POSE_TOL = 1e-5      # m / rad, after 15 iterations, both problems
ERR_RTOL = 1e-5      # ba_error, relative


def _numpy(prob):
    return tba.BAProblem(*[np.asarray(a) for a in prob])


def _jax(prob):
    return jba.BAProblem(*[jnp.asarray(a) for a in prob])


@pytest.fixture(scope="module")
def problems():
    small, _, _ = _make_problem()
    return {"corridor-12": _numpy(small),
            "museum-512": tba.BAProblem(**simulate.generate_ba_problem())}


@pytest.mark.parametrize("name", ["corridor-12", "museum-512"])
def test_optimize_matches_jax(problems, name):
    p = problems[name]
    tp = state_io.ba_problem_from_numpy(p, "cpu")
    jo = jba.optimize_ba(_jax(p), iters=15)
    to = tba.optimize_ba(tp, iters=15)
    np.testing.assert_allclose(to.poses.numpy(), np.asarray(jo.poses),
                               atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(to.landmarks.numpy(),
                               np.asarray(jo.landmarks), atol=POSE_TOL,
                               rtol=0)
    for a, b in ((tp, _jax(p)), (to, jo)):
        assert float(tba.ba_error(a)) == pytest.approx(
            float(jba.ba_error(b)), rel=ERR_RTOL)
    # the museum pin of chip_smoke.py: the error falls below 5% of its start
    assert float(tba.ba_error(to)) < 0.05 * float(tba.ba_error(tp))


def test_museum_problem_fills_its_slots(problems):
    p = problems["museum-512"]
    assert p.poses.shape == (512, 3) and int(p.pose_active.sum()) == 500
    assert p.landmarks.shape == (64, 2) and int(p.lm_active.sum()) == 12
    assert int(p.odo_active.sum()) == 499 and p.odo_z.shape == (512, 3)
    n_obs = int(p.obs_active.sum())
    assert 0 < n_obs <= 6000 and p.obs_z.shape == (8192, 2)
    assert p.obs_i[:n_obs].max() < 500 and p.obs_j[:n_obs].max() < 12


def test_jacobians_match_jacfwd():
    """Closed-form observation and odometry Jacobians against JAX's vmapped
    ``jacfwd`` of the same residuals, to 1e-6."""
    rng = np.random.default_rng(0)
    pose = rng.normal(0, 3, (64, 3)).astype(np.float32)
    lm = (pose[:, :2] + rng.uniform(0.5, 8, (64, 2))
          * rng.choice([-1, 1], (64, 2))).astype(np.float32)
    z = rng.normal(0, 1, (64, 2)).astype(np.float32)
    jp, jl = jax.vmap(jax.jacfwd(jba._obs_residual, argnums=(0, 1)))(
        jnp.asarray(pose), jnp.asarray(lm), jnp.asarray(z))
    tp, tl = tba._obs_jacobians(torch.as_tensor(pose), torch.as_tensor(lm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tba._obs_residual(torch.as_tensor(pose), torch.as_tensor(lm),
                          torch.as_tensor(z)).numpy(),
        np.asarray(jax.vmap(jba._obs_residual)(jnp.asarray(pose),
                                               jnp.asarray(lm),
                                               jnp.asarray(z))),
        atol=1e-6, rtol=0)

    xi = rng.normal(0, 3, (64, 3)).astype(np.float32)
    xj = rng.normal(0, 3, (64, 3)).astype(np.float32)
    zo = rng.normal(0, 1, (64, 3)).astype(np.float32)
    ji, jj = jax.vmap(jax.jacfwd(jba._odo_residual, argnums=(0, 1)))(
        jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(zo))
    from lidar_slam_tpu_torch.models.posegraph import _edge_jacobians

    ti, tj = _edge_jacobians(torch.as_tensor(xi), torch.as_tensor(xj))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-6, rtol=0)


def test_ba_converges_jointly(problems):
    """``tests/test_ba.py::test_ba_converges_jointly`` on the port."""
    _, gt_poses, gt_lms = _make_problem()
    p = state_io.ba_problem_from_numpy(problems["corridor-12"], "cpu")
    e0 = float(tba.ba_error(p))
    out = tba.optimize_ba(p, iters=15)
    assert float(tba.ba_error(out)) < e0 * 0.05
    pose_err0 = np.abs(p.poses.numpy()[:, :2] - gt_poses[:, :2]).max()
    pose_err1 = np.abs(out.poses.numpy()[:, :2] - gt_poses[:, :2]).max()
    assert pose_err1 < pose_err0 * 0.5
    assert pose_err1 < 0.05
    assert np.abs(out.landmarks.numpy() - gt_lms).max() < 0.05


def test_ba_inactive_slots_untouched(problems):
    """``tests/test_ba.py::test_ba_inactive_slots_untouched`` on the port,
    plus the inactive pose slots of the museum problem."""
    p = problems["corridor-12"]
    lm_active = p.lm_active.copy()
    lm_active[-1] = False
    obs_active = p.obs_active & (p.obs_j != p.landmarks.shape[0] - 1)
    p2 = state_io.ba_problem_from_numpy(
        p._replace(lm_active=lm_active, obs_active=obs_active), "cpu")
    out = tba.optimize_ba(p2, iters=5)
    np.testing.assert_allclose(out.landmarks[-1].numpy(), p.landmarks[-1],
                               atol=1e-6)
    m = state_io.ba_problem_from_numpy(problems["museum-512"], "cpu")
    mo = tba.optimize_ba(m, iters=2)
    assert torch.equal(mo.poses[500:], m.poses[500:])
    assert torch.equal(mo.landmarks[12:], m.landmarks[12:])


def test_state_io_round_trip(problems):
    """A JAX problem crosses to the port and back leaf by leaf, dtypes and
    values unchanged."""
    want = jax.tree.map(np.asarray, _jax(problems["museum-512"]))
    back = state_io.ba_problem_to_numpy(
        state_io.ba_problem_from_numpy(want, "cpu"))
    for f, a, b in zip(jba.BAProblem._fields, back, want):
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


def test_tf32_is_off_inside_and_restored():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tba._true_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
