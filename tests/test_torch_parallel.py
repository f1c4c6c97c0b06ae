"""The port's parallel layer in one process (a gloo world of one) against
the single-process port and ``lidar_slam_tpu.parallel`` on the 8-device
virtual mesh (the counterpart of ``tests/test_parallel.py``).

A world of one still runs every collective through its process group.
Worlds of 2 and 4 processes are ``tests/test_torch_multiprocess.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_util  # noqa: F401  (caps torch's threads)
from lidar_slam_tpu.models import ekf_slam as jek
from lidar_slam_tpu.parallel import mesh as jmesh
from lidar_slam_tpu.parallel import resampling as jres
from lidar_slam_tpu.parallel import sharded_ekf as jsek
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG as TCFG
from lidar_slam_tpu_torch.config import ParticleConfig as TPC
from lidar_slam_tpu_torch.models import ekf_slam as tek
from lidar_slam_tpu_torch.models import fastslam as tfs
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
from lidar_slam_tpu_torch.parallel import (multihost, resampling, sharded,
                                           sharded_edt, sharded_ekf)

RUN_TOL = 1e-3   # port against JAX over several steps on the same draws


@pytest.fixture(scope="module")
def world():
    """A gloo world of one on a file:// store, made and destroyed here
    (several test files share one xdist worker)."""
    assert multihost.initialize(device_type="cpu") == (0, 1)
    yield multihost.global_particle_mesh(device_type="cpu")
    multihost.shutdown()


def _pf_cfg(p=64, **kw):
    return dataclasses.replace(
        TCFG, particles=TPC(n_particles=p, vol_theta_bins=5, vol_half=4,
                            **kw))


def test_axis_collectives_keep_dtype_and_shape(world):
    ax = world.particles
    assert (ax.size, ax.rank) == (1, 0)
    b = torch.tensor([True, False, True])
    assert torch.equal(ax.gather(b), b)
    assert ax.gather(torch.tensor(2.5)).shape == (1,)
    x = torch.arange(6, dtype=torch.float64).view(3, 2)
    assert torch.equal(ax.all_reduce(x), x)
    assert ax.calls >= 3 and ax.gathered_bytes > 0 and ax.reduced_bytes == 48
    assert mesh_lib.bytes_per_rank(100, 10, 1) == 0.0
    assert mesh_lib.bytes_per_rank(100, 10, 4) == 90.0
    with pytest.raises(ValueError, match="ranks"):
        mesh_lib.make_mesh(n_particles_shards=2, n_map_shards=1,
                           device_type="cpu")


def test_distributed_resample_matches_single_rank_and_jax(world):
    """Indices and payloads equal the single-rank ``systematic_resample``
    bit for bit; the indices equal the JAX package's shard_map resampler
    on its 8-device mesh (same weights, same comb)."""
    p = 64
    key = jax.random.PRNGKey(0)
    logw = np.array(jax.random.normal(key, (p,)))
    poses = np.array(jax.random.normal(jax.random.fold_in(key, 1), (p, 3)))
    prev = np.array(jax.random.normal(jax.random.fold_in(key, 2), (p, 3)))
    u0 = np.float32(0.37)
    jmesh8 = jmesh.make_mesh(n_particles_shards=8, n_map_shards=1)
    _, _, jidx = jres.distributed_systematic_resample(
        jmesh8, jnp.asarray(logw), jnp.asarray(poses), jnp.asarray(prev),
        jnp.float32(u0))

    tu0 = torch.tensor(u0 / np.float32(p))      # the port's u0 in [0, 1/P)
    new, new_prev, idx = resampling.distributed_systematic_resample(
        world.particles, torch.as_tensor(logw), torch.as_tensor(poses),
        torch.as_tensor(prev), tu0)
    want = tfs.systematic_resample(tu0, torch.as_tensor(logw))
    assert torch.equal(idx, want)
    assert torch.equal(new, torch.as_tensor(poses)[want])
    assert torch.equal(new_prev, torch.as_tensor(prev)[want])
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


def test_pf_step_takes_edt_fn(small_dataset):
    """``pf_step(edt_fn=...)``: the plain version passed explicitly gives
    the default path exactly (the default is ``ops/edt.edt``)."""
    ranges, _ = small_dataset
    cfg = _pf_cfg(32)
    calls = []

    def plain(occ, max_dist):
        calls.append(tuple(occ.shape))
        return edt_ops.edt_clamped(occ, max_dist)

    r = torch.as_tensor(ranges[:20])
    angles = torch.as_tensor(tfs.sensor.beam_angles(cfg.lidar))
    a = tfs.init_particles(r[0], cfg, 3)
    b = tfs.init_particles(r[0], cfg, 3)
    for t in range(1, 20):
        a, pa = tfs.pf_step(a, r[t], cfg, angles)
        b, pb = tfs.pf_step(b, r[t], cfg, angles, edt_fn=plain)
        assert torch.equal(pa, pb)
    assert calls and all(s == (cfg.grid.fine_size,) * 2 for s in calls)
    assert torch.equal(a.fine_metric, b.fine_metric)
    assert torch.equal(a.poses, b.poses)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_sharded_pf_world1_equals_run_pf(world, small_dataset, threshold):
    """Resampling off and on: the sharded path equals ``run_pf`` bit for
    bit, and again with the keyframe field computed as 4 row blocks."""
    ranges, _ = small_dataset
    cfg = _pf_cfg(resample_threshold=threshold)
    ref, rstate = tfs.run_pf(ranges[:25], cfg, seed=1, device="cpu")
    got, gstate = sharded.run_sharded_pf(ranges[:25], cfg, world, seed=1)
    assert torch.equal(got, ref)
    for f in ("poses", "prev_poses", "logw", "fine_metric"):
        assert torch.equal(getattr(gstate, f), getattr(rstate, f)), f
    blocks, _ = sharded.run_sharded_pf(
        ranges[:25], cfg, world, seed=1,
        edt_fn=lambda occ, r: sharded_edt.edt_blocks(occ, 4, r))
    assert torch.equal(blocks, ref)


def test_sharded_pf_draws_the_full_noise(world, small_dataset):
    """Injected whole-P draws reach the sharded step as they reach
    ``pf_step``: the same path."""
    ranges, _ = small_dataset
    cfg = _pf_cfg(32)
    rng = np.random.default_rng(4)
    draws = [(rng.standard_normal((32, 3)).astype(np.float32),
              np.float32(rng.random() / 32)) for _ in range(11)]
    ref, _ = tfs.run_pf(ranges[:12], cfg, device="cpu", draws=draws)
    got, _ = sharded.run_sharded_pf(ranges[:12], cfg, world, draws=draws)
    assert torch.equal(got, ref)


def _ekf_inputs():
    obs = np.asarray([[2.0, 0.3], [3.0, -0.7], [1.5, 1.1], [4.0, 0.0]],
                     np.float32)
    return obs, np.asarray([True, True, True, False]), np.asarray(
        [0.05, 0.0, 0.01], np.float32)


def test_sharded_ekf_world1_matches_single_rank_and_jax(world):
    """3 ML steps: the sharded bank equals ``ekf_slam_step_ml`` bit for
    bit; on JAX's own draws it is within RUN_TOL of the JAX package's
    mesh-sharded step on the 8-device mesh."""
    cfg = tek.EkfSlamConfig(n_particles=64, max_landmarks=8,
                            use_scan_odometry=True)
    obs, valid, odo = (torch.as_tensor(a) for a in _ekf_inputs())
    step, place = sharded_ekf.make_sharded_ekf_step(cfg, world)
    ref = tek.init_ekf_slam(cfg, 0, "cpu")
    got = place(tek.init_ekf_slam(cfg, 0, "cpu"))
    for _ in range(3):
        ref, rest = tek.ekf_slam_step_ml(ref, obs, valid, cfg, odo=odo)
        got, gest = step(got, obs, valid, odo)
        assert torch.equal(gest, rest)
    for f in tek.PARTICLE_LEAVES:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f

    jcfg = jek.EkfSlamConfig(n_particles=64, max_landmarks=8,
                             use_scan_odometry=True)
    jstep, jplace = jsek.make_sharded_ekf_step(
        jcfg, jmesh.make_mesh(n_particles_shards=8, n_map_shards=1))
    jstate = jplace(jek.init_ekf_slam(jcfg, seed=0))
    tstate = place(tek.init_ekf_slam(cfg, 0, "cpu"))
    jobs, jvalid, jodo = (jnp.asarray(a) for a in _ekf_inputs())
    for _ in range(3):
        keys = jax.random.split(jstate.rng, 4)
        draws = (np.array(jax.random.normal(keys[1], (64, 3))),
                 np.array(jax.random.uniform(keys[-1], (), minval=0.0,
                                             maxval=1.0 / 64)))
        jstate, jest = jstep(jstate, jobs, jvalid, jodo)
        tstate, test_ = step(tstate, obs, valid, odo, draws=draws)
        np.testing.assert_allclose(test_.numpy(), np.asarray(jest),
                                   atol=RUN_TOL, rtol=0)
    np.testing.assert_allclose(tstate.poses.numpy(), np.asarray(jstate.poses),
                               atol=RUN_TOL, rtol=0)
    np.testing.assert_allclose(tstate.lm_mean.numpy(),
                               np.asarray(jstate.lm_mean), atol=RUN_TOL,
                               rtol=0)


def test_sharded_ekf_run_ml_world1_equals_run_ml(world, small_dataset):
    """The scan-driven inputs through ``run_sharded_ml`` equal
    ``run_ml``'s run."""
    ranges, _ = small_dataset
    cfg = tek.long_tour_config(64)
    inputs = tek.scan_inputs(ranges[:30], cfg,
                             max_range=tek.LONG_TOUR_MAX_RANGE,
                             device="cpu")
    ref, rstate = tek.run_ml(*inputs[:3], cfg, 2, "cpu", counts=inputs[3])
    got, gstate = sharded_ekf.run_sharded_ml(*inputs[:3], cfg, world, 2,
                                             counts=inputs[3])
    assert torch.equal(got, ref)
    assert torch.equal(gstate.lm_mean, rstate.lm_mean)
