"""The port's parallel layer across real processes: worlds of 1, 2 and 4
ranks started by ``multihost.launch`` (``spawn``, explicit rank and size,
a ``file://`` store), each holding the single-process port (the
counterpart of ``tests/test_multiprocess.py`` and of the JAX package's
multi-device tests in ``tests/test_parallel.py``).

Starting a world costs a few seconds a rank, so each world runs every
check once, in a module fixture, after the sharded PF's timing of
``multihost.scaling_job``, and every test below reads its result; a fourth
world is ``scaling_report``'s own. The JAX package holds its two-process PF
to 1e-5 (resampling off) and 0.2 m (on); here every rank's path equals the
single process's bit for bit. The sharded steps run captured
(``PfStepFn``, ``EkfStepFn``, ``ShardedSolve``; on the CPU the same bodies
on the same static buffers) on every mesh shape, and worlds of 2 and 4
also run their eager forms: each rank's captured result equals its eager
one, with the same collectives booked on the particles axis. The PF runs
on a map axis of two or more ranks too (1 x 2 in the world of 2; 2 x 2
and 1 x 4 in the world of 4), captured and eager: there the captured step
all-gathers the field's row blocks in its main graph every scan, and the
eager step on a keyframe only.

The worlds are gloo worlds on the CPU. The file imports neither JAX nor
the JAX package, so on a machine with at least four cards (and no JAX)

    LIDAR_SLAM_WORLD_DEVICE=cuda python -m pytest --noconftest \
        -p no:cacheprovider tests/test_torch_multiprocess.py

runs the same checks on NCCL worlds, one card a rank, against the
single-process port on the card.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu_torch.io import dataset
from lidar_slam_tpu_torch.models import ekf_slam as tek
from lidar_slam_tpu_torch.models import fastslam as tfs
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.parallel import (dryrun, multihost, sharded,
                                           sharded_ba, sharded_edt,
                                           sharded_ekf)
from lidar_slam_tpu_torch.utils.metrics import ate

# tier-1 runs several pytest workers at once: keep each one to two threads
torch.set_num_threads(2)

DEVICE = os.environ.get("LIDAR_SLAM_WORLD_DEVICE", "cpu")
WORLDS = (2, 4)
BA_TOL = 1e-5      # a world of 2 or 4 against a world of 1 (float64 sums)
ATE_MAX = 0.25     # tests/test_parallel.py's sharded PF pin


def _pf_cfg(p, threshold=0.5):
    return dataclasses.replace(
        DEFAULT_CONFIG, particles=ParticleConfig(
            n_particles=p, vol_theta_bins=5, vol_half=4,
            resample_threshold=threshold))


def _ekf_case():
    cfg = tek.EkfSlamConfig(n_particles=64, max_landmarks=8,
                            use_scan_odometry=True)
    obs = np.asarray([[2.0, 0.3], [3.0, -0.7], [1.5, 1.1], [4.0, 0.0]],
                     np.float32)
    return (cfg, obs, np.asarray([True, True, True, False]),
            np.asarray([0.05, 0.0, 0.01], np.float32), 3)


@pytest.fixture(scope="module")
def inputs():
    ranges, gt = dataset.ensure_dataset(n_scans=80, seed=3)
    occ = np.random.default_rng(1).random((160, 160)) < 0.02
    prob = dryrun.tiny_ba_problem("cpu")
    return dict(ranges=ranges, gt=gt, occ=occ,
                ba=type(prob)(*(v.numpy() for v in prob)))


# a sharded PF on a map axis of two or more ranks: job name -> (world,
# map shards); each runs captured and, as name + "_eager", eager
MAP_MESHES = {"pf_map2": (4, 2), "pf_map_only2": (2, 2),
              "pf_map_only4": (4, 4)}


@pytest.fixture(scope="module")
def worlds(inputs):
    """Each world's per-rank results of its jobs, by job name."""
    if DEVICE == "cuda":
        from lidar_slam_tpu_torch import _build

        _build.load_kernels()   # built once here, not by every rank
    ranges = inputs["ranges"]
    timing = (multihost.scaling_job, (ranges, _pf_cfg(64), 8, DEVICE))
    ba_job = (sharded_ba.optimize_job, (inputs["ba"], 5, None, DEVICE))
    checks = {
        "scans_per_s": timing,
        "pf_no_resample": (sharded.run_job, (ranges[:13], _pf_cfg(64, 0.0),
                                             1, 0, DEVICE)),
        "pf_resample": (sharded.run_job, (ranges[:13], _pf_cfg(64), 1, 0,
                                          DEVICE)),
        "ekf": (sharded_ekf.steps_job, _ekf_case() + (0, DEVICE)),
        "edt": (sharded_edt.replicated_job, (inputs["occ"], 10, DEVICE)),
        "ba": ba_job,
        "imports": (multihost.imported_packages, ()),
        # the eager steps, which the captured ones above must equal
        "pf_eager": (sharded.run_job, (ranges[:13], _pf_cfg(64), 1, 0,
                                       DEVICE, True)),
        "ekf_eager": (sharded_ekf.steps_job, _ekf_case() + (0, DEVICE,
                                                            True)),
        "ba_eager": (sharded_ba.optimize_job, (inputs["ba"], 5, None, DEVICE,
                                               True))}
    jobs = {1: {"scans_per_s": timing, "ba": ba_job},
            2: dict(checks),
            4: dict(checks,
                    dryrun=(dryrun.dryrun_multichip, (4, DEVICE)),
                    pf_tracks=(sharded.run_job, (ranges[:40], _pf_cfg(32), 1,
                                                 0, DEVICE)))}
    for name, (d, n_map) in MAP_MESHES.items():
        for suffix, eager in (("", False), ("_eager", True)):
            jobs[d][name + suffix] = (sharded.run_job, (
                ranges[:13], _pf_cfg(64), n_map, 0, DEVICE, eager))
    return {d: [dict(zip(jobs[d], ranks)) for ranks in multihost.launch(
        d, list(jobs[d].values()), DEVICE, timeout_s=400.0)]
        for d in (1, 2, 4)}


def _results(worlds, d, name):
    """Every rank's result of job ``name`` in the world of ``d``."""
    return [r[name] for r in worlds[d]]


def test_scaling_report_runs_at_every_world_size(worlds):
    """The sharded PF's timing job ran in worlds of 1, 2 and 4 ranks."""
    assert set(worlds) == {1, 2, 4}
    for d in worlds:
        assert all(v > 0 for v in _results(worlds, d, "scans_per_s"))


def test_scaling_report_skips_sizes_above_the_devices(inputs):
    """``scaling_report`` launches a world of each size it can hold and
    skips a size above the devices present, saying why."""
    n, why = multihost.devices_present(DEVICE)
    rep = multihost.scaling_report(inputs["ranges"], n_particles=16,
                                   world_sizes=(1, n + 1), n_scans=4,
                                   device_type=DEVICE, timeout_s=400.0)
    assert set(rep.scans_per_s) == {1} and rep.scans_per_s[1] > 0
    assert rep.skipped == {n + 1: why}


def test_scaling_report_skips_every_size_above_one_card(monkeypatch,
                                                        inputs):
    """On a machine with one card, every world size above 1 is skipped,
    with the reason "1 GPU", and no world is launched for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rep = multihost.scaling_report(inputs["ranges"], world_sizes=(2, 4),
                                   device_type="cuda")
    assert rep.scans_per_s == {}
    assert rep.skipped == {2: "1 GPU", 4: "1 GPU"}


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("threshold,job", [(0.0, "pf_no_resample"),
                                           (0.5, "pf_resample")])
def test_sharded_pf_equals_single_process(worlds, inputs, d, threshold,
                                          job):
    ref, state = tfs.run_pf(inputs["ranges"][:13], _pf_cfg(64, threshold),
                            device=DEVICE)
    out = _results(worlds, d, job)
    for path, *_ in out:
        assert np.array_equal(path, ref.cpu().numpy())
    assert np.array_equal(np.concatenate([o[1] for o in out]),
                          state.poses.cpu().numpy())
    assert np.array_equal(np.concatenate([o[2] for o in out]),
                          state.logw.cpu().numpy())


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_ekf_equals_single_process(worlds, d):
    cfg, obs, valid, odo, n = _ekf_case()
    state = tek.init_ekf_slam(cfg, 0, DEVICE)
    ests = []
    for _ in range(n):
        state, est = tek.ekf_slam_step_ml(
            state, torch.as_tensor(obs, device=DEVICE),
            torch.as_tensor(valid, device=DEVICE), cfg,
            odo=torch.as_tensor(odo, device=DEVICE))
        ests.append(est)
    out = _results(worlds, d, "ekf")
    for got_ests, *_ in out:
        assert np.array_equal(got_ests, torch.stack(ests).cpu().numpy())
    for f in tek.PARTICLE_LEAVES:
        assert np.array_equal(
            np.concatenate([getattr(o[1], f) for o in out]),
            getattr(state, f).cpu().numpy()), f


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_edt_across_ranks(worlds, inputs, d):
    want = edt_ops.edt_clamped(torch.as_tensor(inputs["occ"])).numpy()
    for got in _results(worlds, d, "edt"):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_ba_matches_world_of_one(worlds, d):
    (one,) = _results(worlds, 1, "ba")
    for poses, lms in _results(worlds, d, "ba"):
        np.testing.assert_allclose(poses, one[0], atol=BA_TOL, rtol=0)
        np.testing.assert_allclose(lms, one[1], atol=BA_TOL, rtol=0)


@pytest.mark.parametrize("d", WORLDS)
def test_spawned_ranks_load_neither_jax_nor_the_jax_package(worlds, d):
    for names in _results(worlds, d, "imports"):
        assert "lidar_slam_tpu_torch" in names
        assert not {"jax", "jaxlib", "lidar_slam_tpu"} & set(names)


def test_dryrun_multichip_four_ranks(worlds):
    """``dryrun_multichip(4)``: a 2 x 2 (particles x map) PF step, one BA
    iteration whose error falls, the EDT's point checks, two EKF steps;
    every rank agrees on the estimates."""
    out = _results(worlds, 4, "dryrun")
    for r in out:
        assert np.array_equal(r["pf_est"], out[0]["pf_est"])
        assert np.array_equal(r["ekf_est"], out[0]["ekf_est"])
        assert r["ba_error"][1] < r["ba_error"][0]
        assert r["edt_shape"] == (64, 64)


def test_sharded_pf_tracks_on_four_ranks(worlds, inputs):
    """32 particles over 4 ranks, 40 scans: ATE < 0.25 m, and every rank's
    path equal to the single process's."""
    ref, _ = tfs.run_pf(inputs["ranges"][:40], _pf_cfg(32), device=DEVICE)
    for path, *_ in _results(worlds, 4, "pf_tracks"):
        assert np.array_equal(path, ref.cpu().numpy())
        assert ate(path, inputs["gt"][:40]) < ATE_MAX


def _same(a, b) -> bool:
    """Two job results (tuples of arrays, states and count dicts) equal
    leaf by leaf."""
    if isinstance(a, dict):
        return a == b
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None:
        return b is None
    return np.array_equal(a, b)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("captured,eager", [("pf_resample", "pf_eager"),
                                            ("ekf", "ekf_eager"),
                                            ("ba", "ba_eager")])
def test_captured_equals_eager_across_ranks(worlds, d, captured, eager):
    """Every rank's captured sharded PF, EKF and BA equal its eager forms
    bit for bit: paths, estimates, its rows of the state, the solved
    poses and landmarks, and the collectives booked by kind and shape."""
    for cap, eag in zip(_results(worlds, d, captured),
                        _results(worlds, d, eager)):
        assert _same(cap, eag)


def _check_map_mesh(worlds, inputs, name):
    """Job ``name`` of ``MAP_MESHES`` against its eager job and ``run_pf``
    (``test_two_by_two_mesh_equals_run_pf`` says what is held)."""
    d, n_map = MAP_MESHES[name]
    scans = 13
    ref, state = tfs.run_pf(inputs["ranges"][:scans], _pf_cfg(64),
                            device=DEVICE)
    cap, eag = _results(worlds, d, name), _results(worlds, d,
                                                   name + "_eager")
    field = ("all_gather", tuple(state.fine_metric.shape), 4)
    keyframes = eag[0][4][field]
    assert 1 <= keyframes < scans - 1
    for c, e in zip(cap, eag):
        assert np.array_equal(c[0], ref.cpu().numpy())
        assert _same(c[:4], e[:4])
        assert c[4] == {field: scans - 1} and e[4] == {field: keyframes}
    # ranks (p, m) and (p, m') hold the same particle block
    blocks = [cap[p * n_map][1] for p in range(d // n_map)]
    assert np.array_equal(np.concatenate(blocks), state.poses.cpu().numpy())
    for r in range(d):
        assert np.array_equal(cap[r][1], blocks[r // n_map])


def test_two_by_two_mesh_equals_run_pf(worlds, inputs):
    """Four ranks as 2 particle blocks x 2 map blocks: the field is
    ``edt_replicated`` over the map axis, and the step is the captured
    one. On every rank its path equals the eager step's and ``run_pf``'s,
    and its particle rows the eager step's and the single process's bit
    for bit; the particles axis books the same collectives in both forms.
    The map axis differs by design: the captured step books one all-gather
    of the (H/2, W) f32 blocks into the (H, W) field a scan (its main
    graph gathers after the refresh arm's IF node every scan; scan 1 is
    the eager step's), the eager step one a keyframe (its refresh arm
    cuts the block from the replicated grid, so the field is its one
    collective)."""
    _check_map_mesh(worlds, inputs, "pf_map2")


@pytest.mark.parametrize("name", ["pf_map_only2", "pf_map_only4"])
def test_map_axis_mesh_equals_run_pf(worlds, inputs, name):
    """The map axis alone, 1 x 2 in the world of 2 and 1 x 4 in the world
    of 4: held as the 2 x 2 mesh is (``test_two_by_two_mesh_equals_run_pf``),
    every rank holding every particle."""
    _check_map_mesh(worlds, inputs, name)
