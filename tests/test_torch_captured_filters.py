"""The captured EKF and hybrid drivers on the CPU, where the runner calls
the same bodies uncaptured on the same static buffers (``utils/graphs``):
each equals its eager loop bit for bit, path and final state (generator
included).

- ``run_ml`` (``EkfStepFn``, one graph a detection count) on
  ``small_dataset``'s scan-driven inputs with every fifth scan's detections
  dropped, so the count takes 0 and several other values: with numpy draws
  injected, with the port's generator, and with the valid rows given as a
  mask (no counts) where one scan's rows are out of order;
- the known-association ``run_ekf_slam`` (one graph);
- ``run_ekf_hybrid`` (a head graph a detection count and one refresh
  graph) on 40 scans, injected draws and the port's generator.
"""

import numpy as np
import pytest
import torch

from _torch_util import assert_tree_equal
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
from lidar_slam_tpu_torch.io import simulate as tsim
from lidar_slam_tpu_torch.models import ekf_hybrid as thy
from lidar_slam_tpu_torch.models import ekf_slam as tek
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor

P = 64
ML_CFG = tek.long_tour_config(P)
N_HYBRID = 40


def _draws(n, p=P, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((p, 3)).astype(np.float32),
             np.float32(rng.random() / p)) for _ in range(n)]


def _assert_same_filter(got, want):
    """Two filter states equal bit for bit, generators by their state."""
    assert_tree_equal(got._replace(rng=None), want._replace(rng=None))
    assert torch.equal(got.rng.get_state(), want.rng.get_state())


@pytest.fixture(scope="module")
def ml_inputs(small_dataset):
    """Scan-driven inputs with every fifth scan's detections dropped."""
    ranges, _ = small_dataset
    obs, valid, odo, counts = tek.scan_inputs(
        ranges, ML_CFG, max_range=tek.LONG_TOUR_MAX_RANGE, device="cpu")
    valid, counts = valid.clone(), counts.copy()
    valid[::5] = False
    counts[::5] = 0
    assert 0 in counts and len(set(counts.tolist())) >= 3
    return obs, valid, odo, counts


def _eager_ml(obs, valid, odo, counts, draws, seed=0):
    state = tek.init_ekf_slam(ML_CFG, seed, "cpu")
    ests = [torch.zeros(3)]
    for t in range(obs.shape[0]):
        state, est = tek.ekf_slam_step_ml(
            state, obs[t], valid[t], ML_CFG, odo=odo[t],
            draws=None if draws is None else draws[t],
            n_det=None if counts is None else int(counts[t]))
        ests.append(est)
    return torch.stack(ests), state


@pytest.mark.parametrize("case", ["draws", "generator", "mask"])
def test_run_ml_captured_equals_eager(ml_inputs, case):
    obs, valid, odo, counts = ml_inputs
    draws = _draws(obs.shape[0]) if case == "draws" else None
    if case == "mask":
        # scan 3's first valid row moved behind an invalid one
        n = int(counts[3])
        obs, valid = obs.clone(), valid.clone()
        obs[3, 1:n + 1], valid[3, :n + 1] = obs[3, :n].clone(), torch.arange(
            n + 1) > 0
        counts = None
    want, want_state = _eager_ml(obs, valid, odo, counts, draws, seed=3)
    path, state = tek.run_ml(obs, valid, odo, ML_CFG, seed=3, device="cpu",
                             draws=draws, counts=counts)
    assert torch.equal(path, want)
    _assert_same_filter(state, want_state)


@pytest.mark.parametrize("injected", [True, False])
def test_run_ekf_slam_captured_equals_eager(injected):
    odom, obs, vis, _, lms = tsim.generate_ekf_dataset(n_scans=120, seed=2)
    cfg = tek.EkfSlamConfig(n_particles=P, max_landmarks=lms.shape[0])
    draws = _draws(len(odom)) if injected else None
    state = tek.init_ekf_slam(cfg, 5, "cpu")
    want = [torch.zeros(3)]
    for t in range(len(odom)):
        state, est = tek.ekf_slam_step(
            state, torch.as_tensor(odom[t]), torch.as_tensor(obs[t + 1]),
            torch.as_tensor(vis[t + 1]), cfg,
            None if draws is None else draws[t])
        want.append(est)
    path, got = tek.run_ekf_slam(odom, obs, vis, cfg, seed=5, device="cpu",
                                 draws=draws)
    assert torch.equal(path, torch.stack(want))
    _assert_same_filter(got, state)


@pytest.mark.parametrize("injected", [True, False])
def test_run_ekf_hybrid_captured_equals_eager(small_dataset, injected):
    """The eager ``hybrid_step`` loop on the run's own pre-pass inputs."""
    from lidar_slam_tpu_torch.ops import landmarks as lm_ops
    from lidar_slam_tpu_torch.ops.scan_odometry import pairwise_odometry

    ranges = small_dataset[0][:N_HYBRID]
    draws = _draws(N_HYBRID - 1) if injected else None
    r = torch.as_tensor(ranges)
    angles = angles_tensor(DEFAULT_CONFIG, "cpu")
    det = lm_ops.extract_corners(
        r, angles, range_min=DEFAULT_CONFIG.lidar.range_min,
        usable_range=DEFAULT_CONFIG.lidar.usable_range, max_range=12.0)
    odo = pairwise_odometry(r, angles, DEFAULT_CONFIG.lidar)
    counts = det.count.numpy()
    state = thy.init_hybrid(r[0], ML_CFG, DEFAULT_CONFIG, seed=4)
    want = [torch.zeros(3)]
    for t in range(1, N_HYBRID):
        state, est = thy.hybrid_step(
            state, r[t], det.rb[t], det.valid[t], odo[t - 1], ML_CFG,
            DEFAULT_CONFIG, angles, None if draws is None else draws[t - 1],
            n_det=int(counts[t]))
        want.append(est)
    path, got = thy.run_ekf_hybrid(ranges, ML_CFG, DEFAULT_CONFIG, seed=4,
                                   device="cpu", draws=draws)
    assert torch.equal(path, torch.stack(want))
    assert_tree_equal(got._replace(ekf=got.ekf._replace(rng=None)),
                      state._replace(ekf=state.ekf._replace(rng=None)))
    assert torch.equal(got.ekf.rng.get_state(), state.ekf.rng.get_state())
    assert got.step == N_HYBRID and state.mini_updated == got.mini_updated
