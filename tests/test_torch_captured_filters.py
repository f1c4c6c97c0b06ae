"""The captured EKF and hybrid drivers on the CPU, where the runner calls
the same bodies uncaptured on the same static buffers (``utils/graphs``)
and ``graphs.while_loop`` loops on ``bool(pred)``: each equals its eager
loop bit for bit, path and final state (generator included).

- ``graphs.while_loop``: the body runs as many times as the count says,
  none for 0; the warm-up runs it once on a clone; a WHILE body's launch
  delta is booked once an iteration;
- ``run_ml`` (``EkfStepFn``, one graph for every detection count: the
  association loop over the valid rows, found on the device, is a WHILE
  node) on ``small_dataset``'s scan-driven inputs with every fifth scan's
  detections dropped, so the count takes 0 and several other values: with
  numpy draws injected, with the port's generator, and with one scan's
  rows out of order; then on a log whose counts take 0, 1 and 16 (a full
  detector: rows duplicated into every slot), and on one whose valid rows
  are interleaved with invalid ones;
- the known-association ``run_ekf_slam`` (one graph);
- ``run_ekf_hybrid`` (one graph: the head with its WHILE node, and the
  refresh's IF node) on 40 scans, injected draws and the port's
  generator, and the hybrid over a pre-pass whose counts take 0 and 16.
"""

import collections
import types

import numpy as np
import pytest
import torch

from _torch_util import assert_tree_equal
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
from lidar_slam_tpu_torch.io import simulate as tsim
from lidar_slam_tpu_torch.models import ekf_hybrid as thy
from lidar_slam_tpu_torch.models import ekf_slam as tek
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor
from lidar_slam_tpu_torch.utils import graphs

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
    valid, counts = valid.clone(), counts.clone()
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


@pytest.mark.parametrize("count", [0, 1, 3, 16])
def test_while_loop_runs_its_body_count_times(count):
    """On the CPU the body runs ``count`` times (none for 0), the last one
    leaving ``pred`` false; a ``Graphs`` warm-up runs it once, on a clone,
    counting nothing; and a WHILE body's device counter that counted
    ``count`` iterations books its launch delta ``count`` times."""
    counter = types.SimpleNamespace(launches=0,
                                    launches_by_shape=collections.Counter())
    runner = graphs.Graphs(torch.device("cpu"), counters=(counter,))
    bufs = {"k": torch.zeros((), dtype=torch.int64),
            "n": torch.tensor(count), "go": torch.tensor(count > 0),
            "sum": torch.zeros(())}
    runs = []

    def launch():   # a kernel wrapper's count
        counter.launches += 1
        counter.launches_by_shape[(1, 400, 400)] += 1

    def body(b):
        def once():
            runs.append(b["k"] is bufs["k"])
            b["sum"].add_(b["k"].to(torch.float32) + 1.0)
            launch()
            b["k"].add_(1)
            torch.lt(b["k"], b["n"], out=b["go"])
        graphs.while_loop(b["go"], once)

    kept = graphs.clone_tree(bufs)
    assert runner.warm_up(body, bufs) == 1
    assert runs == [False] and counter.launches == 0
    assert all(torch.equal(bufs[k], kept[k]) for k in bufs)
    runs.clear()
    runner.run(None, body, bufs)
    assert runs == [True] * count and int(bufs["k"]) == count
    assert float(bufs["sum"]) == count * (count + 1) / 2
    assert not bool(bufs["go"]) and counter.launches == count
    # captured, the body's launches are its delta, booked an iteration
    counter.launches = 0
    counter.launches_by_shape.clear()
    arm = graphs.Arm(runner.book.record(launch), torch.tensor(count),
                     "while")
    runner.arms = [arm]
    graphs.fetch(runners=[runner])
    assert arm.settled == count and counter.launches == count
    assert counter.launches_by_shape == (
        collections.Counter({(1, 400, 400): count}) if count
        else collections.Counter())
    with pytest.raises(ValueError, match="bool"):
        graphs.while_loop(torch.tensor([True]), lambda: None)


def _full_and_empty_log(obs, valid, odo):
    """``obs``/``valid`` with scans whose counts are 0, 1 and 16 (the
    detector's every slot, filled by repeating a scan's detections)."""
    obs, valid = obs.clone(), valid.clone()
    m = obs.shape[1]
    counts = valid.sum(dim=1)
    rich = [t for t in range(obs.shape[0]) if int(counts[t]) >= 2]
    for t in rich[::3]:
        c = int(counts[t])
        obs[t] = obs[t, torch.arange(m) % c]
        valid[t] = True
    for t in rich[1::3]:
        valid[t, 1:] = False
    for t in rich[2::6]:
        valid[t] = False
    return obs, valid, odo


def _interleaved_log(obs, valid, odo):
    """Each scan's valid rows spread over the even slots (the odd ones
    invalid, holding other rows), as a mask that is no prefix."""
    obs, valid = obs.clone(), valid.clone()
    m = obs.shape[1]
    for t in range(obs.shape[0]):
        c = min(int(valid[t].sum()), m // 2)
        rows = obs[t, :c].clone()
        obs[t] = obs[t].flip(0)
        valid[t] = False
        obs[t, 0:2 * c:2], valid[t, 0:2 * c:2] = rows, True
    return obs, valid, odo


@pytest.mark.parametrize("log", ["counts 0, 1 and 16", "interleaved"])
def test_one_graph_ekf_step_equals_eager_loop(ml_inputs, log):
    """``run_ml``'s one-graph step, its valid rows ordered and counted on
    the device, against the eager ``ekf_slam_step_ml`` loop given each
    scan's valid rows from the host."""
    obs, valid, odo, _ = ml_inputs
    make = _full_and_empty_log if log.startswith("counts") \
        else _interleaved_log
    obs, valid, odo = make(obs, valid, odo)
    counts = set(valid.sum(dim=1).tolist())
    if log.startswith("counts"):
        assert {0, 1, 16} <= counts
    else:
        assert not all(bool(v[:int(v.sum())].all()) for v in valid)
    draws = _draws(obs.shape[0], seed=4)
    want, want_state = _eager_ml(obs, valid, odo, None, draws, seed=6)
    path, state = tek.run_ml(obs, valid, odo, ML_CFG, seed=6, device="cpu",
                             draws=draws)
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


def test_hybrid_with_counts_0_and_16_equals_eager_loop(small_dataset):
    """``run_hybrid_inputs`` over a pre-pass whose detection counts take 0
    and 16 (rows duplicated into every slot) against the eager
    ``hybrid_step`` loop on the same inputs."""
    ranges = small_dataset[0][:N_HYBRID]
    inputs = thy.hybrid_inputs(ranges, DEFAULT_CONFIG, device="cpu")
    det = inputs.det
    rb, valid, count = det.rb.clone(), det.valid.clone(), det.count.clone()
    m = rb.shape[1]
    rich = [t for t in range(2, N_HYBRID) if int(count[t]) >= 1]
    for t in rich[::2]:
        rb[t] = rb[t, torch.arange(m) % int(count[t])]
        valid[t], count[t] = True, m
    for t in rich[1::4]:
        valid[t], count[t] = False, 0
    assert {0, m} <= set(count.tolist())
    inputs = inputs._replace(det=det._replace(rb=rb, valid=valid,
                                              count=count))
    draws = _draws(N_HYBRID - 1, seed=5)
    angles = angles_tensor(DEFAULT_CONFIG, "cpu")
    r = inputs.ranges
    state = thy.init_hybrid(r[0], ML_CFG, DEFAULT_CONFIG, seed=2)
    want = [torch.zeros(3)]
    for t in range(1, N_HYBRID):
        state, est = thy.hybrid_step(
            state, r[t], rb[t], valid[t], inputs.odo[t - 1], ML_CFG,
            DEFAULT_CONFIG, angles, draws[t - 1], n_det=int(count[t]))
        want.append(est)
    path, got = thy.run_hybrid_inputs(inputs, ML_CFG, DEFAULT_CONFIG, seed=2,
                                      draws=draws)
    assert torch.equal(path, torch.stack(want))
    assert_tree_equal(got._replace(ekf=got.ekf._replace(rng=None)),
                      state._replace(ekf=state.ekf._replace(rng=None)))
    assert got.step == N_HYBRID and state.mini_updated == got.mini_updated
