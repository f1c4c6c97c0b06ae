"""JAX's on-device ``lax.cond`` in the port (``utils/graphs.cond``) and the
drivers that branch on the card with it, on the CPU, where the runner
calls the same bodies uncaptured and ``cond`` takes the arm ``bool(pred)``
picks:

- ``cond`` takes the right arm; a ``Graphs`` warm-up runs both arms on a
  clone of the buffers and leaves them as they were;
- ``fetch`` adds each conditional arm's launch delta once for every run of
  the arm its device counter counted, so the counts equal the eager loop's;
- ``run_scan`` on 300 museum scans equals the eager ``slam_step`` loop, JAX
  ``run_scan`` and the C++ oracle bit for bit, its final state (host
  ``mini_updated`` and ``step`` included) the eager loop's;
- ``run_pf`` with JAX's draws injected equals the eager ``pf_step`` loop bit
  for bit and JAX's run within 1e-3 (the bar of ``test_torch_fastslam.py``);
- ``run_ekf_hybrid`` equals its eager ``hybrid_step`` loop;
- ``GraphSlam.run`` for ``graph`` and ``pf-graph`` on a short loop tour
  equals ``eager=True``: path, keyframes, closures and the attempt log.

The card runs the same drivers with the branches as CUDA graph conditional
nodes: ``tests/test_torch_cuda.py`` (``-k no_sync``) and ``chip_smoke.py``
phases 6c and 14c.
"""

import collections
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import assert_tree_equal
from lidar_slam_tpu import native
from lidar_slam_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from lidar_slam_tpu.config import ParticleConfig as JaxParticleConfig
from lidar_slam_tpu.io import simulate as jsim
from lidar_slam_tpu.models import fastslam as jfs
from lidar_slam_tpu.models import scan_matcher as jsm
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu_torch.io import simulate as tsim
from lidar_slam_tpu_torch.models import ekf_hybrid as thy
from lidar_slam_tpu_torch.models import ekf_slam as tek
from lidar_slam_tpu_torch.models import fastslam as tfs
from lidar_slam_tpu_torch.models import graph_slam as tgs
from lidar_slam_tpu_torch.models import pf_graph_slam as tpfg
from lidar_slam_tpu_torch.models import scan_matcher as tsm
from lidar_slam_tpu_torch.utils import graphs

N_MUSEUM = 300    # museum scans of the fidelity run
P = 32
PF_CFG = dataclasses.replace(
    DEFAULT_CONFIG,
    particles=ParticleConfig(n_particles=P, vol_theta_bins=5, vol_half=4))
JAX_PF_CFG = dataclasses.replace(
    JAX_DEFAULT,
    particles=JaxParticleConfig(n_particles=P, vol_theta_bins=5, vol_half=4))
JAX_KEY_SEED = 4  # the seed test_torch_fastslam.py pins (within 1e-3)
N_HYBRID = 60
N_LOOP = 120      # loop-tour scans of the graph runs, chunks of 32


# ---- cond, the warm-up and the arms' launch book

@pytest.mark.parametrize("with_false", [True, False])
@pytest.mark.parametrize("pred", [True, False])
def test_cond_takes_the_arm_pred_picks_on_the_cpu(pred, with_false):
    taken = []
    graphs.cond(torch.tensor(pred), lambda: taken.append("true"),
                (lambda: taken.append("false")) if with_false else None)
    want = ["true"] if pred else (["false"] if with_false else [])
    assert taken == want


def _fake_counter():
    return types.SimpleNamespace(launches=0,
                                 launches_by_shape=collections.Counter())


def test_warm_up_runs_both_arms_on_a_clone():
    """Both arms of each branch run, on a clone: the buffers keep their
    values and the launches the arms made are not counted."""
    counter = _fake_counter()
    runner = graphs.Graphs(torch.device("cpu"), counters=(counter,))
    bufs = {"flag": torch.tensor(True), "a": torch.zeros(3),
            "b": torch.ones(3)}
    seen = []

    def arm(name, b, value):
        def run():
            seen.append((name, b is not bufs[name[0]]))
            b.fill_(value)
            counter.launches += 1
            counter.launches_by_shape[(1, 400, 400)] += 1
        return run

    def body(b):
        graphs.cond(b["flag"], arm("a-true", b["a"], 7.0),
                    arm("a-false", b["a"], 8.0))
        graphs.cond(~b["flag"], arm("b-true", b["b"], 9.0))

    kept = graphs.clone_tree(bufs)
    assert runner.warm_up(body, bufs) == 3
    assert [name for name, _ in seen] == ["a-true", "a-false", "b-true"]
    assert all(on_clone for _, on_clone in seen)
    assert all(torch.equal(bufs[k], kept[k]) for k in bufs)
    assert counter.launches == 0 and not counter.launches_by_shape
    # run on the CPU, the same body takes one arm of each branch
    runner.run("step", body, bufs)
    assert seen[3:] == [("a-true", False)] and torch.equal(
        bufs["a"], torch.full((3,), 7.0))
    assert torch.equal(bufs["b"], torch.ones(3))


def test_fetch_adds_each_arm_delta_once_a_run():
    """Each arm's delta is recorded alone (as a capture records it); the
    arms' device counters, read by ``fetch`` mid-run and at the end, give
    the eager loop's launches by shape, and an arm that never ran adds no
    shape."""
    def keyframe(c):     # the fidelity keyframe arm's two K1 shapes
        c.launches += 2
        c.launches_by_shape[(1, 200, 200)] += 1
        c.launches_by_shape[(1, 400, 400)] += 1

    def refresh(c):      # the PF refresh's one
        c.launches += 1
        c.launches_by_shape[(1, 400, 400)] += 1

    def never(c):
        c.launches += 1
        c.launches_by_shape[(8, 256, 256)] += 1

    counter, eager = _fake_counter(), _fake_counter()
    runner = graphs.Graphs(torch.device("cpu"), counters=(counter,))
    bodies = (keyframe, refresh, never)
    runner.arms = [graphs.Arm(runner.book.record(lambda fn=fn: fn(counter)),
                              torch.zeros((), dtype=torch.int64))
                   for fn in bodies]
    assert counter.launches == 0
    taken = np.random.default_rng(0).random((40, 3)) < 0.3
    taken[:, 2] = False
    for t, row in enumerate(taken):
        for arm, fn, ran in zip(runner.arms, bodies, row):
            if ran:
                arm.count += 1   # what the arm does inside the graph
                fn(eager)        # what the eager loop launches
        if t in (17, 39):
            graphs.fetch(runners=[runner])
    assert counter.launches == eager.launches > 0
    assert counter.launches_by_shape == eager.launches_by_shape
    assert (8, 256, 256) not in counter.launches_by_shape
    assert [a.settled for a in runner.arms] == taken.sum(0).tolist()


# ---- the drivers against their eager loops

@pytest.fixture(scope="module")
def museum():
    ranges, _ = tsim.generate_dataset(N_MUSEUM, seed=0)
    return np.asarray(ranges, np.float32)


def test_run_scan_equals_eager_jax_and_the_oracle(museum):
    ranges = museum
    r = torch.as_tensor(ranges)
    angles = tsm.angles_tensor(DEFAULT_CONFIG, "cpu")
    state = tsm.init_state(r[0], DEFAULT_CONFIG)
    want = [state.pose]
    for t in range(1, len(r)):
        state, pose = tsm.slam_step(state, r[t], DEFAULT_CONFIG, angles)
        want.append(pose)
    path, got = tsm.run_scan(ranges, DEFAULT_CONFIG, device="cpu")
    assert torch.equal(path, torch.stack(want))
    assert_tree_equal(got, state)
    assert got.step == state.step == N_MUSEUM
    assert type(got.mini_updated) is bool
    assert got.mini_updated == state.mini_updated
    jpath, jstate = jsm.run_scan(ranges, JAX_DEFAULT)
    assert np.array_equal(path.numpy(), np.asarray(jpath))
    assert bool(jstate.mini_updated) == got.mini_updated
    cpath, _ = native.run_oracle(ranges)
    assert np.array_equal(path.numpy(), cpath)


def _jax_draws(rng_key, p=P):
    """The draws JAX's pf_step takes from its state key."""
    _, k_noise, k_resample = jax.random.split(rng_key, 3)
    noise = np.array(jax.random.normal(k_noise, (p, 3)))
    u0 = np.array(jax.random.uniform(k_resample, (), minval=0.0,
                                       maxval=1.0 / p))
    return noise, u0


def test_run_pf_with_injected_draws_equals_eager_and_jax(small_dataset):
    ranges, _ = small_dataset
    step = jfs.make_pf_step(JAX_PF_CFG)
    jstate = jfs.init_particles(jnp.asarray(ranges[0]), JAX_PF_CFG,
                                JAX_KEY_SEED)
    draws, jpath = [], [np.zeros(3, np.float32)]
    for t in range(1, len(ranges)):
        draws.append(_jax_draws(jstate.rng))
        jstate, pose = step(jstate, jnp.asarray(ranges[t]))
        jpath.append(np.asarray(pose))
    r = torch.as_tensor(ranges)
    angles = tsm.angles_tensor(PF_CFG, "cpu")
    state = tfs.init_particles(r[0], PF_CFG, 0)
    want = [torch.zeros(3)]
    for t in range(1, len(r)):
        state, pose = tfs.pf_step(state, r[t], PF_CFG, angles, draws[t - 1])
        want.append(pose)
    path, got = tfs.run_pf(ranges, PF_CFG, seed=0, device="cpu", draws=draws)
    assert torch.equal(path, torch.stack(want))
    assert_tree_equal(got._replace(rng=None), state._replace(rng=None))
    assert got.step == len(ranges) and type(got.mini_updated) is bool
    assert got.mini_updated == state.mini_updated
    assert np.abs(path.numpy() - np.stack(jpath)).max() <= 1e-3


def test_run_ekf_hybrid_equals_its_eager_loop(museum):
    from lidar_slam_tpu_torch.ops import landmarks as lm_ops
    from lidar_slam_tpu_torch.ops.scan_odometry import pairwise_odometry

    cfg = tek.long_tour_config(P)
    ranges = museum[:N_HYBRID]
    rng = np.random.default_rng(2)
    draws = [(rng.standard_normal((P, 3)).astype(np.float32),
              np.float32(rng.random() / P)) for _ in range(N_HYBRID - 1)]
    r = torch.as_tensor(ranges)
    angles = tsm.angles_tensor(DEFAULT_CONFIG, "cpu")
    det = lm_ops.extract_corners(
        r, angles, range_min=DEFAULT_CONFIG.lidar.range_min,
        usable_range=DEFAULT_CONFIG.lidar.usable_range, max_range=12.0)
    odo = pairwise_odometry(r, angles, DEFAULT_CONFIG.lidar)
    counts = det.count.numpy()
    state = thy.init_hybrid(r[0], cfg, DEFAULT_CONFIG, seed=1)
    want = [torch.zeros(3)]
    for t in range(1, N_HYBRID):
        state, est = thy.hybrid_step(
            state, r[t], det.rb[t], det.valid[t], odo[t - 1], cfg,
            DEFAULT_CONFIG, angles, draws[t - 1], n_det=int(counts[t]))
        want.append(est)
    path, got = thy.run_ekf_hybrid(ranges, cfg, DEFAULT_CONFIG, seed=1,
                                   device="cpu", draws=draws)
    assert torch.equal(path, torch.stack(want))
    assert_tree_equal(got._replace(ekf=got.ekf._replace(rng=None)),
                      state._replace(ekf=state.ekf._replace(rng=None)))
    assert got.step == N_HYBRID and type(got.mini_updated) is bool
    assert got.mini_updated == state.mini_updated


@pytest.fixture(scope="module")
def loop_tour():
    ranges, _ = jsim.generate_dataset(N_LOOP, seed=1,
                                      waypoints=jsim.LOOP_WAYPOINTS)
    return np.asarray(ranges, np.float32)


@pytest.mark.parametrize("frontend", ["graph", "pf-graph"])
def test_graph_run_equals_eager(loop_tour, frontend):
    """Path, keyframes, closures, the attempt log and the final state (its
    ``mini_updated`` a host bool) equal ``eager=True``'s."""
    lc = tgs.LoopClosureConfig(min_gap=3, weak_closures=frontend != "graph")
    runs = []
    for eager in (False, True):
        if frontend == "graph":
            gs = tgs.GraphSlam(DEFAULT_CONFIG, lc, device="cpu", eager=eager)
        else:
            gs = tpfg.PFGraphSlam(PF_CFG, lc, seed=2, device="cpu",
                                  eager=eager)
        path, opt = gs.run(loop_tour, chunk_size=32)
        runs.append((gs, path, opt))
    (g, path, opt), (e, epath, eopt) = runs
    assert np.array_equal(path, epath) and np.array_equal(opt, eopt)
    assert g.kf_times == e.kf_times and g.kf.count == e.kf.count
    assert g.closures == e.closures and g.weak_closures == e.weak_closures
    assert g.attempt_log == e.attempt_log and len(g.attempt_log) > 0
    assert type(g.final_state.mini_updated) is bool
    state, estate = g.final_state, e.final_state
    if frontend == "pf-graph":
        state, estate = state._replace(rng=None), estate._replace(rng=None)
    assert_tree_equal(state, estate)
