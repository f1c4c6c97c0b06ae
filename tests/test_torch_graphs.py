"""The captured drivers (``utils/graphs``, ``scan_matcher.make_step_fn``,
``fastslam.make_pf_step``) on the CPU, where the runner calls the same
bodies uncaptured on the same static buffers: the buffer handling (the
copies back, the aliased ``prev_pose``, a state loaded from outside, the
donated state) is what the card runs.

- ``copy_into`` and ``LaunchBook`` on their own (a fake launch
  counter stands in for the kernels');
- runner-driven ``run_scan`` and ``run_host_loop`` equal the eager
  ``slam_step`` loop bit for bit (path and final state) and JAX ``run_scan``
  on the same numpy ranges;
- runner-driven ``run_pf`` equals the eager ``pf_step`` loop bit for bit,
  with the port's generator and with JAX's draws injected, and stays within
  1e-3 of JAX's run on those draws (the bar of ``test_torch_fastslam.py``);
- ``make_pf_step`` resumed from a checkpoint equals the unbroken run;
- each of the five step objects (fidelity, submap, PF, hybrid, EKF) on
  the one protocol (``graphs.CapturedStep``): fed states it did not
  return (eager, its own, another step's) it equals the eager loop, it
  takes back the state it returned, and ``advance`` ... ``finish``
  (``graphs.drive``) and ``step`` a scan (``graphs.host_loop``) give the
  same path and final state;
- a state cloned out of the runner survives ``checkpoint`` and ``state_io``'s
  conversion to JAX's state (the fidelity state steps on in JAX to the
  port's next pose, bit for bit).
"""

import collections
import dataclasses
import os
import types
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import (assert_tree_equal, jax_grid, jax_pointmap,
                         jax_slam_state, to_numpy_tree)
from lidar_slam_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from lidar_slam_tpu.config import ParticleConfig as JaxParticleConfig
from lidar_slam_tpu.models import fastslam as jfs
from lidar_slam_tpu.models import scan_matcher as jsm
from lidar_slam_tpu_torch.config import (DEFAULT_CONFIG, ParticleConfig,
                                         SubmapConfig)
from lidar_slam_tpu_torch.models import ekf_hybrid as thy
from lidar_slam_tpu_torch.models import ekf_slam as tek
from lidar_slam_tpu_torch.models import fastslam as tfs
from lidar_slam_tpu_torch.models import scan_matcher as tsm
from lidar_slam_tpu_torch.models import state_io
from lidar_slam_tpu_torch.models import submap_slam as tss
from lidar_slam_tpu_torch.utils import checkpoint, graphs
from lidar_slam_tpu_torch.utils.tree import (is_generator, leaves_with_path,
                                             map_with_path)

N_FID = 60        # scans of the fidelity runs
N_PF = 40         # scans of the PF runs with the port's generator
P = 32
PF_CFG = dataclasses.replace(
    DEFAULT_CONFIG,
    particles=ParticleConfig(n_particles=P, vol_theta_bins=5, vol_half=4))
JAX_PF_CFG = dataclasses.replace(
    JAX_DEFAULT,
    particles=JaxParticleConfig(n_particles=P, vol_theta_bins=5, vol_half=4))
JAX_KEY_SEED = 4  # the seed test_torch_fastslam.py pins (within 1e-3)


# ---- the runner's pieces

def test_copy_into_clones_a_buffer_that_another_copy_writes():
    """``prev_pose := pose; pose := new``: the old pose reaches prev_pose."""
    pose, prev = torch.tensor([1.0, 2.0, 3.0]), torch.zeros(3)
    new = torch.tensor([4.0, 5.0, 6.0])
    bufs = {"pose": pose, "prev": prev}
    graphs.copy_into(bufs, {"pose": new, "prev": pose})
    assert torch.equal(bufs["pose"], new) and bufs["pose"] is pose
    assert torch.equal(bufs["prev"], torch.tensor([1.0, 2.0, 3.0]))


def test_copy_into_skips_a_leaf_that_is_its_buffer():
    buf = torch.zeros(4)
    before = buf._version
    graphs.copy_into((buf, 3), (buf, 7))
    assert buf._version == before


@pytest.mark.parametrize("bad", [torch.zeros(4, dtype=torch.float64),
                                 torch.zeros(5)])
def test_copy_into_refuses_another_shape_or_dtype(bad):
    with pytest.raises(ValueError, match="does not fit its buffer"):
        graphs.copy_into((torch.zeros(4),), (bad,))


def _fake_counter():
    return types.SimpleNamespace(launches=0,
                                 launches_by_shape=collections.Counter())


def test_launch_book_adds_the_captured_delta_once_a_replay():
    """What a capture counts is taken out again and added once a replay,
    launches and launches by shape alike; other counters are untouched."""
    a, b = _fake_counter(), _fake_counter()
    a.launches, a.launches_by_shape[(9,)] = 3, 3
    book = graphs.LaunchBook((a, b))

    def capture():   # what a body's kernel wrappers do while it is captured
        a.launches += 2
        a.launches_by_shape[(1, 200, 200)] += 1
        a.launches_by_shape[(1, 400, 400)] += 1
        b.launches += 1
        b.launches_by_shape[(1, 7, 6, 400)] += 1

    delta = book.record(capture)
    assert a.launches == 3 and dict(a.launches_by_shape) == {(9,): 3}
    assert b.launches == 0 and not b.launches_by_shape
    for replay in range(1, 4):
        book.add(delta)
        assert a.launches == 3 + 2 * replay
        assert a.launches_by_shape == collections.Counter(
            {(9,): 3, (1, 200, 200): replay, (1, 400, 400): replay})
        assert b.launches == replay
        assert b.launches_by_shape == collections.Counter(
            {(1, 7, 6, 400): replay})


def test_graphs_on_the_cpu_call_the_body_on_the_buffers():
    counter = _fake_counter()
    runner = graphs.Graphs(torch.device("cpu"), counters=(counter,))
    buf = torch.zeros(3)

    def body(b):
        b.add_(1.0)

    for _ in range(3):
        runner.run("k", body, buf)
    assert torch.equal(buf, torch.full((3,), 3.0))
    assert counter.launches == 0 and runner.pool_bytes() == 0


# ---- the fidelity drivers

def _eager_fidelity(ranges):
    """The eager ``slam_step`` loop: (poses of scans 1.., final state)."""
    r = torch.as_tensor(ranges)
    angles = tsm.angles_tensor(DEFAULT_CONFIG, "cpu")
    state = tsm.init_state(r[0], DEFAULT_CONFIG)
    poses = []
    for t in range(1, len(r)):
        state, pose = tsm.slam_step(state, r[t], DEFAULT_CONFIG, angles)
        poses.append(pose)
    return torch.stack(poses), state


@pytest.fixture(scope="module")
def fidelity(small_dataset):
    ranges = small_dataset[0][:N_FID]
    path, state = _eager_fidelity(ranges)
    return ranges, torch.cat([torch.zeros((1, 3)), path]), state


def test_run_scan_equals_the_eager_loop_and_jax(fidelity):
    ranges, want, want_state = fidelity
    path, state = tsm.run_scan(ranges, DEFAULT_CONFIG, device="cpu")
    assert torch.equal(path, want)
    assert_tree_equal(state, want_state)
    jpath, _ = jsm.run_scan(ranges, JAX_DEFAULT)
    assert np.array_equal(path.numpy(), np.asarray(jpath))


def test_run_host_loop_equals_the_eager_loop(fidelity):
    ranges, want, want_state = fidelity
    path, state = tsm.run_host_loop(ranges, DEFAULT_CONFIG, device="cpu")
    assert np.array_equal(path, want.numpy())
    assert state.step == want_state.step == N_FID
    assert torch.equal(state.pmap.xy, want_state.pmap.xy)


# ---- the particle-filter drivers

def _eager_pf(ranges, cfg, seed=0, draws=None):
    r = torch.as_tensor(ranges)
    angles = tsm.angles_tensor(cfg, "cpu")
    state = tfs.init_particles(r[0], cfg, seed)
    poses = [torch.zeros(3)]
    for t in range(1, len(r)):
        state, pose = tfs.pf_step(state, r[t], cfg, angles,
                                  None if draws is None else draws[t - 1])
        poses.append(pose)
    return torch.stack(poses), state


def _jax_draws(rng_key, p=P):
    """The draws JAX's pf_step takes from its state key (as
    ``tests/test_torch_fastslam.py``)."""
    _, k_noise, k_resample = jax.random.split(rng_key, 3)
    noise = np.array(jax.random.normal(k_noise, (p, 3)))
    u0 = np.array(jax.random.uniform(k_resample, (), minval=0.0,
                                       maxval=1.0 / p))
    return noise, u0


@pytest.fixture(scope="module")
def jax_pf(small_dataset):
    """JAX's run on the whole small tour with its draws recorded."""
    ranges, _ = small_dataset
    step = jfs.make_pf_step(JAX_PF_CFG)
    state = jfs.init_particles(jnp.asarray(ranges[0]), JAX_PF_CFG,
                               JAX_KEY_SEED)
    draws, path = [], [np.zeros(3, np.float32)]
    for t in range(1, len(ranges)):
        draws.append(_jax_draws(state.rng))
        state, pose = step(state, jnp.asarray(ranges[t]))
        path.append(np.asarray(pose))
    return draws, np.stack(path)


def _pf_tree(state):
    return state._replace(rng=None)   # generators compare by their state


@pytest.mark.parametrize("draws_from", ["generator", "jax"])
def test_run_pf_equals_the_eager_loop(small_dataset, jax_pf, draws_from):
    """Path and final state equal the eager loop's, bit for bit: with the
    port's generator (40 scans; the generator ends in the same state) and
    with JAX's draws (the whole tour; within 1e-3 of JAX's path)."""
    ranges, _ = small_dataset
    draws, jpath = jax_pf
    if draws_from == "generator":
        ranges, draws = ranges[:N_PF], None
    want, want_state = _eager_pf(ranges, PF_CFG, seed=3, draws=draws)
    path, state = tfs.run_pf(ranges, PF_CFG, seed=3, device="cpu",
                             draws=draws)
    assert torch.equal(path, want)
    assert_tree_equal(_pf_tree(state), _pf_tree(want_state))
    assert state.step == want_state.step == len(ranges)
    if draws is None:   # the generator stream went on the same way
        assert torch.equal(state.rng.get_state(), want_state.rng.get_state())
    else:
        assert np.abs(path.numpy() - jpath).max() <= 1e-3


@pytest.mark.parametrize("k", [12, 25])
def test_pf_step_resumed_from_a_checkpoint_equals_the_unbroken_run(
        small_dataset, tmp_path, k):
    """``make_pf_step`` for k scans, the state cloned out and saved, loaded
    into a template of another seed, and a new step on from there: the
    path and the final state (generator included) equal ``run_pf``'s."""
    ranges = small_dataset[0][:N_PF]
    want, want_state = tfs.run_pf(ranges, PF_CFG, seed=5, device="cpu")
    r = torch.as_tensor(ranges)
    step = tfs.make_pf_step(PF_CFG, "cpu")
    state = tfs.init_particles(r[0], PF_CFG, seed=5)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, k):
        state, pose = step(state, r[t])
        poses.append(pose)
    ckpt = os.path.join(tmp_path, "pf.npz")
    checkpoint.save_state(ckpt, graphs.clone_tree(state))
    state = checkpoint.load_state(ckpt, tfs.init_particles(r[0], PF_CFG, 99))
    assert state.step == k
    step = tfs.make_pf_step(PF_CFG, "cpu")
    for t in range(k, N_PF):
        state, pose = step(state, r[t])
        poses.append(pose)
    assert np.array_equal(np.stack(poses), want.numpy())
    assert_tree_equal(_pf_tree(state), _pf_tree(want_state))
    assert torch.equal(state.rng.get_state(), want_state.rng.get_state())


# ---- the five step objects on the one protocol (graphs.CapturedStep)

N_STEP = N_FID    # scans of each step object's runs
SUBMAP_CFG = dataclasses.replace(DEFAULT_CONFIG, submaps=SubmapConfig(
    n_submaps=4, submap_capacity=512, k_nearest=2, spawn_dist=0.4,
    spawn_fill_frac=0.8))
EKF_CFG = tek.long_tour_config(64)
STEPS = ("fidelity", "submap", "pf", "hybrid", "ekf")


class StepCase(NamedTuple):
    """A step object's run: ``make()`` a new step, ``init()`` the state
    before scan 1, ``inputs(t)`` step t's inputs, ``eager(state, t)`` the
    eager step's (state, pose)."""
    make: object
    init: object
    inputs: object
    eager: object


def _step_case(name, ranges) -> StepCase:
    r = torch.as_tensor(ranges[:N_STEP])
    if name in ("fidelity", "submap"):
        mod, cfg = (tsm, DEFAULT_CONFIG) if name == "fidelity" \
            else (tss, SUBMAP_CFG)
        angles = tsm.angles_tensor(cfg, "cpu")
        return StepCase(lambda: mod.make_step_fn(cfg, "cpu"),
                        lambda: mod.init_state(r[0], cfg),
                        lambda t: (r[t],),
                        lambda s, t: mod.slam_step(s, r[t], cfg, angles))
    if name == "pf":
        angles = tsm.angles_tensor(PF_CFG, "cpu")
        return StepCase(lambda: tfs.make_pf_step(PF_CFG, "cpu"),
                        lambda: tfs.init_particles(r[0], PF_CFG, 7),
                        lambda t: (r[t],),
                        lambda s, t: tfs.pf_step(s, r[t], PF_CFG, angles))
    if name == "hybrid":
        pre = thy.hybrid_inputs(r.numpy(), DEFAULT_CONFIG, device="cpu")
        det, odo = pre.det, pre.odo
        angles = tsm.angles_tensor(DEFAULT_CONFIG, "cpu")
        return StepCase(
            lambda: thy.HybridStepFn(EKF_CFG, DEFAULT_CONFIG, "cpu"),
            lambda: thy.init_hybrid(r[0], EKF_CFG, DEFAULT_CONFIG, seed=7),
            lambda t: (r[t], det.rb[t], det.valid[t], odo[t - 1],
                       pre.seed_count),
            lambda s, t: thy.hybrid_step(s, r[t], det.rb[t], det.valid[t],
                                         odo[t - 1], EKF_CFG, DEFAULT_CONFIG,
                                         angles))
    obs, valid, odo, _ = tek.scan_inputs(
        r.numpy(), EKF_CFG, max_range=tek.LONG_TOUR_MAX_RANGE, device="cpu")
    return StepCase(
        lambda: tek.EkfStepFn(EKF_CFG, "cpu"),
        lambda: tek.init_ekf_slam(EKF_CFG, 7, "cpu"),
        lambda t: (obs[t - 1], valid[t - 1], odo[t - 1]),
        lambda s, t: tek.ekf_slam_step_ml(s, obs[t - 1], valid[t - 1],
                                          EKF_CFG, odo=odo[t - 1]))


@pytest.fixture(scope="module")
def step_cases(small_dataset):
    """Each step object's case and its eager loop's (poses of scans 0..,
    final state)."""
    out = {}
    for name in STEPS:
        case = _step_case(name, small_dataset[0])
        state, poses = case.init(), [torch.zeros(3)]
        for t in range(1, N_STEP):
            state, pose = case.eager(state, t)
            poses.append(pose)
        out[name] = case, torch.stack(poses), state
    return out


def _host_paths():
    return {"." + ".".join(p) for p in graphs.HOST_FIELDS}


def _buffers(state) -> list:
    """The tensor leaves of a state, its host fields left out."""
    host = _host_paths()
    return [x for p, x in leaves_with_path(state)
            if isinstance(x, torch.Tensor) and p not in host]


def _assert_same_state(got, want):
    """Equal bit for bit, generators by their state; host fields as host
    values."""
    def split(state):
        return map_with_path(lambda _, x: None if is_generator(x) else x,
                             state), [x.get_state() for _, x in
                                      leaves_with_path(state)
                                      if is_generator(x)]
    (g, g_rng), (w, w_rng) = split(got), split(want)
    assert_tree_equal(g, w)
    assert all(torch.equal(a, b) for a, b in zip(g_rng, w_rng, strict=True))
    for p, x in leaves_with_path(got):
        if p in _host_paths():
            assert type(x) in (bool, int), p


@pytest.mark.parametrize("name", STEPS)
def test_step_takes_a_state_it_did_not_return(step_cases, name):
    """A step fed an eager state mid-run, then its own, then a state
    another step returned (by ``advance``, its host fields device values,
    or by ``step``, host values), equals the eager loop; and a state it
    returned is its buffers, taken back by the next call (donated)."""
    case, want, want_state = step_cases[name]
    state = case.init()
    for t in range(1, 20):
        state, _ = case.eager(state, t)
    a, b = case.make(), case.make()
    for t in range(20, N_STEP):   # b starts from a's state of an advance
        step = a if (t // 4) % 2 == 0 else b
        if t % 3 == 0:
            state, pose = step(state, *case.inputs(t))
            assert np.array_equal(np.asarray(pose), want[t].numpy()), t
        else:
            state = step.advance(state, *case.inputs(t))
        assert torch.equal(step.pose, want[t]), t
    _assert_same_state(graphs.clone_tree(step.finish(state)), want_state)
    kept = graphs.clone_tree(state)
    again = step.advance(state, *case.inputs(20))
    assert all(x is y for x, y in zip(_buffers(again), _buffers(state),
                                      strict=True))      # the same buffers
    assert not all(torch.equal(x, y) for x, y in zip(
        _buffers(state), _buffers(kept), strict=True))   # ... taken back


@pytest.mark.parametrize("name", STEPS)
def test_advance_and_step_give_the_same_path_and_host_fields(step_cases,
                                                              name):
    """One run through ``advance`` and ``finish`` (no host read until the
    end) and one through ``step`` (the pose and the host fields read a
    step): the same path, the eager loop's, and the same final state with
    its host fields as host values."""
    case, want, want_state = step_cases[name]
    path, ran = graphs.drive(case.make(), case.init(), N_STEP, case.inputs)
    step, called, host = case.make(), case.init(), [np.zeros(3, np.float32)]
    for t in range(1, N_STEP):
        called, pose = step(called, *case.inputs(t))
        host.append(np.array(pose))   # a copy: the EKF's is its buffer
    called = graphs.clone_tree(step.finish(called))
    assert torch.equal(path, want)
    assert np.array_equal(np.stack(host), want.numpy())
    _assert_same_state(ran, want_state)
    _assert_same_state(called, want_state)


# ---- states out of the runner

def test_fidelity_state_out_of_the_runner_saves_and_steps_in_jax(
        small_dataset, tmp_path):
    """The state out of ``run_scan`` after 33 scans: saved and loaded bit
    for bit; converted by ``state_io`` to JAX's state, one JAX step from it
    gives the port's next pose."""
    ranges, _ = small_dataset
    t = 33
    _, state = tsm.run_scan(ranges[:t], DEFAULT_CONFIG, device="cpu")
    ckpt = os.path.join(tmp_path, "fid.npz")
    checkpoint.save_state(ckpt, state)
    loaded = checkpoint.load_state(
        ckpt, tsm.init_state(torch.as_tensor(ranges[0]), DEFAULT_CONFIG))
    assert_tree_equal(loaded, state)
    _, tpose = tsm.slam_step(loaded, torch.as_tensor(ranges[t]),
                             DEFAULT_CONFIG,
                             tsm.angles_tensor(DEFAULT_CONFIG, "cpu"))
    jstate = jax_slam_state(state_io.slam_state_to_numpy(state))
    _, jpose = jsm.make_step_fn(JAX_DEFAULT)(jstate, jnp.asarray(ranges[t]))
    assert np.array_equal(tpose.numpy(), np.asarray(jpose))


def test_pf_state_out_of_the_runner_saves_and_converts_to_jax(
        small_dataset, tmp_path):
    """The state out of ``run_pf`` after 24 scans: saved and loaded bit for
    bit, generator included; converted by ``state_io`` into JAX's own
    ``ParticleState`` and back, bit for bit; and JAX's step takes it.

    One step from it in both packages is not compared here: from the port's
    own state the 27-candidate refinement meets a near-tie that the two
    packages' last-bit differences split one fine step apart (see
    ``test_torch_fastslam.py::test_pf_run_with_injected_draws``)."""
    ranges, _ = small_dataset
    t = 24
    _, state = tfs.run_pf(ranges[:t], PF_CFG, seed=0, device="cpu")
    ckpt = os.path.join(tmp_path, "pf.npz")
    checkpoint.save_state(ckpt, state)
    loaded = checkpoint.load_state(
        ckpt, tfs.init_particles(torch.as_tensor(ranges[0]), PF_CFG, 9))
    assert_tree_equal(_pf_tree(loaded), _pf_tree(state))
    assert torch.equal(loaded.rng.get_state(), state.rng.get_state())
    snap = state_io.particle_state_to_numpy(state)
    jstate = jfs.ParticleState(
        poses=jnp.asarray(snap.poses), prev_poses=jnp.asarray(snap.prev_poses),
        logw=jnp.asarray(snap.logw), step=jnp.int32(snap.step),
        mini_updated=jnp.bool_(snap.mini_updated),
        pmap=jax_pointmap(snap.pmap), fine=jax_grid(snap.fine),
        fine_metric=jnp.asarray(snap.fine_metric),
        rng=jax.random.PRNGKey(JAX_KEY_SEED),
        clamp_frac=jnp.float32(snap.clamp_frac))
    back = state_io.particle_state_from_numpy(
        to_numpy_tree(jstate._replace(rng=None)), "cpu")
    # the pixel size, a config number, comes back as JAX's f32 of it
    assert_tree_equal(_pf_tree(back)._replace(fine=None),
                      _pf_tree(state)._replace(fine=None))
    assert_tree_equal(back.fine._replace(pixel=None),
                      state.fine._replace(pixel=None))
    jnew, jpose = jfs.make_pf_step(JAX_PF_CFG)(jstate, jnp.asarray(ranges[t]))
    assert int(jnew.step) == t + 1 and np.isfinite(np.asarray(jpose)).all()
