"""The captured graph frontends and the captured submap step on the CPU,
where the runner calls the same bodies uncaptured on the same static
buffers (``utils/graphs``): each driver equals its eager loop bit for bit.

- ``GraphSlam.run`` (fidelity frontend), ``SubmapGraphSlam.run`` and
  ``PFGraphSlam.run`` (JAX's draws injected, and the port's generator)
  against the same classes with ``eager=True``: path, optimized keyframes,
  closures, feedback epochs and the final frontend state, through at least
  one feedback (``_rebuild_frontend`` hands the step a state it did not
  return);
- submap ``run_scan`` and ``run_host_loop`` against the eager ``slam_step``
  loop with a pool of 4 small submaps, so the tour spawns into every slot
  and then takes the pool-full branch: the active slot is a device buffer,
  not a constant of a graph;
- a submap step fed states it did not return (another step's, the eager
  loop's, one with re-anchored submaps).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_util import assert_tree_equal
from lidar_slam_tpu.io import simulate as jsim
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu_torch.config import SubmapConfig
from lidar_slam_tpu_torch.core import submap
from lidar_slam_tpu_torch.models import graph_slam as tgs
from lidar_slam_tpu_torch.models import pf_graph_slam as tpfg
from lidar_slam_tpu_torch.models import submap_slam as tss
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor
from lidar_slam_tpu_torch.models.submap_graph_slam import SubmapGraphSlam
from lidar_slam_tpu_torch.utils import graphs

N_LOOP = 160      # loop-tour scans: 19 keyframes, 3 closures, 1 feedback
CHUNK = 32
LC = tgs.LoopClosureConfig(min_gap=3)
# a pool of 4 submaps of 512 points that the small tour outgrows
POOL_CFG = dataclasses.replace(DEFAULT_CONFIG, submaps=SubmapConfig(
    n_submaps=4, submap_capacity=512, k_nearest=2, spawn_dist=0.4,
    spawn_fill_frac=0.8))


def _no_rng(state):
    """A state with its generator out (generators compare by state)."""
    return state._replace(rng=None) if hasattr(state, "rng") else state


def _assert_runs_equal(got, want):
    """Two graph runs ``(gs, path, kf_poses)``: equal bit for bit."""
    (g, path, opt), (e, epath, eopt) = got, want
    assert np.array_equal(path, epath)
    assert np.array_equal(opt, eopt)
    assert g.kf.count == e.kf.count
    assert g.closures == e.closures and g.weak_closures == e.weak_closures
    assert g.closure_rejects == e.closure_rejects
    assert g.path_epoch == e.path_epoch
    assert_tree_equal(_no_rng(g.final_state), _no_rng(e.final_state))


@pytest.fixture(scope="module")
def loop_tour():
    return jsim.generate_dataset(N_LOOP, seed=1,
                                 waypoints=jsim.LOOP_WAYPOINTS)


@pytest.mark.parametrize("cls", [tgs.GraphSlam, SubmapGraphSlam],
                         ids=["graph", "submap-graph"])
def test_graph_run_captured_equals_eager(loop_tour, cls):
    ranges, _ = loop_tour
    runs = []
    for eager in (False, True):
        gs = cls(DEFAULT_CONFIG, LC, device="cpu", eager=eager)
        path, opt = gs.run(ranges, chunk_size=CHUNK)
        runs.append((gs, path, opt))
    _assert_runs_equal(*runs)
    gs = runs[0][0]
    assert len(gs.closures) >= 1 and gs._epoch >= 1   # a feedback happened
    if cls is SubmapGraphSlam:
        assert gs.anchor_assoc.keys() == runs[1][0].anchor_assoc.keys()
        assert gs.final_state.atlas.n_submaps >= 2


def _jax_draws(n, p, seed=0):
    key = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(n):
        key, k_noise, k_res = jax.random.split(key, 3)
        draws.append((np.array(jax.random.normal(k_noise, (p, 3))),
                      np.array(jax.random.uniform(k_res, (), minval=0.0,
                                                  maxval=1.0 / p))))
    return draws


@pytest.mark.parametrize("draws_from", ["jax", "generator"])
def test_pf_graph_run_captured_equals_eager(draws_from):
    """PF-graph, 64 loop-tour scans, 32 particles (the frontend of
    ``test_torch_graph.py::test_pf_graph_injected_draws_match_jax``): the
    captured run equals the eager one, generator state included."""
    p = 32
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=p))
    ranges, _ = jsim.generate_dataset(64, seed=0,
                                      waypoints=jsim.LOOP_WAYPOINTS)
    draws = _jax_draws(len(ranges) - 1, p) if draws_from == "jax" else None
    lc = tgs.LoopClosureConfig(weak_closures=True, min_gap=3)
    runs = []
    for eager in (False, True):
        gs = tpfg.PFGraphSlam(cfg, lc, seed=2, device="cpu", draws=draws,
                              eager=eager)
        path, opt = gs.run(ranges, chunk_size=CHUNK)
        runs.append((gs, path, opt))
    _assert_runs_equal(*runs)
    a, b = (r[0].final_state.rng.get_state() for r in runs)
    assert torch.equal(a, b)
    assert runs[0][0].kf.count > 5


# ---- the submap step

def _eager_submap(ranges, cfg):
    """The eager ``slam_step`` loop: (path (T, 3), final state)."""
    r = torch.as_tensor(ranges)
    angles = angles_tensor(cfg, "cpu")
    state = tss.init_state(r[0], cfg)
    poses = [state.pose]
    for t in range(1, len(r)):
        state, pose = tss.slam_step(state, r[t], cfg, angles)
        poses.append(pose)
    return torch.stack(poses), state


def test_submap_run_equals_eager_through_spawns_and_a_full_pool(
        small_dataset, monkeypatch):
    """Every slot of the pool is opened, then the pool-full branch is taken,
    by the eager loop (``spawned`` on the host ints) and by the captured
    step's device spawn (``open_next_slot`` / ``keep_last_slot``, arms of
    one graph): the same spawns in the same order. The captured drivers
    equal the eager loop: path, atlas (points, sizes, anchors, slot ints)
    and state, whose host fields ``finish`` reads back as host values."""
    ranges, _ = small_dataset
    full_pool = []   # a spawn each: True where the pool was full
    spawned = submap.spawned
    opened, kept = submap.open_next_slot, submap.keep_last_slot

    def counting(atlas):
        full_pool.append(atlas.n_submaps >= atlas.pts.shape[0])
        return spawned(atlas)

    def open_counting(*args):
        full_pool.append(False)
        opened(*args)

    def keep_counting(*args):
        full_pool.append(True)
        kept(*args)

    monkeypatch.setattr(submap, "spawned", counting)
    monkeypatch.setattr(submap, "open_next_slot", open_counting)
    monkeypatch.setattr(submap, "keep_last_slot", keep_counting)
    want, want_state = _eager_submap(ranges, POOL_CFG)
    spawns = list(full_pool)
    assert sum(spawns) > 0 and len(spawns) > 4
    full_pool.clear()
    path, state = tss.run_scan(ranges, POOL_CFG, device="cpu")
    assert full_pool == spawns
    assert torch.equal(path, want)
    assert_tree_equal(state, want_state)
    assert state.atlas.n_submaps == 4 and state.atlas.active == 3
    assert all(type(v) is t for v, t in (
        (state.atlas.n_submaps, int), (state.atlas.active, int),
        (state.mini_updated, bool)))
    full_pool.clear()
    host, hstate = tss.run_host_loop(ranges, POOL_CFG, device="cpu")
    assert full_pool == spawns
    assert np.array_equal(host, want.numpy())
    assert_tree_equal(hstate, want_state)


def test_submap_advance_returns_the_slot_buffer_and_finish_reads_it(
        small_dataset):
    """``advance`` returns the step's device flag and () views of its slot
    buffer as the state's host fields; a step fed that state (another
    step's) loads them, and ``finish`` reads them back: the eager loop's
    values at every scan."""
    ranges, _ = small_dataset
    r = torch.as_tensor(ranges)
    angles = angles_tensor(POOL_CFG, "cpu")
    a, b = (tss.make_step_fn(POOL_CFG, "cpu") for _ in range(2))
    state = want = tss.init_state(r[0], POOL_CFG)
    for t in range(1, len(r)):
        want, _ = tss.slam_step(want, r[t], POOL_CFG, angles)
        state = (a if t % 3 else b).advance(state, r[t])
        if t > 1:
            assert isinstance(state.atlas.n_submaps, torch.Tensor)
            assert isinstance(state.mini_updated, torch.Tensor)
        got = (a if t % 3 else b).finish(state)
        assert (got.atlas.n_submaps, got.atlas.active, got.mini_updated) \
            == (want.atlas.n_submaps, want.atlas.active, want.mini_updated), t
    assert_tree_equal(graphs.clone_tree(got), want)


def test_submap_step_takes_a_state_it_did_not_return(small_dataset):
    """A step fed an eager state mid-run, then its own, then states another
    step returned, equals the eager loop; so does one fed a state whose
    submaps were re-anchored (the submap-graph feedback's kind)."""
    ranges, _ = small_dataset
    r = torch.as_tensor(ranges)
    want, _ = _eager_submap(ranges, POOL_CFG)
    _, state = _eager_submap(ranges[:20], POOL_CFG)
    a, b = (tss.make_step_fn(POOL_CFG, "cpu") for _ in range(2))
    for t in range(20, len(r)):
        step = a if (t // 7) % 2 == 0 else b
        state, pose = step(state, r[t])
        assert np.array_equal(pose, want[t].numpy()), t
        assert torch.equal(step.pose, want[t])
    # re-anchored submaps and a refresh forced: the same as the eager step
    moved = state.atlas.anchors + torch.tensor([0.01, -0.02, 0.003])
    fed = graphs.clone_tree(state)._replace(
        atlas=submap.apply_anchor_correction(state.atlas, moved),
        mini_updated=True)
    angles = angles_tensor(POOL_CFG, "cpu")
    eager_state = fed
    for t in range(1, 6):
        fed, pose = a(fed, r[t])
        eager_state, epose = tss.slam_step(eager_state, r[t], POOL_CFG,
                                           angles)
        assert np.array_equal(pose, epose.numpy()), t
    assert_tree_equal(fed, eager_state)
