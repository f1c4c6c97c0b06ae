"""The port's graph backend against ``lidar_slam_tpu.models.graph_slam`` and
``pf_graph_slam``: the synthesized tours, keyframe rasters, closure matching
(batched correlation volume), fine refinement, the cloud re-anchoring and a
whole reduced-depth ``GraphSlam.run``.

Keyframe rasters, closure matching and fine refinement are compared both
as the eager functions and through the captured backend (``_Backend``,
CUDA graphs on the card, the same bodies on static buffers here); the
whole run uses the captured backend.

Tolerances: rasters, volumes and the synthesizer's arrays are compared
exactly (every volume addend is on the 2^-10 lattice). Closure-match outputs
agree to 1e-5: the trilinear lookups sum their corners in another order
than JAX's one-hot contraction. The whole run gives the same keyframes,
the same closures in the same order and the same path; optimized keyframe
poses agree to 1e-3 (float32 Gauss-Newton, see test_torch_posegraph.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import to_numpy_tree  # noqa: F401  (caps torch threads)
from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu.core.gridmap import OccGrid as JGrid
from lidar_slam_tpu.io import simulate as jsim
from lidar_slam_tpu.models import graph_slam as jgs
from lidar_slam_tpu.models import pf_graph_slam as jpfg
from lidar_slam_tpu.ops import correlative as jc
from lidar_slam_tpu.utils.metrics import ate
from lidar_slam_tpu_torch.core import sensor as tsensor
from lidar_slam_tpu_torch.io import dataset as tdataset
from lidar_slam_tpu_torch.io import simulate as tsim
from lidar_slam_tpu_torch.models import graph_slam as tgs
from lidar_slam_tpu_torch.models import pf_graph_slam as tpfg
from lidar_slam_tpu_torch.models import posegraph as tpg
from lidar_slam_tpu_torch.models import state_io
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor
from lidar_slam_tpu_torch.ops import correlative as tc
from lidar_slam_tpu_torch.ops import edt as tedt

LC = tgs.LoopClosureConfig()


# -- synthesizer --------------------------------------------------------------
def _tour(sim, world):
    if world == "loop":
        return sim.generate_dataset(60, seed=1, waypoints=sim.LOOP_WAYPOINTS)
    if world == "corridor":
        return sim.generate_dataset(60, seed=2,
                                    waypoints=sim.CORRIDOR_WAYPOINTS,
                                    world=sim.corridor_world())
    return sim.generate_dataset(50, seed=0, speed=sim.BUILDING_SPEED,
                                waypoints=sim.BUILDING_WAYPOINTS,
                                world=sim.building_world())


@pytest.mark.parametrize("world", ["loop", "corridor", "building"])
def test_tours_byte_identical(world):
    """Worlds, waypoints and the first 50-60 scans of each tour."""
    assert np.array_equal(tsim.corridor_world().segments,
                          jsim.corridor_world().segments)
    assert np.array_equal(tsim.building_world().segments,
                          jsim.building_world().segments)
    for name in ("LOOP_WAYPOINTS", "CORRIDOR_WAYPOINTS",
                 "BUILDING_WAYPOINTS", "BUILDING_N_SCANS", "BUILDING_SPEED"):
        assert np.array_equal(getattr(tsim, name), getattr(jsim, name)), name
    tr, tg = _tour(tsim, world)
    jr, jg = _tour(jsim, world)
    assert tr.dtype == np.float32 and tr.shape[1] == 1079
    assert tr.tobytes() == jr.tobytes()
    assert tg.tobytes() == jg.tobytes()


def test_ensure_dataset_building_cache(tmp_path):
    """The building cache has the JAX package's file name and arrays."""
    r, g = tdataset.ensure_dataset(n_scans=6, data_dir=str(tmp_path),
                                   world="building")
    assert (tmp_path / "building_v2_6_s0.npz").exists()
    jr, jg = jsim.generate_dataset(6, seed=0, speed=jsim.BUILDING_SPEED,
                                   waypoints=jsim.BUILDING_WAYPOINTS,
                                   world=jsim.building_world())
    assert r.tobytes() == jr.tobytes() and g.tobytes() == jg.tobytes()
    r2, _ = tdataset.ensure_dataset(n_scans=6, data_dir=str(tmp_path),
                                    world="building")
    assert r2.tobytes() == jr.tobytes()
    with pytest.raises(ValueError, match="unknown world"):
        tdataset.ensure_dataset(n_scans=6, data_dir=str(tmp_path),
                                world="moon")


# -- keyframe rasters and closure matching ------------------------------------
@pytest.fixture(scope="module")
def loop_scans():
    """Gated scans and ground truth of the loop tour: the start and the
    revisit of the start about 280 scans later."""
    ranges, gt = tsim.generate_dataset(300, seed=1,
                                       waypoints=tsim.LOOP_WAYPOINTS)
    angles = angles_tensor(DEFAULT_CONFIG, "cpu")
    rows = [0, 9, 18, 27, 281, 290]
    scans = [tsensor.read_scan(torch.as_tensor(ranges[i]), angles,
                               DEFAULT_CONFIG.lidar) for i in rows]
    x, y, v = (torch.stack([getattr(s, f) for s in scans])
               for f in ("x", "y", "valid"))
    return x, y, v, gt[rows]


def _j(t):
    return jnp.asarray(t.numpy())


def _captured(x, y, v):
    """GraphSlam's captured backend over the keyframe scans (x, y, v)."""
    store = tgs._DeviceKeyframes(x, y, v, torch.zeros(
        (x.shape[0], LC.raster_size, LC.raster_size)))
    return tgs._Backend(store, LC, x.shape[0], torch.device("cpu"),
                        eager=False)


def test_raster_edt_batch_matches_jax(loop_scans):
    """Four keyframe rasters in one batch, plus a point beyond the raster's
    negative edge (JAX's drop-mode scatter wraps it once) and one beyond
    the positive edge (dropped)."""
    x, y, v, _ = loop_scans
    x, y, v = x[:4].clone(), y[:4].clone(), v[:4].clone()
    x[0, 0], y[0, 0] = -27.0, 1.0
    x[1, 0], y[1, 0] = 3.0, 26.5
    got = tgs._raster_edt_batch(x, y, v, LC.raster_size, LC.raster_pixel)
    want = np.asarray(jgs._raster_edt_batch(_j(x), _j(y), _j(v),
                                            LC.raster_size, LC.raster_pixel))
    assert got.shape == (4, 256, 256)
    assert np.array_equal(got.numpy(), want)
    backend = _captured(x, y, v)
    backend.raster([0, 1, 2, 3])
    assert np.array_equal(backend.store.metric.numpy(), want)
    assert torch.equal(tgs._raster_edt(x[2], y[2], v[2], LC.raster_size,
                                       LC.raster_pixel), got[2])


def _guess(gt, i, k, noise=(0.06, -0.04, 0.01)):
    """The reference-convention pose of scan k in scan i's frame, off by
    ``noise``."""
    return (tgs._np_between_ref(gt[i], gt[k])
            + np.asarray(noise, np.float32)).astype(np.float32)


def test_match_keyframes_matches_jax(loop_scans):
    """Two real loop-tour keyframes (the start and its revisit): the score
    and count volumes equal JAX's exactly; rel pose, average distance,
    inlier fraction and ambiguity within 1e-5."""
    x, y, v, gt = loop_scans
    metric = tgs._raster_edt(x[0], y[0], v[0], LC.raster_size,
                             LC.raster_pixel)
    guess = _guess(gt, 0, 4)
    grid = tgs._closure_grid(LC.raster_size, LC.raster_pixel, "cpu")
    tvol = tc.build_score_volume(metric, grid, x[4], y[4], v[4],
                                 torch.as_tensor(guess), n_theta=LC.n_theta,
                                 theta_step=LC.theta_step,
                                 half=LC.window_half)
    halfm = LC.raster_size // 2 * LC.raster_pixel
    jgrid = JGrid(occ=jnp.zeros((256, 256), bool), n_rows=jnp.int32(256),
                  n_cols=jnp.int32(256),
                  origin=jnp.asarray([-halfm, -halfm], jnp.float32),
                  pixel=LC.raster_pixel)
    jvol = jc.build_score_volume(_j(metric), jgrid, _j(x[4]), _j(y[4]),
                                 _j(v[4]), jnp.asarray(guess),
                                 n_theta=LC.n_theta, theta_step=LC.theta_step,
                                 half=LC.window_half, impl="jnp")
    assert tvol.scores.shape == (21, 29, 29)
    assert np.array_equal(tvol.scores.numpy(), np.asarray(jvol.scores))
    assert np.array_equal(tvol.counts.numpy(), np.asarray(jvol.counts))

    got = tgs._match_keyframes(metric, x[4], y[4], v[4],
                               torch.as_tensor(guess), LC)
    want = jgs._match_keyframes(
        _j(metric), _j(x[4]), _j(y[4]), _j(v[4]), jnp.asarray(guess),
        lc_size=LC.raster_size, lc_pixel=LC.raster_pixel, n_theta=LC.n_theta,
        theta_step=LC.theta_step, half=LC.window_half, iters=LC.refine_iters,
        ambiguity_margin=LC.ambiguity_margin)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
    backend = _captured(x, y, v)
    backend.raster([0])
    packed = backend.match([0], [4], guess[None])[0].numpy()
    np.testing.assert_allclose(packed, np.concatenate(
        [np.asarray(want[0]), np.stack([np.asarray(w) for w in want[1:]])]),
        atol=1e-5, rtol=0)
    # a true revisit: nearly every beam lands inside the window
    assert float(got[2]) > 0.9


def test_match_keyframes_batch_equals_single(loop_scans):
    """Three candidates in one batch give each single match's numbers."""
    x, y, v, gt = loop_scans
    metric = tgs._raster_edt_batch(x[:3], y[:3], v[:3], LC.raster_size,
                                   LC.raster_pixel)
    cur = [1, 2, 3]
    guesses = np.stack([_guess(gt, i, k) for i, k in zip(range(3), cur)])
    packed = tgs._match_keyframes_batch(
        metric, x[cur], y[cur], v[cur], torch.as_tensor(guesses), LC)
    for b, k in enumerate(cur):
        one = tgs._match_keyframes(metric[b], x[k], y[k], v[k],
                                   torch.as_tensor(guesses[b]), LC)
        assert torch.equal(torch.cat([one[0], torch.stack(one[1:])]),
                           packed[b])


def test_batched_plain_volume_equals_unbatched_loop():
    """The plain K2 with a batch axis equals a loop of unbatched calls
    exactly, counts included."""
    rng = np.random.default_rng(7)
    b, t, half, s, n = 3, 5, 6, 96, 400
    metric = tedt.edt_clamped(torch.as_tensor(rng.random((b, s, s)) < 0.02))
    cx0 = torch.as_tensor(rng.integers(-10, s + 10, (b, t, n)),
                          dtype=torch.int32)
    cy0 = torch.as_tensor(rng.integers(-10, s + 10, (b, t, n)),
                          dtype=torch.int32)
    valid = torch.as_tensor(rng.random((b, n)) < 0.9)
    got = tc.score_volume_plain(metric, cx0, cy0, valid, s - 3, s - 7, half)
    cnt = tc.count_volume(cx0, cy0, valid, s - 3, s - 7, half)
    assert got.shape == (b, t, 13, 13)
    for i in range(b):
        assert torch.equal(got[i], tc.score_volume_plain(
            metric[i], cx0[i], cy0[i], valid[i], s - 3, s - 7, half))
        assert torch.equal(cnt[i], tc.count_volume(
            cx0[i], cy0[i], valid[i], s - 3, s - 7, half))
    # the theta-bin slicing that bounds the plain version's memory changes
    # nothing: one bin at a time gives the same volume
    old = tc._PLAIN_SLICE
    try:
        tc._PLAIN_SLICE = 1
        assert torch.equal(tc.score_volume_plain(metric, cx0, cy0, valid,
                                                 s - 3, s - 7, half), got)
    finally:
        tc._PLAIN_SLICE = old


def test_batched_lookup_equals_unbatched():
    rng = np.random.default_rng(8)
    b, t, w = 3, 7, 13
    scores = torch.as_tensor(rng.uniform(0, 900, (b, t, w, w)),
                             dtype=torch.float32)
    counts = torch.as_tensor(rng.integers(100, 900, (b, t, w, w)),
                             dtype=torch.float32)
    base = torch.as_tensor(rng.normal(0, 1, (b, 3)), dtype=torch.float32)
    vol = tc.ScoreVolume(scores, counts, base, 0.004363, 10.0, 6)
    poses = base[:, None, :] + torch.as_tensor(
        rng.uniform(-1, 1, (b, 40, 3)) * [0.8, 0.8, 0.02],
        dtype=torch.float32)
    got = tc.lookup_avg_distance(vol, poses)
    inside = tc._window_inside(vol, poses)
    for i in range(b):
        one = tc.ScoreVolume(scores[i], counts[i], base[i], 0.004363, 10.0,
                             6)
        assert torch.equal(got[i], tc.lookup_avg_distance(one, poses[i]))
        assert torch.equal(inside[i], tc._window_inside(one, poses[i]))


def test_refine_rel_batch_matches_jax(loop_scans):
    x, y, v, gt = loop_scans
    old, cur = [0, 1], [4, 5]
    guesses = np.stack([tgs._np_between_ref(gt[i], gt[k]) + np.float32(0.03)
                        for i, k in zip(old, cur)]).astype(np.float32)
    kw = dict(pixel=LC.fine_pixel, size=LC.fine_size, iters=LC.fine_iters,
              step_t0=LC.fine_step_t0, step_r0=LC.fine_step_r0,
              max_range=LC.fine_range)
    got = tgs._refine_rel_batch(x[old], y[old], v[old], x[cur], y[cur],
                                v[cur], torch.as_tensor(guesses), **kw)
    want = jgs._refine_rel_batch(_j(x[old]), _j(y[old]), _j(v[old]),
                                 _j(x[cur]), _j(y[cur]), _j(v[cur]),
                                 jnp.asarray(guesses), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    captured = _captured(x, y, v).refine(old, cur, guesses)
    np.testing.assert_allclose(captured.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_host_helpers_match_jax():
    rng = np.random.default_rng(9)
    poses = rng.normal(0, 1, (64, 3)).astype(np.float32)
    a = np.asarray([0.3, -0.2, 0.4], np.float32)
    c = np.asarray([-0.5, 0.8, 1.1], np.float32)
    assert np.array_equal(tpfg._np_correct_cloud(poses, a, c),
                          jpfg._np_correct_cloud(poses, a, c))
    for name in ("_np_between_std", "_np_between_ref", "_np_compose_ref"):
        assert np.array_equal(getattr(tgs, name)(a, c),
                              getattr(jgs, name)(a, c)), name
    x, y = rng.normal(0, 5, (2, 4, 30)).astype(np.float32)
    for p, q in zip(tgs._np_transform_ref(x, y, poses[:4]),
                    jgs._np_transform_ref(x, y, poses[:4])):
        assert np.array_equal(p, q)


# -- whole runs ---------------------------------------------------------------
@pytest.fixture(scope="module")
def graph_runs():
    """Both packages' GraphSlam on 200 loop-tour scans, chunks of 32, with
    min_gap 3 so closures fire (and feed back) early. JAX pads its last
    chunk by repeating the last scan; the port runs the real scans only,
    which leaves the path and the graph unchanged."""
    ranges, gt = jsim.generate_dataset(200, seed=1,
                                       waypoints=jsim.LOOP_WAYPOINTS)
    jg = jgs.GraphSlam(DEFAULT_CONFIG, jgs.LoopClosureConfig(min_gap=3))
    jpath, jopt = jg.run(ranges, chunk_size=32)
    tg = tgs.GraphSlam(DEFAULT_CONFIG, tgs.LoopClosureConfig(min_gap=3),
                       device="cpu")
    tpath, topt = tg.run(ranges, chunk_size=32)
    return (tg, tpath, topt), (jg, jpath, jopt), gt


def test_graph_run_matches_jax(graph_runs):
    (tg, tpath, topt), (jg, jpath, jopt), gt = graph_runs
    assert tg.kf.count == jg.kf.count > 15
    assert len(tg.closures) >= 3
    assert tg.closures == jg.closures
    assert tg.weak_closures == jg.weak_closures
    assert tg.closure_rejects == jg.closure_rejects
    assert tg._epoch == jg._epoch >= 1          # a feedback happened
    assert tg.path_epoch == jg.path_epoch
    # the path is the fidelity frontend's, bit for bit, through feedback
    assert np.array_equal(tpath, jpath)
    np.testing.assert_allclose(topt, jopt, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tg.smoothed_path(), jg.smoothed_path(),
                               atol=1e-3, rtol=0)
    assert ate(tpath, gt) < 0.05


def test_graph_view_and_state_io(graph_runs):
    """The materialized graph equals JAX's (same edges, poses to 1e-3) and
    both packages' keyframe stores hold the same scans."""
    (tg, _, _), (jg, _, _), _ = graph_runs
    got = state_io.posegraph_to_numpy(tg.graph)
    want = to_numpy_tree(jg.graph)
    for f in ("node_active", "n_nodes", "edge_i", "edge_j", "edge_active",
              "n_edges"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    np.testing.assert_allclose(got.edge_z, want.edge_z, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.edge_w, want.edge_w, rtol=1e-6)
    np.testing.assert_allclose(got.poses, want.poses, atol=1e-3, rtol=0)
    err = float(tpg.graph_error(tg.graph))
    assert err / max(int(got.n_edges), 1) < 1.0
    kf = state_io.keyframes_from_numpy(jg.kf, "cpu")
    k = int(kf.count)
    assert torch.equal(kf.x[:k], tg._kf_dx[:k])
    assert torch.equal(kf.valid[:k], tg._kf_dv[:k])
    back = state_io.keyframes_to_numpy(kf)
    assert np.array_equal(back.y, jg.kf.y) and back.count == jg.kf.count


def test_pf_graph_injected_draws_match_jax():
    """PF-graph, 64 loop-tour scans, 32 particles, JAX's own draws injected
    through ``_PFFrontend``: the same keyframes and a path within 1e-3.
    (Longer PF runs fork at resampling or refinement near-ties, see
    test_torch_fastslam.py.)"""
    p = 32
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=p))
    ranges, gt = jsim.generate_dataset(64, seed=0,
                                       waypoints=jsim.LOOP_WAYPOINTS)
    key = jax.random.PRNGKey(0)
    draws = []
    for _ in range(len(ranges) - 1):
        key, k_noise, k_res = jax.random.split(key, 3)
        draws.append((np.array(jax.random.normal(k_noise, (p, 3))),
                      np.array(jax.random.uniform(k_res, (), minval=0.0,
                                                  maxval=1.0 / p))))
    lc = jgs.LoopClosureConfig(weak_closures=True, min_gap=3)
    jpath, _, jg = jpfg.run_pf_graph(ranges, cfg, lc=lc, chunk_size=32)
    tlc = tgs.LoopClosureConfig(weak_closures=True, min_gap=3)
    tpath, _, tg = tpfg.run_pf_graph(ranges, cfg, lc=tlc, chunk_size=32,
                                     device="cpu", draws=draws)
    assert tg.kf.count == jg.kf.count
    assert np.abs(tpath - jpath).max() <= 1e-3
    assert ate(tpath, gt) < 0.15


# -- slow tier: port-only replicas of test_graph_slam / test_pf_graph_slam ----
@pytest.mark.slow
@pytest.mark.parametrize("feedback", [True, False])
def test_graph_slam_closes_loops_on_loop_trajectory(feedback):
    ranges, gt = tsim.generate_dataset(n_scans=300, seed=1,
                                       waypoints=tsim.LOOP_WAYPOINTS)
    gs = tgs.GraphSlam(DEFAULT_CONFIG, device="cpu")
    path, _ = gs.run(ranges, feedback=feedback)
    assert int(gs.kf.count) >= 10
    assert len(gs.closures) >= 1
    for i, k in gs.closures:
        assert k - i >= gs.lc.min_gap
    err = float(tpg.graph_error(gs.graph))
    assert err / max(int(gs.graph.n_edges), 1) < 1.0
    assert ate(path, gt) < 0.1


@pytest.mark.slow
def test_pf_graph_closes_loop_and_tracks():
    ranges, gt = tsim.generate_dataset(n_scans=300, seed=0,
                                       waypoints=tsim.LOOP_WAYPOINTS)
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=256))
    # the port's generator at seed 2 (the JAX test's seed 0 names a
    # jax.random stream; on the CPU, port seeds 1-3 close 4-7 loops here,
    # seed 4 only weak ones)
    path, _, gs = tpfg.run_pf_graph(ranges, cfg, seed=2, device="cpu")
    assert len(gs.closures) >= 1
    err = float(ate(path, gt))
    assert err < 0.15
    assert float(ate(gs.smoothed_path(path), gt)) < err + 0.03
