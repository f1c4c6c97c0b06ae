"""The port's submap atlas (``core/submap``), submap SLAM
(``models/submap_slam``) and host paging (``utils/paging``) against the JAX
package's.

Every atlas function is held exactly equal to JAX's on the same inputs
(``nearest_submaps`` as a set plus its first index, the active submap:
the order among equal distances is the sort's). The submap pipeline's
trajectory on ``small_dataset`` equals JAX's ``run_scan`` within 1e-5
(measured: bit-identical, with the same submap count).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import to_numpy_tree
from lidar_slam_tpu.config import DEFAULT_CONFIG as JCFG
from lidar_slam_tpu.config import SubmapConfig as JSub
from lidar_slam_tpu.core import submap as jsm
from lidar_slam_tpu.models import submap_slam as jss
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG as TCFG
from lidar_slam_tpu_torch.config import SubmapConfig as TSub
from lidar_slam_tpu_torch.core import submap as tsm
from lidar_slam_tpu_torch.models import scan_matcher, state_io
from lidar_slam_tpu_torch.models import submap_slam as tss
from lidar_slam_tpu_torch.utils import paging
from lidar_slam_tpu_torch.utils.metrics import ate

PATH_TOL = 1e-5


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _atlases(seed=0, n_sub=4, n=40):
    """The same atlas built in both packages: ``n_sub`` submaps at random
    anchors, each holding ``n`` random world points (the last half
    unselected)."""
    rng = np.random.default_rng(seed)
    ja, ta = jsm.empty_atlas(8, 64), tsm.empty_atlas(8, 64, "cpu")
    for _ in range(n_sub):
        anchor = rng.uniform(-5, 5, 3).astype(np.float32)
        wx = rng.uniform(-8, 8, n).astype(np.float32)
        wy = rng.uniform(-8, 8, n).astype(np.float32)
        sel = np.arange(n) < n // 2
        ja = jsm.insert_world_points(jsm.start_submap(ja, jnp.asarray(anchor)),
                                     jnp.asarray(wx), jnp.asarray(wy),
                                     jnp.asarray(sel))
        ta = tsm.insert_world_points(
            tsm.start_submap(ta, torch.as_tensor(anchor)), torch.as_tensor(wx),
            torch.as_tensor(wy), torch.as_tensor(sel))
    return ja, ta


def _assert_atlas_equal(ta, ja, pts_tol=0.0):
    """Equal atlases; ``pts_tol`` for points stored by a jitted JAX
    pipeline, where XLA fuses ``world_to_anchor``'s products and sums into
    multiply-adds (one f32 ulp on a few points)."""
    np.testing.assert_allclose(_np(ta.pts), np.asarray(ja.pts), atol=pts_tol,
                               rtol=0)
    for f in ("sizes", "anchors"):
        assert np.array_equal(_np(getattr(ta, f)), np.asarray(getattr(ja, f))), f
    assert ta.n_submaps == int(ja.n_submaps) and ta.active == int(ja.active)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_atlas_equals_jax(seed):
    """empty_atlas, start_submap, insert_world_points (and world_to_anchor
    inside it), exactly."""
    ja, ta = _atlases(seed)
    _assert_atlas_equal(ta, ja)


def test_world_to_anchor_equals_jax():
    rng = np.random.default_rng(4)
    wx, wy = (rng.uniform(-20, 20, (6, 300)).astype(np.float32)
              for _ in range(2))
    anchors = rng.uniform(-4, 4, (6, 3)).astype(np.float32)
    jx, jy = jsm.world_to_anchor(jnp.asarray(wx), jnp.asarray(wy),
                                 jnp.asarray(anchors))
    tx, ty = tsm.world_to_anchor(torch.as_tensor(wx), torch.as_tensor(wy),
                                 torch.as_tensor(anchors))
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(ty.numpy(), np.asarray(jy))


def test_pool_full_drops_the_spawn():
    """A full pool writes nothing and keeps the last slot active (JAX's
    mode="drop")."""
    ja, ta = _atlases(3, n_sub=8)
    anchor = np.asarray([1.0, 2.0, 0.3], np.float32)
    ja2 = jsm.start_submap(ja, jnp.asarray(anchor))
    ta2 = tsm.start_submap(ta, torch.as_tensor(anchor))
    _assert_atlas_equal(ta2, ja2)
    assert ta2.n_submaps == 8 and ta2.active == 7


def test_insert_saturates_at_capacity():
    ja, ta = jsm.empty_atlas(2, 16), tsm.empty_atlas(2, 16, "cpu")
    anchor = np.asarray([0.5, -0.5, 0.2], np.float32)
    ja, ta = (jsm.start_submap(ja, jnp.asarray(anchor)),
              tsm.start_submap(ta, torch.as_tensor(anchor)))
    x = np.linspace(-3, 3, 40).astype(np.float32)
    sel = np.arange(40) % 3 != 0
    for _ in range(2):
        ja = jsm.insert_world_points(ja, jnp.asarray(x), jnp.asarray(-x),
                                     jnp.asarray(sel))
        ta = tsm.insert_world_points(ta, torch.as_tensor(x),
                                     torch.as_tensor(-x), torch.as_tensor(sel))
    _assert_atlas_equal(ta, ja)
    assert int(ta.sizes[0]) == 16


@pytest.mark.parametrize("seed", [0, 1])
def test_world_points_and_total_equal_jax(seed):
    ja, ta = _atlases(seed)
    for got, want in zip(tsm.submap_world_points(ta),
                         jsm.submap_world_points(ja)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(tsm.total_points(ta)) == int(jsm.total_points(ja))


def test_anchor_correction_equals_jax():
    ja, ta = _atlases(5)
    new = np.random.default_rng(5).uniform(-3, 3, (8, 3)).astype(np.float32)
    _assert_atlas_equal(tsm.apply_anchor_correction(ta, torch.as_tensor(new)),
                        jsm.apply_anchor_correction(ja, jnp.asarray(new)))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_nearest_submaps_equal_jax(k):
    ja, ta = _atlases(6, n_sub=5)
    pose = np.asarray([0.3, -1.2, 0.1], np.float32)
    want = np.asarray(jsm.nearest_submaps(ja, jnp.asarray(pose), k))
    got = tsm.nearest_submaps(ta, torch.as_tensor(pose), k).numpy()
    assert got[0] == want[0] == ta.active
    assert set(got.tolist()) == set(want.tolist())
    # with distinct distances the order is the distance order in both
    allocated = min(k, ta.n_submaps)
    assert np.array_equal(got[:allocated], want[:allocated])


def test_nearest_includes_active_and_sorts_by_distance():
    """tests/test_submap.py's case on the port."""
    a = tsm.empty_atlas(8, 16, "cpu")
    for x in (0.0, 5.0, 10.0, 15.0):
        a = tsm.start_submap(a, torch.tensor([x, 0.0, 0.0]))
    idx = tsm.nearest_submaps(a, torch.zeros(3), 3).numpy()
    assert idx[0] == 3
    assert set(idx[1:]) == {0, 1}


@pytest.mark.parametrize("k", [2, 4, 8])
def test_extract_local_equals_jax(k):
    ja, ta = _atlases(7, n_sub=5)
    pose = np.asarray([0.5, 0.5, 0.0], np.float32)
    rng = np.random.default_rng(7)
    swx, swy = (rng.uniform(-4, 4, 50).astype(np.float32) for _ in range(2))
    valid = np.arange(50) < 45
    want = jsm.extract_local_from_atlas(ja, jnp.asarray(pose),
                                        jnp.asarray(swx), jnp.asarray(swy),
                                        jnp.asarray(valid), 1.0, k)
    got = tsm.extract_local_from_atlas(ta, torch.as_tensor(pose),
                                       torch.as_tensor(swx),
                                       torch.as_tensor(swy),
                                       torch.as_tensor(valid), 1.0, k)
    # the same points, in the same order up to the ties' slot order
    wmask = np.asarray(want.mask)
    assert int(got.mask.sum()) == int(wmask.sum()) > 0
    order = lambda p: p[np.lexsort(p.T)]  # noqa: E731
    assert np.array_equal(order(got.xy.numpy()[got.mask.numpy()]),
                          order(np.asarray(want.xy)[wmask]))


# -- the pipeline --------------------------------------------------------------

_SUBMAP_CASES = {
    "tracks": dict(n_submaps=16, submap_capacity=4096, k_nearest=4,
                   spawn_dist=2.0),
    "spawns": dict(n_submaps=16, submap_capacity=512, k_nearest=4,
                   spawn_dist=0.5),
    "default": {},
}


@pytest.mark.parametrize("case", list(_SUBMAP_CASES))
def test_submap_run_matches_jax(small_dataset, case):
    """``run_scan`` on small_dataset: path within 1e-5 of JAX's (the two
    cases of tests/test_submap.py and the default atlas), the same submap
    count, and the atlas itself equal."""
    ranges, _ = small_dataset
    kw = _SUBMAP_CASES[case]
    jcfg = dataclasses.replace(JCFG, submaps=JSub(**kw))
    tcfg = dataclasses.replace(TCFG, submaps=TSub(**kw))
    jpath, jstate = jss.run_scan(ranges, jcfg)
    path, state = tss.run_scan(ranges, tcfg, device="cpu")
    np.testing.assert_allclose(path.numpy(), np.asarray(jpath), atol=PATH_TOL,
                               rtol=0)
    assert state.atlas.n_submaps == int(jstate.atlas.n_submaps)
    if case == "spawns":
        assert state.atlas.n_submaps > 1
    _assert_atlas_equal(state.atlas, jstate.atlas, pts_tol=PATH_TOL)


def test_submap_slam_tracks(small_dataset):
    """tests/test_submap.py's pins on the port."""
    ranges, gt = small_dataset
    cfg = dataclasses.replace(TCFG, submaps=TSub(**_SUBMAP_CASES["tracks"]))
    path, _ = tss.run_scan(ranges, cfg, device="cpu")
    err = ate(path.numpy(), gt)
    assert err < 0.1, err
    flat, _ = scan_matcher.run_scan(ranges, TCFG, device="cpu")
    assert err < max(2.5 * ate(flat.numpy(), gt), 0.08)


def test_host_loop_equals_run_scan(small_dataset):
    ranges, _ = small_dataset
    path, _ = tss.run_scan(ranges[:30], TCFG, device="cpu")
    host, _ = tss.run_host_loop(ranges[:30], TCFG, device="cpu")
    assert np.array_equal(host, path.numpy())


@pytest.mark.parametrize("t", [1, 9, 40])
def test_slam_step_from_shared_state(small_dataset, t):
    """One step from JAX's state after scan t-1 (via state_io): the same
    state as JAX's step, field for field."""
    ranges, _ = small_dataset
    step = jss.make_step_fn(JCFG)
    state = jss.init_state(jnp.asarray(ranges[0]), JCFG)
    for i in range(1, t):
        state, _ = step(state, jnp.asarray(ranges[i]))
    before = to_numpy_tree(state)
    want, wpose = step(state, jnp.asarray(ranges[t]))
    want = to_numpy_tree(want)
    got, pose = tss.slam_step(state_io.submap_state_from_numpy(before, "cpu"),
                              torch.as_tensor(ranges[t]), TCFG,
                              scan_matcher.angles_tensor(TCFG, "cpu"))
    assert np.array_equal(pose.numpy(), np.asarray(wpose))
    got = state_io.submap_state_to_numpy(got)
    for f in ("pose", "prev_pose", "keyframe_pose", "coarse_metric",
              "fine_metric", "scan_wx", "scan_wy"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.step == want.step and got.mini_updated == want.mini_updated
    for f in ("pts", "sizes", "anchors", "n_submaps", "active"):
        assert np.array_equal(getattr(got.atlas, f),
                              getattr(want.atlas, f)), f


# -- paging (tests/test_submap.py:101-133 on the port) --------------------------

def test_paging_keeps_pool_bounded(small_dataset):
    ranges, _ = small_dataset
    cfg = dataclasses.replace(TCFG, submaps=TSub(
        n_submaps=4, submap_capacity=512, k_nearest=2, spawn_dist=0.4,
        spawn_fill_frac=0.8))
    paged = paging.PagedAtlas(near_dist=1.0, keep_free=2)
    path, final = paging.run_host_loop_paged(ranges, cfg, paged,
                                             manage_every=4, device="cpu")
    assert final.atlas.n_submaps <= 4
    assert paged.pages_out > 0          # the pool actually overflowed
    assert len(paged.world_points(final.atlas)) > 0
    assert np.isfinite(path).all()


def test_paging_reloads_near_submaps():
    paged = paging.PagedAtlas(near_dist=2.0, keep_free=1)
    a = tsm.empty_atlas(2, 8, "cpu")
    a = tsm.start_submap(a, torch.tensor([0.0, 0.0, 0.0]))
    a = tsm.insert_world_points(a, torch.tensor([0.1]), torch.tensor([0.2]),
                                torch.tensor([True]))
    a = tsm.start_submap(a, torch.tensor([10.0, 0.0, 0.0]))
    # robot at x=10: submap 0 (far) must page out
    a = paged.manage(a, np.asarray([10.0, 0.0, 0.0]))
    assert paged.pages_out == 1 and a.n_submaps == 1
    # robot returns to the origin: submap 0 must page back in
    a = paged.manage(a, np.asarray([0.0, 0.0, 0.0]))
    assert paged.pages_in == 1
    gx, gy, mask = tsm.submap_world_points(a)
    pts = np.stack([gx.numpy()[mask.numpy()], gy.numpy()[mask.numpy()]], 1)
    assert any(np.allclose(p, [0.1, 0.2], atol=1e-5) for p in pts)


def test_paging_matches_jax(small_dataset):
    """The paged host loop against JAX's on the paging test's config: the same
    path, pages and archive."""
    from lidar_slam_tpu.utils import paging as jpaging

    ranges, _ = small_dataset
    kw = dict(n_submaps=4, submap_capacity=512, k_nearest=2, spawn_dist=0.4,
              spawn_fill_frac=0.8)
    jp = jpaging.PagedAtlas(near_dist=1.0, keep_free=2)
    tp = paging.PagedAtlas(near_dist=1.0, keep_free=2)
    jpath, jstate = jpaging.run_host_loop_paged(
        ranges, dataclasses.replace(JCFG, submaps=JSub(**kw)), jp,
        manage_every=4)
    tpath, tstate = paging.run_host_loop_paged(
        ranges, dataclasses.replace(TCFG, submaps=TSub(**kw)), tp,
        manage_every=4, device="cpu")
    np.testing.assert_allclose(tpath, jpath, atol=PATH_TOL, rtol=0)
    assert (tp.pages_out, tp.pages_in) == (jp.pages_out, jp.pages_in)
    assert len(tp.archive) == len(jp.archive)
    _assert_atlas_equal(tstate.atlas, jstate.atlas, pts_tol=PATH_TOL)


def test_atlas_state_io_round_trip(small_dataset):
    ranges, _ = small_dataset
    _, jstate = jss.run_scan(ranges[:30], JCFG)
    s = to_numpy_tree(jstate)
    back = state_io.submap_state_to_numpy(
        state_io.submap_state_from_numpy(s, "cpu"))
    for f in ("pts", "sizes", "anchors", "n_submaps", "active"):
        assert np.array_equal(getattr(back.atlas, f), getattr(s.atlas, f))
    assert back.step == s.step and back.mini_updated == s.mini_updated
    assert np.array_equal(back.fine_metric, s.fine_metric)
