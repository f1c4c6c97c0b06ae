"""Conversion between the JAX package's states and the port's.

The JAX package's ``SlamState``, ``ParticleState``, ``PoseGraph``,
``KeyframeStore``, ``EkfSlamState``, ``HybridState``, ``SubmapAtlas``,
``SubmapSlamState`` and ``BAProblem`` are pytrees of arrays;
passed through ``numpy.asarray`` leaf by leaf they become plain numpy
trees with the same field names. These functions turn such a tree into the
port's state on a given device, and a port state back into numpy arrays
(with the JAX package's field names and dtypes), so both packages can be
started from the same mid-run state. This system has no weights; the state
is what is carried across.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_tpu_torch.core.gridmap import OccGrid, PointMap
from lidar_slam_tpu_torch.core.submap import SubmapAtlas
from lidar_slam_tpu_torch.device import resolve_device
from lidar_slam_tpu_torch.models.ba import BAProblem
from lidar_slam_tpu_torch.models.ekf_hybrid import HybridState
from lidar_slam_tpu_torch.models.ekf_slam import EkfSlamState
from lidar_slam_tpu_torch.models.fastslam import ParticleState
from lidar_slam_tpu_torch.models.graph_slam import KeyframeStore
from lidar_slam_tpu_torch.models.posegraph import PoseGraph
from lidar_slam_tpu_torch.models.scan_matcher import SlamState
from lidar_slam_tpu_torch.models.submap_slam import SubmapSlamState


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), device=device,
                           dtype=dtype)


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def pointmap_from_numpy(pm, device) -> PointMap:
    return PointMap(xy=_t(pm.xy, device, torch.float32),
                    size=_t(np.int32(pm.size), device),
                    keyframe_pose=_t(pm.keyframe_pose, device, torch.float32))


def grid_from_numpy(g, device) -> OccGrid:
    return OccGrid(occ=_t(g.occ, device, torch.bool),
                   n_rows=_t(np.int32(g.n_rows), device),
                   n_cols=_t(np.int32(g.n_cols), device),
                   origin=_t(g.origin, device, torch.float32),
                   pixel=float(np.float32(g.pixel)))


def pointmap_to_numpy(pm: PointMap) -> PointMap:
    return PointMap(xy=_n(pm.xy), size=np.int32(_n(pm.size)),
                    keyframe_pose=_n(pm.keyframe_pose))


def grid_to_numpy(g: OccGrid) -> OccGrid:
    return OccGrid(occ=_n(g.occ), n_rows=np.int32(_n(g.n_rows)),
                   n_cols=np.int32(_n(g.n_cols)), origin=_n(g.origin),
                   pixel=np.float32(g.pixel))


def slam_state_from_numpy(s, device) -> SlamState:
    """A JAX ``SlamState`` with numpy leaves -> the port's ``SlamState``."""
    return SlamState(
        pose=_t(s.pose, device, torch.float32),
        prev_pose=_t(s.prev_pose, device, torch.float32),
        step=int(s.step), mini_updated=bool(s.mini_updated),
        pmap=pointmap_from_numpy(s.pmap, device),
        coarse=grid_from_numpy(s.coarse, device),
        fine=grid_from_numpy(s.fine, device),
        coarse_metric=_t(s.coarse_metric, device, torch.float32),
        fine_metric=_t(s.fine_metric, device, torch.float32),
        scan_wx=_t(s.scan_wx, device, torch.float32),
        scan_wy=_t(s.scan_wy, device, torch.float32))


def slam_state_to_numpy(s: SlamState) -> SlamState:
    """The port's ``SlamState`` -> the same fields as numpy arrays, with the
    JAX package's dtypes (``step`` int32, ``mini_updated`` bool)."""
    return SlamState(
        pose=_n(s.pose), prev_pose=_n(s.prev_pose), step=np.int32(s.step),
        mini_updated=np.bool_(s.mini_updated),
        pmap=pointmap_to_numpy(s.pmap), coarse=grid_to_numpy(s.coarse),
        fine=grid_to_numpy(s.fine), coarse_metric=_n(s.coarse_metric),
        fine_metric=_n(s.fine_metric), scan_wx=_n(s.scan_wx),
        scan_wy=_n(s.scan_wy))


def _generator(device, seed: int) -> torch.Generator:
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    return rng


def particle_state_from_numpy(s, device, seed: int = 0) -> ParticleState:
    """A JAX ``ParticleState`` with numpy leaves -> the port's
    ``ParticleState``. JAX's PRNG key has no torch counterpart: the port's
    generator is seeded with ``seed``."""
    rng = _generator(device, seed)
    return ParticleState(
        poses=_t(s.poses, device, torch.float32),
        prev_poses=_t(s.prev_poses, device, torch.float32),
        logw=_t(s.logw, device, torch.float32),
        step=int(s.step), mini_updated=bool(s.mini_updated),
        pmap=pointmap_from_numpy(s.pmap, device),
        fine=grid_from_numpy(s.fine, device),
        fine_metric=_t(s.fine_metric, device, torch.float32),
        rng=rng, clamp_frac=_t(np.float32(s.clamp_frac), device))


def particle_state_to_numpy(s: ParticleState) -> ParticleState:
    """The port's ``ParticleState`` -> numpy arrays; ``rng`` becomes None
    (a torch generator has no JAX key)."""
    return ParticleState(
        poses=_n(s.poses), prev_poses=_n(s.prev_poses), logw=_n(s.logw),
        step=np.int32(s.step), mini_updated=np.bool_(s.mini_updated),
        pmap=pointmap_to_numpy(s.pmap), fine=grid_to_numpy(s.fine),
        fine_metric=_n(s.fine_metric), rng=None,
        clamp_frac=np.float32(_n(s.clamp_frac)))


def posegraph_from_numpy(g, device) -> PoseGraph:
    """A JAX ``PoseGraph`` with numpy leaves -> the port's ``PoseGraph``."""
    return PoseGraph(
        poses=_t(g.poses, device, torch.float32),
        node_active=_t(g.node_active, device, torch.bool),
        n_nodes=_t(np.int32(g.n_nodes), device),
        edge_i=_t(np.asarray(g.edge_i, np.int32), device),
        edge_j=_t(np.asarray(g.edge_j, np.int32), device),
        edge_z=_t(g.edge_z, device, torch.float32),
        edge_w=_t(g.edge_w, device, torch.float32),
        edge_active=_t(g.edge_active, device, torch.bool),
        n_edges=_t(np.int32(g.n_edges), device))


def posegraph_to_numpy(g: PoseGraph) -> PoseGraph:
    """The port's ``PoseGraph`` -> numpy arrays with the JAX dtypes."""
    return PoseGraph(
        poses=_n(g.poses), node_active=_n(g.node_active),
        n_nodes=np.int32(_n(g.n_nodes)), edge_i=_n(g.edge_i),
        edge_j=_n(g.edge_j), edge_z=_n(g.edge_z), edge_w=_n(g.edge_w),
        edge_active=_n(g.edge_active), n_edges=np.int32(_n(g.n_edges)))


def keyframes_from_numpy(kf, device) -> KeyframeStore:
    """A ``KeyframeStore`` (either package's, numpy leaves) -> its scans as
    tensors on ``device``: x, y (K, N) f32, valid (K, N) bool; count an
    int."""
    return KeyframeStore(x=_t(kf.x, device, torch.float32),
                         y=_t(kf.y, device, torch.float32),
                         valid=_t(kf.valid, device, torch.bool),
                         count=int(kf.count))


def keyframes_to_numpy(kf: KeyframeStore) -> KeyframeStore:
    """Tensor keyframe scans -> the numpy ``KeyframeStore`` both packages'
    ``GraphSlam.kf`` return."""
    return KeyframeStore(x=_n(kf.x), y=_n(kf.y), valid=_n(kf.valid),
                         count=np.int32(kf.count))


def ekf_state_from_numpy(s, device, seed: int = 0) -> EkfSlamState:
    """A JAX ``EkfSlamState`` with numpy leaves -> the port's; the JAX
    PRNG key is replaced by a generator seeded with ``seed``."""
    return EkfSlamState(
        poses=_t(s.poses, device, torch.float32),
        prev_poses=_t(s.prev_poses, device, torch.float32),
        logw=_t(s.logw, device, torch.float32),
        lm_mean=_t(s.lm_mean, device, torch.float32),
        lm_cov=_t(s.lm_cov, device, torch.float32),
        lm_seen=_t(s.lm_seen, device, torch.bool),
        rng=_generator(device, seed))


def ekf_state_to_numpy(s: EkfSlamState) -> EkfSlamState:
    """The port's ``EkfSlamState`` -> numpy arrays; ``rng`` becomes None."""
    return EkfSlamState(
        poses=_n(s.poses), prev_poses=_n(s.prev_poses), logw=_n(s.logw),
        lm_mean=_n(s.lm_mean), lm_cov=_n(s.lm_cov), lm_seen=_n(s.lm_seen),
        rng=None)


def hybrid_state_from_numpy(s, device, seed: int = 0) -> HybridState:
    """A JAX ``HybridState`` with numpy leaves -> the port's."""
    return HybridState(
        ekf=ekf_state_from_numpy(s.ekf, device, seed),
        pmap=pointmap_from_numpy(s.pmap, device),
        fine=grid_from_numpy(s.fine, device),
        fine_metric=_t(s.fine_metric, device, torch.float32),
        step=int(s.step), mini_updated=bool(s.mini_updated))


def hybrid_state_to_numpy(s: HybridState) -> HybridState:
    """The port's ``HybridState`` -> numpy arrays with the JAX dtypes."""
    return HybridState(
        ekf=ekf_state_to_numpy(s.ekf), pmap=pointmap_to_numpy(s.pmap),
        fine=grid_to_numpy(s.fine), fine_metric=_n(s.fine_metric),
        step=np.int32(s.step), mini_updated=np.bool_(s.mini_updated))


def atlas_from_numpy(a, device) -> SubmapAtlas:
    """A ``SubmapAtlas`` with numpy leaves -> the port's (slot counts as
    host ints)."""
    return SubmapAtlas(pts=_t(a.pts, device, torch.float32),
                       sizes=_t(np.asarray(a.sizes, np.int32), device),
                       anchors=_t(a.anchors, device, torch.float32),
                       n_submaps=int(a.n_submaps), active=int(a.active))


def atlas_to_numpy(a: SubmapAtlas) -> SubmapAtlas:
    """The port's ``SubmapAtlas`` -> numpy arrays with the JAX dtypes."""
    return SubmapAtlas(pts=_n(a.pts), sizes=_n(a.sizes),
                       anchors=_n(a.anchors), n_submaps=np.int32(a.n_submaps),
                       active=np.int32(a.active))


def submap_state_from_numpy(s, device) -> SubmapSlamState:
    """A JAX ``SubmapSlamState`` with numpy leaves -> the port's."""
    return SubmapSlamState(
        pose=_t(s.pose, device, torch.float32),
        prev_pose=_t(s.prev_pose, device, torch.float32),
        step=int(s.step), mini_updated=bool(s.mini_updated),
        keyframe_pose=_t(s.keyframe_pose, device, torch.float32),
        atlas=atlas_from_numpy(s.atlas, device),
        coarse=grid_from_numpy(s.coarse, device),
        fine=grid_from_numpy(s.fine, device),
        coarse_metric=_t(s.coarse_metric, device, torch.float32),
        fine_metric=_t(s.fine_metric, device, torch.float32),
        scan_wx=_t(s.scan_wx, device, torch.float32),
        scan_wy=_t(s.scan_wy, device, torch.float32))


_BA_DTYPES = dict(poses=np.float32, landmarks=np.float32, pose_active=bool,
                  lm_active=bool, odo_i=np.int32, odo_j=np.int32,
                  odo_z=np.float32, odo_w=np.float32, odo_active=bool,
                  obs_i=np.int32, obs_j=np.int32, obs_z=np.float32,
                  obs_w=np.float32, obs_active=bool)


def ba_problem_from_numpy(p, device: str | torch.device = "cuda"
                          ) -> BAProblem:
    """A ``BAProblem`` with numpy leaves (either package's) -> the port's
    on ``device`` (``"cuda"`` by default; raises without a card)."""
    device = resolve_device(device)
    return BAProblem(**{f: _t(np.asarray(getattr(p, f), dt), device)
                        for f, dt in _BA_DTYPES.items()})


def ba_problem_to_numpy(p: BAProblem) -> BAProblem:
    """The port's ``BAProblem`` -> numpy arrays with the JAX dtypes."""
    return BAProblem(**{f: _n(getattr(p, f)) for f in BAProblem._fields})


def submap_state_to_numpy(s: SubmapSlamState) -> SubmapSlamState:
    """The port's ``SubmapSlamState`` -> numpy arrays with the JAX
    dtypes."""
    return SubmapSlamState(
        pose=_n(s.pose), prev_pose=_n(s.prev_pose), step=np.int32(s.step),
        mini_updated=np.bool_(s.mini_updated),
        keyframe_pose=_n(s.keyframe_pose), atlas=atlas_to_numpy(s.atlas),
        coarse=grid_to_numpy(s.coarse), fine=grid_to_numpy(s.fine),
        coarse_metric=_n(s.coarse_metric), fine_metric=_n(s.fine_metric),
        scan_wx=_n(s.scan_wx), scan_wy=_n(s.scan_wy))
