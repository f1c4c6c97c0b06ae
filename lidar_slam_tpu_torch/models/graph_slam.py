"""Graph SLAM: scan-matcher frontend + loop closure + pose graph
(counterpart of ``lidar_slam_tpu.models.graph_slam``).

The frontend tracks pose scan to map; every keyframe becomes a graph node
with an odometry edge; revisited places are found by matching the new
keyframes' scans against old keyframes' EDT rasters over a wide search
window (the correlation volume, kernel K2 on CUDA, one launch for a batch of
candidates); accepted closures are refined on a fine raster, trigger a
damped Gauss-Newton solve, and the frontend is rebuilt from the optimized
keyframe poses.

The run goes chunk by chunk (JAX's jitted ``run_chunk`` and
``gather_rows``). Inside a chunk the frontend is the per-scan loop of
``scan_matcher``'s captured step (or the particle filter's, or the submap
frontend's: ``make_step_fn``, CUDA graphs over static buffers). Each scan's
pose, keyframe flag and frontend quality and its gated scan (from the
step's own buffers) are copied on the device into the chunk's buffers; the
fidelity and PF steps read nothing on the host (their keyframe flag is a
device bool), the submap step keeps its one sync a scan (its spawn
decisions are host ints). Once a chunk the poses, flags and qualities come
to the host in one copy, and the keyframe rows' scans are gathered on the
device and come in one more. The keyframe scans and their 256^2 EDT
rasters (kernel K1, batched) stay on the device, so closure matching moves
no field across the bus. The backend's batched
helpers (keyframe rasters, closure matching, fine refinement) and the
pose-graph optimize run as CUDA graphs too (``_Backend``, the counterpart
of JAX's jitted helpers). ``eager=True`` runs the frontend's ``slam_step``
a scan and the backend op by op instead (the reference the tests and
chip_smoke hold the captured run to). Bookkeeping — keyframes, edges, the
closure gates, the jump gate — is host numpy, as in the JAX package, with
the same numbers.

Differences from the JAX package that change no result: JAX pads every
batch (keyframe rasters, closure candidates, fine refinements) to a fixed
width and the last chunk to the chunk size, only to keep one compiled shape;
here batches are cut without padding and the last chunk runs its real scans
only (so only the final frontend state can differ, never the path).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.core import sensor
from lidar_slam_tpu_torch.core.gridmap import OccGrid, PointMap, roundf_like
from lidar_slam_tpu_torch.device import constant, resolve_device
from lidar_slam_tpu_torch.models import posegraph, scan_matcher
from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor
from lidar_slam_tpu_torch.ops import correlative, scan_odometry
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.utils import graphs
from lidar_slam_tpu_torch.utils.profiling import StageTimer


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """The JAX package's defaults, field for field (their rationale is
    documented there)."""

    raster_size: int = 256        # keyframe raster: 256 cells @ 0.2 m = +-25.6 m
    raster_pixel: float = 0.2
    n_theta: int = 21             # +-10 bins
    theta_step: float = 0.008727  # 0.5 deg
    window_half: int = 14         # +-2.8 m search window
    accept_avg_dist: float = 1.1  # px — acceptance threshold
    min_inlier_frac: float = 0.75  # fraction of beams in bounds
    # peak-sharpness gate: at most this many cells of the volume within
    # ``ambiguity_margin`` px of the best (a corridor valley is a line)
    max_ambiguous_cells: float = 8.0
    ambiguity_margin: float = 0.25
    # odometry-consistency gate: |correction| <= abs + rel * path length
    consistency_abs: float = 0.15
    consistency_rel: float = 0.03
    min_gap: int = 10             # keyframe index gap before closing
    max_dist: float = 4.0         # m — candidate search radius
    max_candidates: int = 2       # old keyframes tried per new keyframe
    # weak second tier (~1/10 weight), for frontends whose map can
    # mis-register; on for PFGraphSlam
    weak_closures: bool = False
    weak_avg_dist: float = 3.5
    refine_iters: int = 8
    # fine-raster refinement of accepted closures
    fine_refine: bool = True
    fine_pixel: float = 0.05
    fine_size: int = 448          # 448 * 0.05 = 22.4 m extent
    fine_range: float = 10.0      # points gated to the raster's safe reach
    fine_step_t0: float = 0.08
    fine_step_r0: float = 0.008
    fine_iters: int = 6


def _closure_batch(device) -> int:
    """Batch width of closure matching and keyframe rasters: 8 on the card,
    2 on the CPU (a CPU batch runs the plain volume, whose temporaries grow
    with the width). The width changes no result."""
    return 8 if torch.device(device).type == "cuda" else 2


class KeyframeStore(NamedTuple):
    x: np.ndarray      # (K, N) gated sensor-frame points
    y: np.ndarray
    valid: np.ndarray  # (K, N)
    count: np.int32


def _raster_batch(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                  size: int, pixel: float) -> torch.Tensor:
    """Rasterize keyframe scans (B, N) in their own frames: (B, size, size)
    bool, centred on the sensor.

    The cell is ``roundf(x / pixel)`` with a true division, as in the JAX
    package (a CUDA division by a Python scalar would multiply by the
    reciprocal). JAX's ``.at[].set(mode="drop")`` wraps a negative index
    once and drops anything else out of range; the same is done here."""
    half = size // 2
    col = roundf_like(correlative.true_div(x, pixel)).to(torch.int32) + half
    row = roundf_like(correlative.true_div(y, pixel)).to(torch.int32) + half
    col = torch.where(col < 0, col + size, col)
    row = torch.where(row < 0, row + size, row)
    keep = valid & (row >= 0) & (row < size) & (col >= 0) & (col < size)
    b = x.shape[0]
    gi = torch.arange(b, device=x.device)[:, None]
    flat = torch.where(keep, (gi * size + row) * size + col, b * size * size)
    occ = torch.zeros(b * size * size + 1, dtype=torch.bool, device=x.device)
    occ.index_fill_(0, flat.reshape(-1).to(torch.int64), True)
    return occ[:-1].view(b, size, size)


def _raster_edt_batch(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                      size: int, pixel: float) -> torch.Tensor:
    """Keyframe rasters (``_raster_batch``) and their clamped EDT, K1 on
    CUDA: (B, size, size) f32."""
    return edt_ops.edt(_raster_batch(x, y, valid, size, pixel), 10)


def _raster_edt(x, y, valid, size: int, pixel: float) -> torch.Tensor:
    """One keyframe scan (N,) -> its (size, size) EDT raster."""
    return _raster_edt_batch(x[None], y[None], valid[None], size, pixel)[0]


def _closure_grid(size: int, pixel: float, device) -> OccGrid:
    """The geometry of a keyframe raster (centred on the keyframe). Only
    the extent and origin are read; ``occ`` is unused by scoring."""
    halfm = size // 2 * pixel
    n = constant(size, torch.device(device), torch.int32)
    return OccGrid(occ=None, n_rows=n, n_cols=n,
                   origin=constant((-halfm, -halfm), torch.device(device)),
                   pixel=pixel)


_OFFS27 = np.stack(np.meshgrid(*([np.asarray([-1.0, 0.0, 1.0], np.float32)] * 3),
                               indexing="ij"), axis=-1).reshape(27, 3)


def _match_keyframes_batch(old_metric: torch.Tensor, cur_x: torch.Tensor,
                           cur_y: torch.Tensor, cur_valid: torch.Tensor,
                           guesses: torch.Tensor, lc: LoopClosureConfig
                           ) -> torch.Tensor:
    """Match B current scans against B old keyframes' EDT rasters (B, S, S)
    from guesses (B, 3) in one batched volume (one K2 launch on CUDA).

    Returns packed (B, 6): rel pose (3), average distance, inlier fraction
    and ambiguity (the share of volume cells within ``ambiguity_margin`` px
    of the best cell). Poses use the reference convention in the old
    keyframe's frame."""
    dev = old_metric.device
    b = old_metric.shape[0]
    grid = _closure_grid(lc.raster_size, lc.raster_pixel, dev)
    vol = correlative.build_score_volume(
        old_metric, grid, cur_x, cur_y, cur_valid, guesses,
        n_theta=lc.n_theta, theta_step=lc.theta_step, half=lc.window_half)

    steps0 = np.asarray([lc.raster_pixel, lc.raster_pixel, lc.theta_step],
                        np.float32)
    offs = constant(tuple(map(tuple, _OFFS27.tolist())), dev)
    rows = torch.arange(b, device=dev)
    est, avg_d = guesses, None
    for i in range(lc.refine_iters):
        # coarse to fine: halve the step every other iteration
        step = constant(tuple((steps0 * np.float32(2.0 ** -(i // 2))).tolist()),
                        dev)
        cands = est[:, None, :] + offs * step
        d = correlative.lookup_avg_distance(vol, cands)        # (B, 27)
        k = torch.argmin(d, dim=1)
        est, avg_d = cands[rows, k], d[rows, k]
    # inlier fraction: beams of the current scan landing inside the window
    n_valid = torch.clamp(cur_valid.sum(dim=1), min=1).to(torch.float32)
    counts = correlative.lookup_avg_distance(
        vol._replace(scores=vol.counts, counts=torch.ones_like(vol.counts)),
        est[:, None, :])[:, 0]
    # peak sharpness over the whole (T, W, W) volume; cells with too few
    # in-bounds beams never count as near-optimal
    cell_avg = torch.where(vol.counts > 0.5 * n_valid[:, None, None, None],
                           vol.scores / torch.clamp(vol.counts, min=1.0),
                           torch.inf)
    best = cell_avg.amin(dim=(1, 2, 3))
    near = cell_avg <= (best + float(np.float32(lc.ambiguity_margin))
                        )[:, None, None, None]
    ambiguity = near.to(torch.float32).mean(dim=(1, 2, 3))
    return torch.cat([est, avg_d[:, None], (counts / n_valid)[:, None],
                      ambiguity[:, None]], dim=1)


def _match_keyframes(metric, cur_x, cur_y, cur_valid, guess_rel,
                     lc: LoopClosureConfig):
    """One closure match: (rel (3,), avg_dist, inlier_frac, ambiguity)."""
    out = _match_keyframes_batch(metric[None], cur_x[None], cur_y[None],
                                 cur_valid[None], guess_rel[None], lc)[0]
    return out[:3], out[3], out[4], out[5]


def _refine_rel_batch(x0, y0, v0, x1, y1, v1, guesses, *, pixel: float,
                      size: int, iters: int, step_t0: float, step_r0: float,
                      max_range: float) -> torch.Tensor:
    """Fine-raster re-match of accepted closures: each old keyframe scan is
    rastered in its own frame at ``pixel`` and clamp-EDT'd (K1 on CUDA),
    and the new keyframe's scan descends from the coarse estimate with
    halving steps. Points beyond ``max_range`` are gated."""
    return scan_odometry.match_batch(
        x0, y0, v0, x1, y1, v1, guesses, max_range=max_range, pixel=pixel,
        size=size, iters=iters, step_t0=step_t0, step_r0=step_r0)


class _DeviceKeyframes(NamedTuple):
    """The device keyframe store: gated scans (K, N) and EDT rasters
    (K, S, S), indexed by keyframe."""
    x: torch.Tensor
    y: torch.Tensor
    valid: torch.Tensor
    metric: torch.Tensor


class _Rows(NamedTuple):
    """A batch of the backend: store rows and guesses in, result out. A
    raster batch has its keyframes in ``old`` and no result."""
    old: torch.Tensor                    # (B,) int64: old keyframes
    cur: torch.Tensor | None = None      # (B,) int64: current keyframes
    guesses: torch.Tensor | None = None  # (B, 3) f32
    out: torch.Tensor | None = None      # (B, 6) match, (B, 3) refine


class _Backend:
    """The closure backend's batched helpers over the device keyframe
    store, JAX's jitted ``_raster_edt_batch``, ``_match_keyframes_batch``
    and ``_refine_rel_batch``, and ``posegraph.optimize``.

    Each helper runs as a CUDA graph (``utils/graphs``) keyed by the
    helper and its batch width B, so K1 and K2 launch at exactly the shapes
    of the eager run; ``optimize`` replays its ``OptimizeFn``. The host
    writes a batch's rows and guesses into the width's static buffers
    (``graphs.upload``, no sync) and replays; a result is cloned out of its
    buffer, so a pass's batches come to the host in one copy. The store is
    read and written through int64 index buffers (``index_select``,
    ``index_copy_``), never by a host list. ``eager``: the same bodies on
    the same buffers, op by op, and ``posegraph.optimize``."""

    def __init__(self, store: _DeviceKeyframes, lc: LoopClosureConfig,
                 max_keyframes: int, device: torch.device, eager: bool):
        self.store, self.lc, self.device, self.eager = (store, lc, device,
                                                        eager)
        self.graphs = graphs.Graphs(device)
        self._rows: dict = {}   # (helper, B) -> _Rows
        self.optimizer = None if eager else posegraph.OptimizeFn(
            max_keyframes, 4 * max_keyframes, device)

    def raster(self, rows: list[int]) -> None:
        """EDT rasters of the keyframes ``rows`` into the store."""
        self._run("raster", 0, np.asarray(rows, np.int64))

    def match(self, olds: list[int], curs: list[int], guesses: np.ndarray
              ) -> torch.Tensor:
        """``_match_keyframes_batch`` of keyframes ``curs`` against the
        rasters of ``olds`` from ``guesses``: (B, 6) on the device."""
        return self._run("match", 6, np.asarray(olds, np.int64),
                         np.asarray(curs, np.int64),
                         np.asarray(guesses, np.float32))

    def refine(self, olds: list[int], curs: list[int], guesses: np.ndarray
               ) -> torch.Tensor:
        """``_refine_rel_batch`` of keyframe pairs: (B, 3) on the device."""
        return self._run("refine", 3, np.asarray(olds, np.int64),
                         np.asarray(curs, np.int64),
                         np.asarray(guesses, np.float32))

    def _run(self, helper: str, width: int, *host: np.ndarray):
        """``helper``'s body on one batch, given as host arrays (old rows
        [, current rows, guesses]); returns its (B, ``width``) result."""
        b = len(host[0])
        key = (helper, b)
        rows = self._rows.get(key)
        if rows is None:
            rows = self._rows[key] = _Rows(
                *(torch.zeros_like(torch.as_tensor(a), device=self.device)
                  for a in host),
                out=torch.zeros((b, width), device=self.device))
        for buf, a in zip(rows, host):
            graphs.upload(buf, a)
        body = getattr(self, "_" + helper)
        if self.eager:
            body((self.store, rows))
        else:
            self.graphs.run(key, body, (self.store, rows))
        return rows.out.clone()

    def _raster(self, bufs) -> None:
        s, r = bufs
        lc = self.lc
        s.metric.index_copy_(0, r.old, _raster_edt_batch(
            s.x.index_select(0, r.old), s.y.index_select(0, r.old),
            s.valid.index_select(0, r.old), lc.raster_size, lc.raster_pixel))

    def _match(self, bufs) -> None:
        s, r = bufs
        r.out.copy_(_match_keyframes_batch(
            s.metric.index_select(0, r.old), s.x.index_select(0, r.cur),
            s.y.index_select(0, r.cur), s.valid.index_select(0, r.cur),
            r.guesses, self.lc))

    def _refine(self, bufs) -> None:
        s, r = bufs
        lc = self.lc

        def rows(ix):
            return (s.x.index_select(0, ix), s.y.index_select(0, ix),
                    s.valid.index_select(0, ix))

        r.out.copy_(_refine_rel_batch(
            *rows(r.old), *rows(r.cur), r.guesses, pixel=lc.fine_pixel,
            size=lc.fine_size, iters=lc.fine_iters, step_t0=lc.fine_step_t0,
            step_r0=lc.fine_step_r0, max_range=lc.fine_range))

    def pose_graph(self, arrays) -> posegraph.PoseGraph:
        """The pose graph given as host arrays (``PoseGraph``'s fields in
        order) on the device: the optimizer's static graph, refilled
        (``eager``: new tensors)."""
        if self.eager:
            return posegraph.PoseGraph(*(torch.as_tensor(a, device=self.device)
                                         for a in arrays))
        return self.optimizer.load(arrays)

    def optimize(self, arrays, iters: int) -> torch.Tensor:
        """The optimized poses (K, 3) of that graph, on the device."""
        g = self.pose_graph(arrays)
        if self.eager:
            return posegraph.optimize(g, iters=iters).poses
        return self.optimizer(g, iters=iters).poses


# -- host-side SE(2) helpers (numpy, as in the JAX package) ------------------
def _np_ref_to_std(p):
    return np.asarray([p[0], p[1], -p[2]], np.float32)


def _np_between_std(p1, p2):
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    ct, st = np.cos(p1[2]), np.sin(p1[2])
    dth = p2[2] - p1[2]
    dth = dth - 2.0 * np.pi * np.floor((dth + np.pi) / (2.0 * np.pi))
    return np.asarray([ct * dx + st * dy, -st * dx + ct * dy, dth], np.float32)


def _np_between_ref(a, b):
    dx, dy = b[0] - a[0], b[1] - a[1]
    ct, st = np.cos(a[2]), np.sin(a[2])
    return np.asarray([ct * dx - st * dy, st * dx + ct * dy, b[2] - a[2]],
                      np.float32)


def _np_compose_ref(a, z):
    ct, st = np.cos(a[2]), np.sin(a[2])
    return np.asarray([a[0] + ct * z[0] + st * z[1],
                       a[1] - st * z[0] + ct * z[1],
                       a[2] + z[2]], np.float32)


def _np_transform_ref(x, y, poses):
    """Vectorized reference-convention transform in host numpy: x, y
    (..., N), poses (..., 3). The feedback map rebuild runs on the host."""
    t = poses[..., 2:3]
    ct, st = np.cos(t, dtype=np.float32), np.sin(t, dtype=np.float32)
    wx = ct * x + st * y + poses[..., 0:1]
    wy = -st * x + ct * y + poses[..., 1:2]
    return wx.astype(np.float32), wy.astype(np.float32)


def _rebuilt_map_points(kf_x, kf_y, kf_valid, poses, cap: int):
    """The keyframe scans at ``poses`` as a (cap, 2) point buffer
    (subsampled to capacity) and its size."""
    wx, wy = _np_transform_ref(kf_x, kf_y, poses)
    allpts = np.stack([wx[kf_valid], wy[kf_valid]], axis=1)
    if len(allpts) > cap:
        allpts = allpts[:: int(np.ceil(len(allpts) / cap))][:cap]
    xy = np.zeros((cap, 2), np.float32)
    xy[: len(allpts)] = allpts
    return xy, len(allpts)


class _EagerStep:
    """A frontend's eager ``slam_step`` with a step object's surface:
    ``advance(state, ranges) -> state``, ``pose`` on the device, no
    ``scan`` (the loop gates the scans itself) and no ``graphs``."""

    scan = None
    graphs = None

    def __init__(self, frontend, cfg: SlamConfig, angles: torch.Tensor):
        self.frontend, self.cfg, self.angles = frontend, cfg, angles
        self.pose: torch.Tensor | None = None

    def advance(self, state, ranges: torch.Tensor):
        state, self.pose = self.frontend.slam_step(state, ranges, self.cfg,
                                                   self.angles)
        return state


class GraphSlam:
    """Host-side orchestrator. See the module docstring.

    ``device`` holds the frontend state, the keyframe scans and rasters and
    every batched match; on CUDA the two kernels run there and nothing on
    the path falls back to a plain version. ``eager``: the frontend runs its
    eager ``slam_step`` a scan instead of its captured step, and the
    backend its helpers op by op."""

    frontend = scan_matcher  # provides init_state, slam_step, make_step_fn

    def __init__(self, cfg: SlamConfig, lc: LoopClosureConfig = LoopClosureConfig(),
                 max_keyframes: int = 512,
                 device: str | torch.device = "cuda", eager: bool = False):
        self.cfg = cfg
        self.lc = lc
        self.max_keyframes = max_keyframes
        self.device = resolve_device(device)
        self.eager = eager
        self.angles = angles_tensor(cfg, self.device)
        n = cfg.lidar.n_beams
        self._kf_x = np.zeros((max_keyframes, n), np.float32)
        self._kf_y = np.zeros((max_keyframes, n), np.float32)
        self._kf_valid = np.zeros((max_keyframes, n), bool)
        # device copies of the keyframe scans and their EDT rasters, each
        # raster computed once when its keyframe is added
        dev = self.device
        self._kf_dx = torch.zeros((max_keyframes, n), dtype=torch.float32,
                                  device=dev)
        self._kf_dy = torch.zeros_like(self._kf_dx)
        self._kf_dv = torch.zeros((max_keyframes, n), dtype=torch.bool,
                                  device=dev)
        self._kf_metric = torch.empty(
            (max_keyframes, lc.raster_size, lc.raster_size),
            dtype=torch.float32, device=dev)
        self._backend = _Backend(
            _DeviceKeyframes(self._kf_dx, self._kf_dy, self._kf_dv,
                             self._kf_metric),
            lc, max_keyframes, dev, eager)
        self._kf_count = 0
        self._saturation_warned = False
        self._edge_warned = False
        # edge list (host): (i, j, z_std (3,), w (3,))
        self._edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self.kf_poses: list[np.ndarray] = []   # ref convention, optimized
        self.kf_raw: list[np.ndarray] = []     # pose at add time (frozen)
        self.kf_epoch: list[int] = []          # frame epoch at add time
        self.path_epoch: list[int] = [0]
        self._epoch = 0
        self.closures: list[tuple[int, int]] = []
        self.weak_closures: list[tuple[int, int]] = []
        self.kf_times: list[int] = []          # scan index of each keyframe
        self._edge_speeds: list[float] = []    # jump-gate baseline
        self.jump_edges: list[tuple[int, int, int]] = []
        self._jump_kf: set[int] = set()
        self.closure_rejects: dict = {}        # gate -> count
        self.attempt_log: list = []            # (k, i_old, avg_d, inlier,
        #                                        ambig_cells, off_xy)
        self._kf_cum: list[float] = []         # path length at each keyframe
        self.timer = StageTimer(self.device)

    # -- views ------------------------------------------------------------------
    @property
    def kf(self) -> KeyframeStore:
        return KeyframeStore(x=self._kf_x, y=self._kf_y, valid=self._kf_valid,
                             count=np.int32(self._kf_count))

    @property
    def graph(self) -> posegraph.PoseGraph:
        """The pose graph from the host mirrors, fixed shapes, on the
        device: the captured optimizer's static graph, refilled at each
        read and each optimize (``eager``: new tensors)."""
        return self._backend.pose_graph(self._graph_arrays())

    def _graph_arrays(self) -> tuple[np.ndarray, ...]:
        """The pose graph's fields, in ``PoseGraph``'s order, as host
        arrays of fixed shapes."""
        kmax, emax = self.max_keyframes, self.max_keyframes * 4
        k = self._kf_count
        poses = np.zeros((kmax, 3), np.float32)
        if k:
            poses[:k] = np.stack([_np_ref_to_std(p) for p in self.kf_poses])
        e = min(len(self._edges), emax)
        if e < len(self._edges) and not self._edge_warned:
            warnings.warn(
                f"pose-graph edge store saturated at {e}; "
                f"{len(self._edges) - e} edges dropped from optimization",
                stacklevel=2)
            self._edge_warned = True
        ei = np.zeros(emax, np.int32)
        ej = np.zeros(emax, np.int32)
        ez = np.zeros((emax, 3), np.float32)
        ew = np.ones((emax, 3), np.float32)
        for idx, (i, j, z, w) in enumerate(self._edges[:e]):
            ei[idx], ej[idx], ez[idx], ew[idx] = i, j, z, w
        return (poses, np.arange(kmax) < k, np.int32(k), ei, ej, ez, ew,
                np.arange(emax) < e, np.int32(e))

    # -- keyframe bookkeeping (host) ---------------------------------------------
    def _add_keyframe(self, scan_x, scan_y, scan_valid, pose_ref: np.ndarray,
                      scan_t: int = 0, quality: float = 0.0):
        k = self._kf_count
        if k >= self.max_keyframes:
            if not self._saturation_warned:
                warnings.warn(
                    f"GraphSlam keyframe store saturated at "
                    f"{self.max_keyframes}; further keyframes (and their "
                    f"closure opportunities) are dropped — raise "
                    f"max_keyframes for longer tours", stacklevel=2)
                self._saturation_warned = True
            return k - 1
        self._kf_x[k] = np.asarray(scan_x)
        self._kf_y[k] = np.asarray(scan_y)
        self._kf_valid[k] = np.asarray(scan_valid)
        self._kf_count = k + 1
        pose_ref = np.asarray(pose_ref, np.float32)
        if k > 0:
            z = _np_between_std(_np_ref_to_std(self.kf_poses[-1]),
                                _np_ref_to_std(pose_ref))
            w = np.asarray([100.0, 100.0, 400.0], np.float32)
            # frontend health: a particle cloud escaping its scoring window
            # softens this keyframe's odometry edge
            if quality > 0.0:
                w = w / np.float32(1.0 + (quality / 0.05) ** 2)
            # kinematic jump gate: a keyframe step far beyond the running
            # speed is a re-registration, not motion — clamp and soften it
            step = float(np.hypot(z[0], z[1]))
            gap = max(scan_t - (self.kf_times[-1] if self.kf_times else 0), 1)
            speed = step / gap
            hist = self._edge_speeds[-100:]
            if (len(hist) >= 10 and step > 0.5
                    and speed > 4.0 * float(np.median(hist))):
                bound = 4.0 * float(np.median(hist)) * gap
                z = z.copy()
                z[:2] *= bound / step
                w = np.asarray([4.0, 4.0, 16.0], np.float32)
                self.jump_edges.append((k - 1, k, scan_t))
                self._jump_kf.add(k)
            else:
                self._edge_speeds.append(speed)
            self._edges.append((k - 1, k, z, w))
            self._kf_cum.append(self._kf_cum[-1] + float(
                np.hypot(*(pose_ref[:2] - self.kf_poses[-1][:2]))))
        else:
            self._kf_cum.append(0.0)
        self.kf_poses.append(pose_ref)
        self.kf_raw.append(pose_ref.copy())
        self.kf_epoch.append(self._epoch)
        self.kf_times.append(scan_t)
        return k

    def _store_kf_scans(self, k0: int, scans: torch.Tensor) -> None:
        """Device copies of keyframes k0.. from stacked (m, 3, N) scans."""
        m = scans.shape[0]
        self._kf_dx[k0:k0 + m] = scans[:, 0]
        self._kf_dy[k0:k0 + m] = scans[:, 1]
        self._kf_dv[k0:k0 + m] = scans[:, 2] > 0.5

    def _compute_kf_metrics(self, kf_indices: list[int]) -> None:
        """EDT rasters of newly added keyframes, a batch at a time."""
        if not kf_indices:
            return
        bucket = _closure_batch(self.device)
        for s in range(0, len(kf_indices), bucket):
            self._backend.raster(kf_indices[s: s + bucket])

    def _closure_candidates(self, k: int) -> list[int]:
        """Old keyframes worth matching against keyframe ``k``; keyframes
        just after a detected jump search wider (3x radius, twice the
        candidates)."""
        lc = self.lc
        if k < lc.min_gap:
            return []
        wide = any(0 <= k - j <= 6 for j in self._jump_kf)
        max_dist = lc.max_dist * (3.0 if wide else 1.0)
        n_cand = (2 * lc.max_candidates) if wide else lc.max_candidates
        cur = self.kf_poses[k]
        old = [(i, float(np.hypot(*(p[:2] - cur[:2]))))
               for i, p in enumerate(self.kf_poses[: k - lc.min_gap + 1])]
        old = [c for c in old if c[1] < max_dist]
        old.sort(key=lambda c: c[1])
        return [i for i, _ in old[: n_cand]]

    def _try_loop_closures_batch(self, new_kf: list[int]) -> bool:
        """Match every (new keyframe, old candidate) pair of the chunk in
        batches, gate on the host, refine the accepted ones and add their
        edges. Returns True if a strong closure was accepted."""
        lc = self.lc
        rows: list[tuple[int, int]] = []   # (k, i_old)
        for k in new_kf:
            for i_old in self._closure_candidates(k):
                rows.append((k, i_old))
        if not rows:
            return False
        b = len(rows)
        bucket = _closure_batch(self.device)
        ks = [k for k, _ in rows]
        olds = [i for _, i in rows]
        guesses = np.stack([_np_between_ref(self.kf_poses[i], self.kf_poses[k])
                            for k, i in rows])
        packs = [self._backend.match(olds[s: s + bucket], ks[s: s + bucket],
                                     guesses[s: s + bucket])
                 for s in range(0, b, bucket)]
        packed = torch.cat(packs).cpu().numpy()              # one copy
        rels, avg_ds, inliers, ambigs = (packed[:, :3], packed[:, 3],
                                         packed[:, 4], packed[:, 5])

        n_cells = lc.n_theta * (2 * lc.window_half + 1) ** 2

        def reject(reason: str) -> None:
            self.closure_rejects[reason] = (
                self.closure_rejects.get(reason, 0) + 1)

        accepted: list[tuple[int, int, int]] = []   # (row, i_old, k)
        weak: list[tuple[int, int, int]] = []
        weak_per_kf: dict = {}
        for row in range(b):
            i, k = olds[row], ks[row]
            off = rels[row] - guesses[row]
            self.attempt_log.append(
                (k, i, float(avg_ds[row]), float(inliers[row]),
                 float(ambigs[row] * n_cells),
                 float(np.hypot(off[0], off[1]))))
            # rail: a match at the window's edge means the true alignment
            # lies outside it
            max_xy = 0.85 * lc.window_half * lc.raster_pixel
            max_th = 0.85 * (lc.n_theta // 2) * lc.theta_step
            if (abs(off[0]) > max_xy or abs(off[1]) > max_xy
                    or abs(off[2]) > max_th):
                reject("rail")
                continue
            # odometry consistency: the correction must fit the drift budget
            budget = (lc.consistency_abs + lc.consistency_rel
                      * abs(self._kf_cum[k] - self._kf_cum[i]))
            if (abs(off[0]) > budget or abs(off[1]) > budget
                    or abs(off[2]) > budget):
                reject("consistency")
                continue
            strict = (avg_ds[row] <= lc.accept_avg_dist
                      and inliers[row] >= lc.min_inlier_frac
                      and ambigs[row] * n_cells <= lc.max_ambiguous_cells)
            if strict:
                accepted.append((row, i, k))
                continue
            # weak tier: sharp, full-overlap matches failing only the
            # absolute score, at most 2 per keyframe
            if (lc.weak_closures and inliers[row] >= 0.9
                    and avg_ds[row] <= lc.weak_avg_dist
                    and ambigs[row] * n_cells <= lc.max_ambiguous_cells
                    and weak_per_kf.get(k, 0) < 2):
                weak.append((row, i, k))
                weak_per_kf[k] = weak_per_kf.get(k, 0) + 1
            else:
                reject("avg_dist" if avg_ds[row] > lc.accept_avg_dist
                       else ("inlier_frac"
                             if inliers[row] < lc.min_inlier_frac
                             else "ambiguity"))
        if not accepted and not weak:
            return False

        # fine-raster refinement of the accepted pairs, strong and weak
        z_rel = {row: rels[row] for row, _, _ in accepted + weak}
        if lc.fine_refine:
            pairs = accepted + weak
            fines = []
            for s in range(0, len(pairs), bucket):
                sl = pairs[s: s + bucket]
                fines.append(self._backend.refine(
                    [i for _, i, _ in sl], [k for _, _, k in sl],
                    np.stack([rels[row] for row, _, _ in sl])))
            fine = torch.cat(fines).cpu().numpy()             # one copy
            for j, (row, _, _) in enumerate(pairs):
                z_rel[row] = fine[j]

        for row, i, k in accepted:
            rel = z_rel[row]
            z_std = np.asarray([rel[0], rel[1], -rel[2]], np.float32)
            self._edges.append((i, k, z_std,
                                np.asarray([50.0, 50.0, 200.0], np.float32)))
            self.closures.append((i, k))
        for row, i, k in weak:
            rel = z_rel[row]
            z_std = np.asarray([rel[0], rel[1], -rel[2]], np.float32)
            self._edges.append((i, k, z_std,
                                np.asarray([5.0, 5.0, 20.0], np.float32)))
            self.weak_closures.append((i, k))
        return bool(accepted)

    def _optimize(self) -> float:
        """One damped-GN solve over the graph; NaN-revert. Returns the
        largest keyframe position move (m), -1.0 on revert."""
        opt = self._backend.optimize(self._graph_arrays(), iters=10)
        opt = opt[: self._kf_count].cpu().numpy()
        if not np.isfinite(opt).all():
            return -1.0
        old = np.stack([_np_ref_to_std(p) for p in self.kf_poses])
        delta = float(np.max(np.hypot(opt[:, 0] - old[:, 0],
                                      opt[:, 1] - old[:, 1]))) if len(old) else 0.0
        self.kf_poses = [_np_ref_to_std(p) for p in opt]  # std->ref (involution)
        return delta

    # -- frontend feedback ----------------------------------------------------
    def _post_chunk(self, state) -> None:
        """Hook for frontend-specific per-chunk bookkeeping (no-op here)."""

    def _rebuild_frontend(self, state):
        """Fold the optimized keyframe poses back into the frontend: the
        pose is re-anchored on the last keyframe (pose' = opt_k (+)
        (old_k (-) pose)) and the point map rebuilt from the keyframe scans
        at their optimized poses, in host numpy after one copy of the three
        frontend poses; the next step re-rasters the corrected map."""
        fb = torch.stack([state.pmap.keyframe_pose, state.pose,
                          state.prev_pose]).cpu().numpy()     # one copy
        old_last, cur_pose, prev_pose = fb[0], fb[1], fb[2]
        new_last = self.kf_poses[-1]

        def correct(pose):
            return _np_compose_ref(new_last, _np_between_ref(old_last, pose))

        k = self._kf_count
        xy, size = _rebuilt_map_points(
            self._kf_x[:k], self._kf_y[:k], self._kf_valid[:k],
            np.stack(self.kf_poses), state.pmap.xy.shape[0])
        dev = self.device
        new_pose = torch.as_tensor(correct(cur_pose), device=dev)
        return state._replace(
            pose=new_pose,
            prev_pose=torch.as_tensor(correct(prev_pose), device=dev),
            mini_updated=True,
            pmap=PointMap(xy=torch.as_tensor(xy, device=dev),
                          size=torch.as_tensor(np.int32(size), device=dev),
                          keyframe_pose=new_pose.clone()))

    # -- main loop ------------------------------------------------------------
    def run(self, ranges_all: np.ndarray, optimize_every_closure: bool = True,
            chunk_size: int | None = None, feedback: bool = True):
        """Returns (path (T, 3) ref convention, optimized keyframe poses),
        both numpy.

        Default chunk: 256 scans on CUDA, 64 on the CPU (the JAX package's
        defaults, with the card in the TPU's place). The chunk sets the
        closure cadence: closures are matched and the graph optimized at
        most once per chunk."""
        dev = self.device
        if chunk_size is None:
            chunk_size = 256 if dev.type == "cuda" else 64
        cfg = self.cfg
        ranges = torch.as_tensor(np.asarray(ranges_all, np.float32),
                                 device=dev)
        state = self.frontend.init_state(ranges[0], cfg)
        scan0 = sensor.read_scan(ranges[0], self.angles, cfg.lidar)
        s0 = torch.stack([scan0.x, scan0.y, scan0.valid.to(torch.float32)])
        h0 = s0.cpu().numpy()
        self._add_keyframe(h0[0], h0[1], h0[2] > 0.5, np.zeros(3, np.float32))
        self._store_kf_scans(0, s0[None])
        self._compute_kf_metrics([0])  # keyframe 0 is a closure target too
        path = [np.zeros(3, np.float32)]
        step = (_EagerStep(self.frontend, cfg, self.angles) if self.eager
                else self.frontend.make_step_fn(cfg, dev))
        runners = [] if step.graphs is None else [step.graphs]
        # the chunk's rows: pose, keyframe flag and frontend quality (the
        # PF's share of particles escaping the scoring window; 0 for the
        # others), and every scan's gated scan (x, y, valid)
        rows = torch.zeros((chunk_size, 5), dtype=torch.float32, device=dev)
        scans = torch.zeros((chunk_size, 3, self.angles.shape[0]),
                            dtype=torch.float32, device=dev)

        t = 1
        n_scans = ranges.shape[0]
        last_flag = True
        while t < n_scans:
            n_real = min(chunk_size, n_scans - t)
            with self.timer.stage("frontend_chunk"):
                for i in range(n_real):
                    r = ranges[t + i]
                    state = step.advance(state, r)
                    rows[i, :3] = step.pose
                    flag = state.mini_updated
                    if isinstance(flag, torch.Tensor):
                        # the device bool of a step that read nothing on
                        # the host
                        rows[i, 3] = flag
                    else:
                        # a host bool: fill_, as an assignment would copy
                        # it from pageable memory and synchronize
                        rows[i, 3].fill_(flag)
                    q = getattr(state, "clamp_frac", None)
                    if q is not None:
                        rows[i, 4] = q
                    sc = step.scan
                    if sc is None:
                        sc = sensor.read_scan(r, self.angles, cfg.lidar)
                    scans[i, 0] = sc.x
                    scans[i, 1] = sc.y
                    scans[i, 2] = sc.valid
            with self.timer.stage("kf_fetch"):
                # one copy of the rows (and the step's arm counts), then
                # the keyframe rows' scans gathered on the device, one more
                (packed_h,) = graphs.fetch(rows[:n_real], runners=runners)
                kf_rows = np.flatnonzero(packed_h[:, 3] > 0.5).tolist()
                kf_dev, blk = scans[:0], {}
                if kf_rows:
                    idx = torch.as_tensor(kf_rows, dtype=torch.int64)
                    if dev.type == "cuda":
                        idx = idx.pin_memory().to(dev, non_blocking=True)
                    kf_dev = scans.index_select(0, idx)
                    blk = dict(zip(kf_rows, kf_dev.cpu().numpy()))
            last_flag = bool(packed_h[-1, 3] > 0.5)
            poses_c, quals_c = packed_h[:, :3], packed_h[:, 4]
            # pass 1: register this chunk's keyframes (closure candidates
            # only look backward, so batching the adds is neutral)
            new_kf = []
            count0 = self._kf_count
            for i in range(n_real):
                path.append(poses_c[i])
                self.path_epoch.append(self._epoch)
                if i not in blk:
                    continue
                k = self._add_keyframe(blk[i][0], blk[i][1],
                                       blk[i][2] > 0.5, poses_c[i],
                                       scan_t=t + i,
                                       quality=float(quals_c[i]))
                new_kf.append(k)
            if self._kf_count > count0:  # saturation drops the tail
                self._store_kf_scans(count0,
                                     kf_dev[: self._kf_count - count0])
            with self.timer.stage("kf_raster_edt"):
                self._compute_kf_metrics(sorted(set(new_kf)))
            self._post_chunk(state)
            # pass 2: the chunk's closure candidates, then at most one
            # optimize for the chunk
            with self.timer.stage("closure_match"):
                any_closed = self._try_loop_closures_batch(new_kf)
            if any_closed and optimize_every_closure:
                with self.timer.stage("optimize"):
                    delta = self._optimize()
                if delta > 0.01 and feedback:
                    # feedback only when the solve moved a keyframe > 1 cm
                    with self.timer.stage("feedback"):
                        state = self._rebuild_frontend(state)
                    self._epoch += 1
            t += n_real

        # final solve: closures and soft jump edges accepted near the end
        if self.closures or self.weak_closures or self.jump_edges:
            with self.timer.stage("optimize"):
                self._optimize()

        if isinstance(state.mini_updated, torch.Tensor):
            # the step's device flag: the last scan's, read with its chunk
            state = state._replace(mini_updated=last_flag)
        self.final_state = graphs.clone_tree(state)
        self._last_path = np.stack(path)
        return self._last_path, np.stack(list(self.kf_poses))

    def smoothed_path(self, path: np.ndarray | None = None) -> np.ndarray:
        """Post-hoc graph-smoothed trajectory: every pose re-expressed
        relative to its nearest keyframe of the same frame epoch and
        composed onto that keyframe's optimized pose (feedback rewrites the
        frontend's frame, so raw keyframe anchors only compare with path
        entries of their own epoch)."""
        if path is None:
            path = self._last_path
        path = np.asarray(path)
        out = path.copy()
        if not self.kf_poses:
            return out
        kf_t = np.asarray(self.kf_times)
        kf_ep = np.asarray(self.kf_epoch)
        for t in range(len(path)):
            ep = self.path_epoch[t] if t < len(self.path_epoch) else kf_ep[-1]
            same = np.nonzero(kf_ep == ep)[0]
            if len(same) == 0:
                same = np.arange(len(kf_t))
            i = int(same[np.argmin(np.abs(kf_t[same] - t))])
            z = _np_between_ref(self.kf_raw[i], path[t])
            out[t] = _np_compose_ref(self.kf_poses[i], z)
        return out
